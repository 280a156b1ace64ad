"""The port's GCN, SchNet and MACE against the JAX package's, on the CPU.

Graphs, features, positions, species and labels come from numpy seeds and
go to both packages as the same arrays; weights are the reference's
``init_params``, carried over with ``repro_torch.convert``.  The JAX side
is jitted.  The configs are the registry's smoke configs (f32; GCN's
input width set to the batch's).

Tolerances, stated before measuring:
- GCN's logits and every gradient in f32: within 1e-5 of the largest
  |element| of the reference's tensor (the two packages sum the same terms
  in other orders, and XLA's and ATen's exp, log1p and the like differ in
  the last bit of a fifth of their results); GCN's loss within 1e-5
  relative;
- SchNet's and MACE's energies: graph g's within 1e-5 S_g, S_g the sum of
  |atom energy| over its atoms (the energy is that sum with signs, and an
  atom's last-bit difference can repeat over every atom: on the 204-atom
  sampled block S is 9 where e is 0.3); the MSE of energies e against
  targets t, and its grad norm, within what those energy errors give:
  mean(2 |e - t| d + d^2) plus 1e-5 relative, and 1e-5 + max d / |e - t|
  relative, d = 1e-5 S; the moments after three steps within the largest
  of those relative bounds (m; twice it for v, a square);
- three ``gnn_train_step``s: each step's loss as above and its grad norm
  within 1e-5 relative of the reference's step from the same state; after
  the third, every parameter within 1e-5 of the reference's own three
  steps (absolute: a step moves an element by about lr = 1e-3, and m̂ /
  sqrt(v̂) turns a gradient element's small relative error into a move of
  up to a few thousandths of that) and every moment within 1e-5 of the
  largest |element| of the reference's tensor; MACE's never-read
  ``mix_v`` and ``mix_t`` included: both packages give them a zero
  gradient and decay them;
- the reference's property tests, run on the port: SchNet's and MACE's
  energies invariant under rotation plus translation (SchNet 1e-4, MACE
  2e-4, relative and absolute, the reference's bounds), MACE's forces
  rotation-equivariant (5e-3 relative, 5e-4 absolute), its order-3
  B-features active, and sampled GCN training lowering the loss.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.launch import steps as jax_steps
from repro.models.gnn import common as jax_common
from repro.models.gnn import gcn as jax_gcn
from repro.models.gnn import mace as jax_mace
from repro.models.gnn import schnet as jax_schnet
from repro.optim import adamw as jax_adamw

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.data import graphs
from repro_torch.graph import generators as gen
from repro_torch.launch.steps import (GNN_MODELS, GNN_MODULES,
                                      gnn_forward_step, gnn_train_step)
from repro_torch.models.gnn import gcn, mace, schnet
from repro_torch.optim import adamw

ARCHS = ("gcn-cora", "schnet", "mace")
JAX_MODULES = {"gcn-cora": jax_gcn, "schnet": jax_schnet, "mace": jax_mace}
CONVERT = {"gcn-cora": (convert.gcn_params_from_reference,
                        convert.named_gcn_params,
                        convert.gcn_params_to_reference),
           "schnet": (convert.schnet_params_from_reference,
                      convert.named_schnet_params,
                      convert.schnet_params_to_reference),
           "mace": (convert.mace_params_from_reference,
                    convert.named_mace_params,
                    convert.mace_params_to_reference)}
BATCH_FIELDS = ("senders", "receivers", "node_mask", "edge_mask",
                "graph_ids", "node_feat", "positions", "species", "labels")
RTOL = 1e-5


def _configs(arch, d_feat):
    jcfg = jax_registry.get(arch).smoke_config
    pcfg = registry.get(arch).smoke_config
    if arch == "gcn-cora":
        jcfg = dataclasses.replace(jcfg, d_feat=d_feat)
        pcfg = dataclasses.replace(pcfg, d_feat=d_feat)
    return jcfg, pcfg


def _sampled(d_feat):
    g = gen.rmat(9, 8.0, seed=0)
    rng = np.random.default_rng(4)
    feat = rng.standard_normal((g.n, d_feat)).astype(np.float32)
    sampler = graphs.NeighborSampler(g, (4, 3), seed=1, device="cpu")
    return sampler.sample_block(rng.integers(0, g.n, 12),
                                torch.from_numpy(feat), None)


# the batches: (builder of a port batch, feature width)
BATCHES = {
    "molecules": (lambda: graphs.molecules(n_graphs=6, n_atoms=10, seed=2,
                                           d_feat=16, device="cpu"), 16),
    "cora": (lambda: graphs.cora_like(120, 4.0, 24, 7, seed=1,
                                      device="cpu"), 24),
    "products": (lambda: graphs.products_like(200, 6.0, 12, 47, seed=2,
                                              device="cpu"), 12),
    "sampled": (lambda: _sampled(16), 16),
}


def _batches(arch, case, cfg):
    """(the reference's GraphBatch, the port's) of one case for one arch:
    GCN gets (N,) node labels below its n_classes; SchNet and MACE get
    positions (N, 3) and species below n_species where the builder has
    none (a standard normal times 1.5, which puts neighbours inside both
    cutoffs) and (n_graphs,) energies."""
    make, _ = BATCHES[case]
    batch = make()
    rng = np.random.default_rng(11)
    n = batch.n_nodes
    if arch == "gcn-cora":
        batch = dataclasses.replace(batch, labels=torch.from_numpy(
            rng.integers(0, cfg.n_classes, n).astype(np.int32)))
    elif batch.positions is None:
        batch = dataclasses.replace(
            batch,
            positions=torch.from_numpy(
                (1.5 * rng.standard_normal((n, 3))).astype(np.float32)),
            species=torch.from_numpy(
                rng.integers(0, cfg.n_species, n).astype(np.int32)),
            labels=torch.from_numpy(rng.standard_normal(
                batch.n_graphs).astype(np.float32)))
    ref = jax_common.GraphBatch(
        n_graphs=batch.n_graphs,
        **{f: None if getattr(batch, f) is None
           else jnp.asarray(getattr(batch, f).numpy()) for f in BATCH_FIELDS})
    return ref, batch


def _reference_params(arch, jcfg, seed):
    return JAX_MODULES[arch].init_params(jcfg, jax.random.PRNGKey(seed))


def _port_model(arch, pcfg, params):
    from_ref = CONVERT[arch][0]
    return GNN_MODELS[arch](pcfg, from_ref(
        pcfg, jax.tree.map(np.asarray, params)), device="cpu")


def _assert_close(got, want, what, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rtol * scale or err == 0.0, (what, err, scale)


def _energy_budget(arch, model, batch):
    """d_g = 1e-5 S_g for an energy model (S_g: graph g's sum of |atom
    energy|, the port's atom energies read before the readout), None for
    GCN."""
    if arch == "gcn-cora":
        return None
    module = GNN_MODULES[arch]
    readout = module.graph_readout
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "graph_readout", lambda vals, *args, **kw: vals)
        atoms = gnn_forward_step(model, batch).double().abs()
    S = readout(atoms, batch.graph_ids, batch.n_graphs, batch.node_mask)
    return RTOL * S.numpy()


def _assert_metrics_close(got, want, budget, out, labels):
    """The loss and grad norm of one step (see the module docstring)."""
    loss, gnorm = float(got["loss"]), float(got["grad_norm"])
    jloss, jnorm = float(want["loss"]), float(want["grad_norm"])
    if budget is None:
        np.testing.assert_allclose([loss, gnorm], [jloss, jnorm], rtol=RTOL)
        return RTOL
    gap = np.abs(np.asarray(out, np.float64) - np.asarray(labels))
    loss_limit = RTOL * abs(jloss) + float(np.mean(2 * gap * budget
                                                   + budget ** 2))
    assert abs(loss - jloss) <= loss_limit, (loss, jloss, loss_limit)
    norm_rtol = RTOL + float(np.max(budget / np.maximum(gap, 1e-30)))
    np.testing.assert_allclose(gnorm, jnorm, rtol=norm_rtol)
    return norm_rtol


@functools.lru_cache(maxsize=None)
def _jitted(arch, jcfg):
    mod = JAX_MODULES[arch]
    return (jax.jit(functools.partial(mod.forward, jcfg)),
            jax.jit(jax.value_and_grad(
                lambda p, b: mod.loss_fn(jcfg, p, b)[0])))


@pytest.mark.parametrize("case", sorted(BATCHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradients_match_jax(arch, case):
    jcfg, pcfg = _configs(arch, BATCHES[case][1])
    ref_batch, batch = _batches(arch, case, pcfg)
    params = _reference_params(arch, jcfg, 0)
    model = _port_model(arch, pcfg, params)
    fwd, value_and_grad = _jitted(arch, jcfg)
    out = gnn_forward_step(model, batch)
    want = fwd(params, ref_batch)
    budget = _energy_budget(arch, model, batch)
    if budget is None:
        _assert_close(out.numpy(), want, "forward")
    else:
        err = np.abs(out.numpy() - np.asarray(want, np.float64))
        assert (err <= budget).all(), (err, budget)
    assert bool(torch.isfinite(out).all())
    loss, metrics = model.loss_fn(batch)
    jloss, jgrads = value_and_grad(params, ref_batch)
    if budget is None:
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=RTOL)
    else:
        gap = np.abs(np.asarray(want, np.float64) - batch.labels.numpy())
        limit = RTOL * abs(float(jloss)) + float(np.mean(2 * gap * budget
                                                         + budget ** 2))
        assert abs(float(loss.detach()) - float(jloss)) <= limit
    assert metrics[next(iter(metrics))] is loss
    loss.backward()
    want_grads = CONVERT[arch][1](CONVERT[arch][0](
        pcfg, jax.tree.map(np.asarray, jgrads)))
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want_grads)
    for name, p in named.items():
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        _assert_close(grad.numpy(), want_grads[name].numpy(), name)
    if arch == "mace":   # never read by the forward: no autograd gradient
        assert named["layers.0.mix_v.w"].grad is None
        assert not np.asarray(jgrads["layers"][0]["mix_t"]["w"]).any()


def _dotted(path):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _state_to_reference(params, state):
    """The port's AdamW state in the reference's layout (moments as trees
    like ``params``)."""
    def tree(moments):
        return jax.tree_util.tree_map_with_path(
            lambda path, _: moments[_dotted(path)].numpy(), params)
    return {"m": tree(state["m"]), "v": tree(state["v"]),
            "step": state["step"].numpy()}


@pytest.mark.parametrize("case", ["molecules", "sampled"])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch, case):
    """Each port step against the reference's step from the same state
    (the port's, carried over), then the port's three steps against the
    reference's own three."""
    jcfg, pcfg = _configs(arch, BATCHES[case][1])
    ref_batch, batch = _batches(arch, case, pcfg)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jopt = jax_adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = _reference_params(arch, jcfg, 1)
    jstate = jax_adamw.init_state(params)
    model = _port_model(arch, pcfg, params)
    state = adamw.init_state(model)
    from_ref, named, to_ref = CONVERT[arch]
    step = jax.jit(functools.partial(jax_steps.gnn_train_step, arch, jcfg,
                                     jopt))
    fwd = _jitted(arch, jcfg)[0]
    grad_rtol = RTOL
    for i in range(3):
        here = to_ref(model)
        _, _, jm = step(here, _state_to_reference(here, state), ref_batch)
        budget = _energy_budget(arch, model, batch)
        out = fwd(here, ref_batch)
        pm = gnn_train_step(model, opt_cfg, state, batch)
        grad_rtol = max(grad_rtol, _assert_metrics_close(
            pm, jm, budget, out, ref_batch.labels))
        np.testing.assert_allclose(float(pm["lr"]), float(jm["lr"]),
                                   rtol=RTOL)
        params, jstate, _ = step(params, jstate, ref_batch)
    assert int(state["step"]) == int(jstate["step"]) == 3
    want = named(from_ref(pcfg, jax.tree.map(np.asarray, params)))
    want_state = convert.adamw_state_from_reference(
        pcfg, jax.tree.map(np.asarray, jstate))
    for name, p in model.named_parameters():
        # a step moves an element by about lr = 1e-3: 1e-5 is 1% of that
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=RTOL, err_msg=name)
        # m carries the gradients' relative error, v twice it
        for mom, rtol in (("m", grad_rtol), ("v", 2 * grad_rtol)):
            _assert_close(state[mom][name].numpy(),
                          want_state[mom][name].numpy(), (mom, name),
                          rtol=rtol)
    assert all(p.grad is None for p in model.parameters())
    if arch == "mace":
        # zero gradients, yet weight decay moved them, as in the reference
        first = from_ref(pcfg, jax.tree.map(
            np.asarray, _reference_params(arch, jcfg, 1)))
        for key in ("mix_v", "mix_t"):
            w = model["layers"][0][key]["w"].detach()
            assert not torch.equal(w, first["layers"][0][key]["w"])
            assert float(state["m"][f"layers.0.{key}.w"].abs().max()) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_and_init_scales(arch):
    jcfg, pcfg = _configs(arch, 16)
    params = jax.tree.map(np.asarray, _reference_params(arch, jcfg, 3))
    from_ref, named, to_ref = CONVERT[arch]
    model = _port_model(arch, pcfg, params)
    assert sorted(dict(model.named_parameters())) == sorted(
        named(from_ref(pcfg, params)))
    back = to_ref(model)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    # the port's own draw: the reference's shapes, and scales within 15%
    drawn = GNN_MODULES[arch].init_params(pcfg,
                                          torch.Generator().manual_seed(0))
    flat_d = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), drawn))[0]
    flat_r = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in flat_d] == [p for p, _ in flat_r]
    for (path, d), (_, r) in zip(flat_d, flat_r):
        assert d.shape == r.shape and d.dtype == r.dtype, path
        assert (r.std() == 0) == (d.std() == 0), path
        if r.std() and r.size >= 256:   # a smaller draw's std is noise
            assert abs(d.std() / r.std() - 1) < 0.15, path
    depth_key = "interactions" if arch == "schnet" else "layers"
    short = {**params, depth_key: params[depth_key][:-1]}
    with pytest.raises(ValueError, match=depth_key):
        from_ref(pcfg, short)
    with pytest.raises(ValueError, match=depth_key):
        GNN_MODELS[arch](pcfg, from_ref(pcfg, params) | {
            depth_key: from_ref(pcfg, params)[depth_key][:-1]},
            device="cpu")


# ------------------------------------------------- the reference's properties
def _rotation(seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.astype(np.float32)


def _moved(batch, R, shift):
    return dataclasses.replace(batch, positions=torch.from_numpy(
        batch.positions.numpy() @ R.T + shift))


def test_schnet_energies_are_invariant():
    cfg = registry.get("schnet").smoke_config
    batch = graphs.molecules(n_graphs=4, n_atoms=10, seed=2, device="cpu")
    model = schnet.SchNet(cfg, device="cpu", seed=0)
    e1 = gnn_forward_step(model, batch).numpy()
    assert e1.shape == (4,) and np.isfinite(e1).all()
    e2 = gnn_forward_step(model, _moved(batch, _rotation(3), 5.0)).numpy()
    np.testing.assert_allclose(e1, e2, rtol=1e-4, atol=1e-4)


def test_mace_is_invariant_and_its_forces_equivariant():
    cfg = registry.get("mace").smoke_config
    batch = graphs.molecules(n_graphs=4, n_atoms=10, seed=4, device="cpu")
    model = mace.MACE(cfg, device="cpu", seed=0)
    e1 = gnn_forward_step(model, batch).numpy()
    assert e1.shape == (4,) and np.isfinite(e1).all()
    for seed in range(3):
        e2 = gnn_forward_step(model, _moved(batch, _rotation(seed),
                                            -2.0)).numpy()
        np.testing.assert_allclose(e1, e2, rtol=2e-4, atol=2e-4)

    def forces(pos):
        pos = pos.clone().requires_grad_(True)
        model(dataclasses.replace(batch, positions=pos)).sum().backward()
        return pos.grad.numpy()

    R = _rotation(7)
    f1 = forces(batch.positions)
    f2 = forces(torch.from_numpy(batch.positions.numpy() @ R.T))
    np.testing.assert_allclose(f2, f1 @ R.T, rtol=5e-3, atol=5e-4)


def test_mace_correlation_order_is_active():
    """Order-3 B-features change the output (correlation > 2 is active)."""
    cfg = registry.get("mace").smoke_config
    batch = graphs.molecules(n_graphs=2, n_atoms=8, seed=5, device="cpu")
    model = mace.MACE(cfg, device="cpu", seed=1)
    e1 = gnn_forward_step(model, batch).numpy()
    with torch.no_grad():
        for layer in model["layers"]:
            layer["w_b"][3:] = 0.0     # kill the order-3 terms
    e2 = gnn_forward_step(model, batch).numpy()
    assert np.abs(e1 - e2).max() > 1e-7


def test_sampled_gcn_training_lowers_the_loss():
    """The reference's ``test_integration_gnn.py`` on the port: learnable
    labels (the argmax of a fixed projection), 12 steps on fresh (8, 4)
    blocks of 64 seeds."""
    g = gen.rmat(10, 10.0, seed=0)
    rng = np.random.default_rng(0)
    d_feat, n_classes = 32, 5
    proj = rng.standard_normal((d_feat, n_classes)).astype(np.float32)
    feat = rng.standard_normal((g.n, d_feat)).astype(np.float32)
    labels = (feat @ proj).argmax(-1).astype(np.int32)
    cfg = gcn.GCNConfig(n_layers=2, d_feat=d_feat, d_hidden=32,
                        n_classes=n_classes)
    model = gcn.GCN(cfg, device="cpu", seed=0)
    opt_cfg = adamw.AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=50,
                                weight_decay=0.0)
    state = adamw.init_state(model, opt_cfg)
    sampler = graphs.NeighborSampler(g, (8, 4), seed=1, device="cpu")
    losses = []
    for _ in range(12):
        block = sampler.sample_block(rng.integers(0, g.n, 64), feat, labels)
        losses.append(float(gnn_train_step(model, opt_cfg, state,
                                           block)["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


def test_models_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ARCHS:
        cfg = registry.get(arch).smoke_config
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GNN_MODELS[arch](cfg)
        model = GNN_MODELS[arch](cfg, device="cpu")
        assert model.device.type == "cpu"
        batch = graphs.molecules(n_graphs=2, n_atoms=5, d_feat=cfg.d_feat
                                 if arch == "gcn-cora" else 0,
                                 device="meta")
        with pytest.raises(ValueError, match="on meta"):
            model(batch)
