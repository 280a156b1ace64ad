"""The port's GNN path (gin-tu) against the JAX package's, on the CPU.

Graphs, features and labels come from numpy seeds and go to both packages;
weights are the reference's ``gin.init_params``, carried over with
``repro_torch.convert.gnn_params_from_reference``.  On the CPU the port's
``segment_matmul`` runs its plain version; the CUDA kernel is held against
that in ``tests/test_torch_cuda.py``.

Tolerances, stated before measuring:
- data pipelines (generators, batches, the sampler): array-equal;
- the GIN forward and loss in f32: logits within 1e-5 of each element
  plus 1e-5 of the largest |logit| (the port sums each layer's neighbours
  in slot order and multiplies by W1 apart from x; the reference adds
  them first, in XLA's order), the loss within 1e-5 relative;
- one ``gnn_train_step`` from one state: loss and grad norm within 1e-5
  relative; the new moments within 1e-3 of each element plus 1e-3 of the
  tensor's RMS; the new parameters within 2 lr of the reference's (one
  step moves an element by at most about lr per unit of m̂ / sqrt(v̂));
- edge-list batches with hubs (a star of in-degree 10^5, an RMAT graph),
  where the port sums a hub's first ``K_CAP`` in-edges in the table and
  the rest apart: logits within 1e-4 of the largest |logit|, and the
  gradients to x, each W1 and each eps within 1e-4 of the largest element
  of the reference's gradient of that tensor (five layers of sums in
  other orders, the hub's over 10^5 terms).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import graphs as jax_graphs
from repro.graph import generators as jax_gen
from repro.launch import steps as jax_steps
from repro.models.gnn import gin as jax_gin
from repro.optim import adamw as jax_adamw

from repro_torch.configs import registry
from repro_torch.configs.shapes import GNN_SHAPES, sampled_block_sizes
from repro_torch.convert import (adamw_state_from_reference,
                                 gnn_params_from_reference,
                                 gnn_params_to_reference, named_gnn_params)
from repro_torch.data import graphs
from repro_torch.graph import generators as gen
from repro_torch.kernels.segment_matmul import ops as seg_ops
from repro_torch.launch.steps import gnn_forward_step, gnn_train_step
from repro_torch.models.gnn import gin
from repro_torch.models.gnn.common import (GraphBatch, padded_neighbors,
                                           split_neighbors)
from repro_torch.optim import adamw

BATCH_FIELDS = ("senders", "receivers", "node_mask", "edge_mask",
                "graph_ids", "node_feat", "positions", "species", "labels")


def _np(a):
    return None if a is None else np.asarray(a)


def _assert_batches_equal(port: GraphBatch, ref):
    assert port.n_graphs == ref.n_graphs
    for name in BATCH_FIELDS:
        got, want = getattr(port, name), _np(getattr(ref, name))
        if want is None:
            assert got is None, name
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def _close_rel(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _moments_close(got, want, rtol=1e-3, floor=1e-3):
    """|got - want| <= rtol |want| + floor rms(want), per element."""
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    rms = float(np.sqrt(np.mean(want ** 2)))
    return float((np.abs(got - want) - rtol * np.abs(want) - floor * rms)
                 .max()) <= 0.0


# ------------------------------------------------------------ data pipelines
@pytest.mark.parametrize("n,seed", [(12, 0), (30, 3), (30, 1007)])
def test_random_geometric_equals_reference(n, seed):
    g, pos, sp = gen.random_geometric(n, 1.6, seed=seed)
    rg, rpos, rsp = jax_gen.random_geometric(n, 1.6, seed=seed)
    assert g.n == rg.n
    np.testing.assert_array_equal(g.edges, rg.edges)
    np.testing.assert_array_equal(pos, rpos)
    np.testing.assert_array_equal(sp, rsp)


@pytest.mark.parametrize("d_feat", [0, 16])
def test_molecules_equal_reference(d_feat):
    port = graphs.molecules(n_graphs=6, n_atoms=10, seed=2, d_feat=d_feat,
                            device="cpu")
    _assert_batches_equal(port, jax_graphs.molecules(
        n_graphs=6, n_atoms=10, seed=2, d_feat=d_feat))
    assert port.nbr is None


def test_cora_and_products_like_equal_reference():
    _assert_batches_equal(
        graphs.cora_like(200, 4.0, 40, 5, seed=1, device="cpu"),
        jax_graphs.cora_like(200, 4.0, 40, 5, seed=1))
    _assert_batches_equal(
        graphs.products_like(500, 6.0, 12, 7, seed=2, device="cpu"),
        jax_graphs.products_like(500, 6.0, 12, 7, seed=2))


@pytest.mark.parametrize("fanout", [(5, 3), (15, 10)])
@pytest.mark.parametrize("table", ["numpy", "tensor"])
def test_sample_block_equals_reference(fanout, table):
    g = gen.rmat(10, 10.0, seed=0)
    rg = jax_gen.rmat(10, 10.0, seed=0)
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((g.n, 8)).astype(np.float32)
    labels = rng.integers(0, 3, g.n).astype(np.int32)
    ours = graphs.NeighborSampler(g, fanout, seed=1, device="cpu")
    theirs = jax_graphs.NeighborSampler(rg, fanout, seed=1)
    for step in range(3):       # the samplers' generators stay in step
        seeds = rng.integers(0, g.n, 40)
        src = torch.from_numpy(feat) if table == "tensor" else feat
        block = ours.sample_block(seeds, src, labels)
        want = theirs.sample_block(seeds, feat, labels)
        _assert_batches_equal(block, want)
        n_nodes, n_edges = block.n_nodes, block.senders.shape[0]
        assert (n_nodes, n_edges) == (40 * (1 + fanout[0]
                                            + fanout[0] * fanout[1]),
                                      40 * (fanout[0] + fanout[0]
                                            * fanout[1]))
        # nbr: the edge list's in-neighbour table, fanout[0] valid slots on
        # the seed rows, fanout[1] on the first hop's, none on the last's
        assert block.nbr.dtype == torch.int32
        assert tuple(block.nbr.shape) == (n_nodes, max(fanout))
        np.testing.assert_array_equal(
            block.nbr.numpy(), padded_neighbors(
                block.senders, block.receivers, block.edge_mask,
                n_nodes).numpy())
        valid = (block.nbr >= 0).sum(1).numpy()
        hop1 = 40 * fanout[0]
        assert (valid[:40] == fanout[0]).all()
        assert (valid[40:40 + hop1] == fanout[1]).all()
        assert (valid[40 + hop1:] == 0).all()


def test_sampled_block_sizes_match_the_spec():
    spec = GNN_SHAPES["minibatch_lg"]
    assert sampled_block_sizes(spec) == (169984, 168960)


def test_padded_neighbors_equals_a_brute_force_table():
    rng = np.random.default_rng(5)
    n, e = 23, 90
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) < 0.8
    got = padded_neighbors(torch.from_numpy(s), torch.from_numpy(r),
                           torch.from_numpy(mask), n).numpy()
    rows = [[int(s[i]) for i in range(e) if mask[i] and r[i] == v]
            for v in range(n)]
    K = max(max(len(x) for x in rows), 1)
    want = np.full((n, K), -1, np.int32)
    for v, x in enumerate(rows):
        want[v, :len(x)] = x
    np.testing.assert_array_equal(got, want)
    empty = padded_neighbors(torch.zeros(3, dtype=torch.int32),
                             torch.zeros(3, dtype=torch.int32),
                             torch.zeros(3, dtype=torch.bool), 4)
    assert empty.shape == (4, 1) and bool((empty == -1).all())


def test_split_neighbors_caps_the_table_and_keeps_every_edge():
    """Under a cap, the table is the uncapped one's first columns and the
    overflow lists the rest of each row's senders, in order."""
    rng = np.random.default_rng(6)
    n, e = 17, 200
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, 4, e).astype(np.int32)   # four rows take every edge
    mask = rng.random(e) < 0.9
    args = (torch.from_numpy(s), torch.from_numpy(r), torch.from_numpy(mask),
            n)
    full = padded_neighbors(*args).numpy()
    nbr, over_s, over_r = split_neighbors(*args, cap=5)
    np.testing.assert_array_equal(nbr.numpy(), full[:, :5])
    for v in range(n):
        row = full[v][full[v] >= 0]
        np.testing.assert_array_equal(over_s.numpy()[over_r.numpy() == v],
                                      row[5:])
    assert bool((over_r[1:] >= over_r[:-1]).all())
    narrow, o_s, _ = split_neighbors(*args, cap=10 ** 6)
    np.testing.assert_array_equal(narrow.numpy(), full)
    assert o_s.numel() == 0


# ------------------------------------------------------------------- model
def _configs(d_feat, d_hidden):
    return (jax_gin.GINConfig(d_feat=d_feat, d_hidden=d_hidden,
                              dtype=jnp.float32),
            gin.GINConfig(d_feat=d_feat, d_hidden=d_hidden))


def _molecule_batches(d_feat):
    rng = np.random.default_rng(7)
    labels = rng.integers(0, 2, 8).astype(np.int32)
    ref = dataclasses.replace(
        jax_graphs.molecules(n_graphs=8, n_atoms=12, seed=0, d_feat=d_feat),
        labels=jnp.asarray(labels))
    port = dataclasses.replace(
        graphs.molecules(n_graphs=8, n_atoms=12, seed=0, d_feat=d_feat,
                         device="cpu"),
        labels=torch.from_numpy(labels))
    return ref, port


def _sampled_batches(d_feat, label=0):
    """One rmat(10) block, fanout (5, 3), 32 seeds, as one graph with one
    label (GIN classifies graphs).  The sum readout over the block's 672
    nodes gives logits of some 1e3 at initialization, which saturate the
    softmax: label 0 is the smaller logit under both parameter draws used
    here, so the loss and the step's gradient are not zero."""
    g = gen.rmat(10, 10.0, seed=0)
    rng = np.random.default_rng(3)
    feat = rng.standard_normal((g.n, d_feat)).astype(np.float32)
    seeds = rng.integers(0, g.n, 32)
    ref = jax_graphs.NeighborSampler(jax_gen.rmat(10, 10.0, seed=0), (5, 3),
                                     seed=1).sample_block(seeds, feat,
                                                          np.zeros(g.n))
    port = graphs.NeighborSampler(g, (5, 3), seed=1, device="cpu") \
        .sample_block(seeds, torch.from_numpy(feat), None)
    return (dataclasses.replace(ref, labels=jnp.asarray([label], jnp.int32)),
            dataclasses.replace(port, labels=torch.tensor([label])))


BATCHES = {"molecules_smoke": (16, lambda: _molecule_batches(64), 64),
           "sampled_d64": (64, lambda: _sampled_batches(32), 32)}


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_gin_forward_and_loss_match_jax(case):
    d_hidden, make, d_feat = BATCHES[case]
    jcfg, pcfg = _configs(d_feat, d_hidden)
    ref_batch, batch = make()
    params = jax_gin.init_params(jcfg, jax.random.PRNGKey(0))
    model = gin.GIN(pcfg, gnn_params_from_reference(
        pcfg, jax.tree.map(np.asarray, params)), device="cpu")
    before = seg_ops.segment_matmul.launches
    logits = gnn_forward_step(model, batch)
    assert seg_ops.segment_matmul.launches == before    # CPU: no kernel
    want = jax_gin.forward(jcfg, params, ref_batch)
    assert tuple(logits.shape) == (batch.n_graphs, 2)
    _close_rel(logits.numpy(), want)
    loss, metrics = model.loss_fn(batch)
    jloss, _ = jax_gin.loss_fn(jcfg, params, ref_batch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert metrics["nll"] is loss
    # the table built from the edge list and the sampler's are one input
    if batch.nbr is not None:
        bare = dataclasses.replace(batch, nbr=None)
        torch.testing.assert_close(gnn_forward_step(model, bare), logits,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_gnn_train_step_matches_jax(case):
    d_hidden, make, d_feat = BATCHES[case]
    jcfg, pcfg = _configs(d_feat, d_hidden)
    ref_batch, batch = make()
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=100)
    jopt = jax_adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=100)
    params = jax_gin.init_params(jcfg, jax.random.PRNGKey(1))
    jstate = jax_adamw.init_state(params)
    # one reference step first, so the port starts from nonzero moments
    params, jstate, _ = jax_steps.gnn_train_step("gin-tu", jcfg, jopt,
                                                 params, jstate, ref_batch)
    model = gin.GIN(pcfg, gnn_params_from_reference(
        pcfg, jax.tree.map(np.asarray, params)), device="cpu")
    state = adamw_state_from_reference(pcfg, jax.tree.map(np.asarray, jstate))
    jp, js, jm = jax_steps.gnn_train_step("gin-tu", jcfg, jopt, params,
                                          jstate, ref_batch)
    pm = gnn_train_step(model, opt_cfg, state, batch)
    for key in ("loss", "nll", "grad_norm", "lr"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    assert int(state["step"]) == int(js["step"]) == 2
    want = named_gnn_params(gnn_params_from_reference(
        pcfg, jax.tree.map(np.asarray, jp)))
    want_state = adamw_state_from_reference(pcfg,
                                            jax.tree.map(np.asarray, js))
    lr = float(jm["lr"])
    for name, p in model.named_parameters():
        assert float((p.detach() - want[name]).abs().max()) <= 2 * lr, name
        for mom in ("m", "v"):
            assert _moments_close(state[mom][name],
                                  want_state[mom][name].numpy()), (mom, name)
    assert all(p.grad is None for p in model.parameters())


def _edge_list_batches(case, d_feat):
    """The same edge-list batch for both packages, with three padding nodes
    and seven masked padding edges: a star whose centre has in-degree
    10^5, or rmat(11, 8) (largest in-degree 369, so both have rows
    past ``K_CAP``)."""
    if case == "star":
        jg, pg = jax_gen.star(100_001), gen.star(100_001)
    else:
        jg, pg = jax_gen.rmat(11, 8.0, seed=0), gen.rmat(11, 8.0, seed=0)
    feat = np.random.default_rng(8).standard_normal(
        (pg.n, d_feat)).astype(np.float32)
    pad = dict(pad_nodes=pg.n + 3, pad_edges=2 * pg.m + 7)
    return (jax_graphs._to_batch(jg, node_feat=feat, **pad),
            graphs._to_batch(pg, node_feat=feat, device="cpu", **pad))


@pytest.mark.parametrize("case", ["star", "rmat"])
def test_gin_on_edge_lists_with_hubs_matches_jax(case, monkeypatch):
    """An edge-list batch with rows of in-degree far past ``K_CAP`` goes
    through a table of ``K_CAP`` slots and the overflow's edge list, and
    its logits and gradients equal the reference's edge-list layer's."""
    d_feat = 8
    jcfg, pcfg = _configs(d_feat, 16)
    ref_batch, batch = _edge_list_batches(case, d_feat)
    counts = torch.bincount(batch.receivers[batch.edge_mask].long())
    assert int(counts.max()) > gin.K_CAP
    params = jax_gin.init_params(jcfg, jax.random.PRNGKey(2))
    model = gin.GIN(pcfg, gnn_params_from_reference(
        pcfg, jax.tree.map(np.asarray, params)), device="cpu")
    widths = []

    def recording(x, nbr, w):
        widths.append(tuple(nbr.shape))
        return seg_ops.segment_matmul(x, nbr, w)

    monkeypatch.setattr(gin, "segment_matmul", recording)
    feat = batch.node_feat.clone().requires_grad_(True)
    logits = model(dataclasses.replace(batch, node_feat=feat))
    # never a table as wide as the largest in-degree
    assert widths == [(batch.n_nodes, gin.K_CAP)] * pcfg.n_layers
    want = jax_gin.forward(jcfg, params, ref_batch)
    limit = 1e-4 * float(np.abs(np.asarray(want)).max())
    assert float(np.abs(logits.detach().numpy() - np.asarray(want)).max()) \
        <= limit

    cot = np.random.default_rng(9).standard_normal(
        tuple(logits.shape)).astype(np.float32)
    (logits * torch.from_numpy(cot)).sum().backward()

    def weighted(p, f):
        out = jax_gin.forward(jcfg, p, dataclasses.replace(ref_batch,
                                                           node_feat=f))
        return (out * cot).sum()

    gp, gf = jax.grad(weighted, argnums=(0, 1))(params, ref_batch.node_feat)
    pairs = [(feat.grad, gf)]
    for layer, jl in zip(model.layers, gp["layers"]):
        pairs += [(layer.mlp["l1"]["w"].grad, jl["mlp"]["l1"]["w"]),
                  (layer.eps.grad, jl["eps"])]
    for got, ref in pairs:
        ref = np.asarray(ref, np.float64)
        err = np.abs(got.double().numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (err, np.abs(ref).max())


def test_sampled_training_lowers_the_loss():
    """Sampled-minibatch GIN training, as the reference's
    ``test_integration_gnn.py`` trains GCN: two disjoint components whose
    features differ in mean, each block sampled from the seeds of one
    component and labelled with it; 12 steps on fresh blocks."""
    d_feat = 16
    g = gen.disjoint_components([300, 300], avg_deg=6.0, seed=0)
    rng = np.random.default_rng(0)
    comp = (np.arange(g.n) >= 300).astype(np.int64)
    shift = rng.standard_normal(d_feat).astype(np.float32)
    feat = (rng.standard_normal((g.n, d_feat)).astype(np.float32)
            + np.where(comp[:, None] == 1, shift, -shift))
    cfg = gin.GINConfig(n_layers=2, d_feat=d_feat, d_hidden=32)
    model = gin.GIN(cfg, device="cpu", seed=0)
    opt_cfg = adamw.AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=50,
                                weight_decay=0.0)
    state = adamw.init_state(model, opt_cfg)
    sampler = graphs.NeighborSampler(g, (8, 4), seed=1, device="cpu")
    table = torch.from_numpy(feat)
    losses = []
    for step in range(12):
        label = step % 2
        seeds = rng.integers(0, 300, 16) + 300 * label
        block = dataclasses.replace(sampler.sample_block(seeds, table, None),
                                    labels=torch.tensor([label]))
        losses.append(float(gnn_train_step(model, opt_cfg, state,
                                           block)["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


def test_params_round_trip_through_the_reference_layout():
    jcfg, pcfg = _configs(20, 16)
    params = jax.tree.map(np.asarray,
                          jax_gin.init_params(jcfg, jax.random.PRNGKey(4)))
    model = gin.GIN(pcfg, gnn_params_from_reference(pcfg, params),
                    device="cpu")
    assert sorted(dict(model.named_parameters())) == sorted(
        named_gnn_params(gnn_params_from_reference(pcfg, params)))
    back = gnn_params_to_reference(model)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="layers"):
        gnn_params_from_reference(dataclasses.replace(pcfg, n_layers=4),
                                  params)


def test_registry_resolves_gin_and_names_the_rest():
    entry = registry.get("gin-tu")
    assert entry.family == "gnn" and entry.config == gin.GINConfig()
    assert entry.smoke_config.d_hidden == 16
    assert "minibatch_lg" in entry.shapes
    for arch in ("gcn-cora", "schnet", "mace"):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
            registry.get(arch)
    assert registry.get("sasrec").family == "recsys"   # ported since


def test_gnn_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.get("gin-tu").smoke_config
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gin.GIN(cfg)
    g = gen.rmat(6, 4.0, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graphs.NeighborSampler(g, (2, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graphs.molecules(n_graphs=2, n_atoms=5)
    model = gin.GIN(cfg, device="cpu")
    assert model.device.type == "cpu"
    batch = graphs.molecules(n_graphs=2, n_atoms=5, d_feat=64, device="meta")
    with pytest.raises(ValueError, match="on meta"):
        model(batch)
