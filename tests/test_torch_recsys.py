"""The port's RecSys path (SASRec) against the JAX package's, on the CPU.

Batches come from ``batch_at_step`` in both packages (numpy, from a seed),
candidates and cotangents from numpy seeds; weights are the reference's
``sasrec.init_params``, carried over with
``repro_torch.convert.rec_params_from_reference``.  On the CPU every item
read goes through ``dht_gather``'s plain version; the CUDA kernel is held
against that in ``tests/test_torch_cuda.py``.

Tolerances, stated before measuring:
- the data stream and the registry's shapes: array-equal;
- the dedup gather: exact (a copy of rows); its gradient within 1e-6 of
  the largest element (a row read by several keys sums their gradients
  in f32, in another order than XLA's scatter-add);
- encode, candidate scores, retrieval scores and the BPR loss in f32:
  within 1e-5 of the largest |value| of each output (the two frameworks
  sum the same products and normalisations in other orders over two
  blocks), the loss within 1e-5 relative;
- gradients of the loss in f32: within 1e-4 of the largest element of the
  reference's gradient of each tensor (a backward through two blocks, the
  item table's rows summed over every position that reads them);
- one ``rec_train_step`` from one state: loss and grad norm within 1e-5
  relative; the new moments within 1e-3 of each element plus 1e-3 of the
  tensor's RMS; the new parameters within 2 lr of the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import shapes as jax_shapes
from repro.configs.registry import REGISTRY as JAX_REGISTRY
from repro.core import dht as jax_dht
from repro.data import recsys as jax_recsys
from repro.launch import steps as jax_steps
from repro.models import sasrec as jsr
from repro.optim import adamw as jax_adamw

from repro_torch.configs import registry
from repro_torch.configs.shapes import REC_SHAPES
from repro_torch.convert import (adamw_state_from_reference,
                                 named_rec_params, rec_params_from_reference,
                                 rec_params_to_reference)
from repro_torch.core.dht import dedup_gather
from repro_torch.data.recsys import RecStreamConfig, batch_at_step
from repro_torch.kernels.dht_gather import ops as dht_ops
from repro_torch.kernels.embedding_bag import ops as embag_ops
from repro_torch.launch.steps import (rec_retrieval_step, rec_serve_step,
                                      rec_train_step)
from repro_torch.models import sasrec
from repro_torch.optim import adamw

JCFG = JAX_REGISTRY["sasrec"].smoke_config


def _within(got, want, share):
    """max |got - want| <= share * max |want| (f64)."""
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= share * float(np.abs(want).max()), (err, share)


def _moments_close(got, want, rtol=1e-3, floor=1e-3):
    """|got - want| <= rtol |want| + floor rms(want), per element."""
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    rms = float(np.sqrt(np.mean(want ** 2)))
    return float((np.abs(got - want) - rtol * np.abs(want) - floor * rms)
                 .max()) <= 0.0


def _model(seed=0):
    """The smoke config's reference parameters from ``PRNGKey(seed)`` and a
    port model on the CPU that holds the same values."""
    cfg = registry.get("sasrec").smoke_config
    params = jsr.init_params(JCFG, jax.random.PRNGKey(seed))
    model = sasrec.SASRec(cfg, rec_params_from_reference(
        cfg, jax.tree.map(np.asarray, params)), device="cpu")
    return cfg, params, model


def _batch(batch=8, step=0, seed=0):
    return batch_at_step(RecStreamConfig(JCFG.n_items, JCFG.seq_len, batch,
                                         seed=seed), step)


# ------------------------------------------------------------ data, registry
@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (11, 250)])
def test_batch_at_step_equals_reference(seed, step):
    for n_items, S, B in ((2048, 50, 16), (1_000_000, 50, 64), (130, 7, 5)):
        got = batch_at_step(RecStreamConfig(n_items, S, B, seed), step)
        want = jax_recsys.batch_at_step(
            jax_recsys.RecStreamConfig(n_items, S, B, seed), step)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)


def test_registry_resolves_sasrec():
    entry = registry.get("sasrec")
    ref = JAX_REGISTRY["sasrec"]
    assert entry.family == ref.family == "recsys"
    for mine, theirs in ((entry.config, ref.config),
                         (entry.smoke_config, ref.smoke_config)):
        for f in ("n_items", "embed_dim", "n_blocks", "n_heads", "seq_len",
                  "dropout"):
            assert getattr(mine, f) == getattr(theirs, f), f
    assert entry.config.n_items == 1_000_000
    assert entry.smoke_config.n_items == 2048
    assert entry.shapes is REC_SHAPES
    assert {k: dataclasses.asdict(v) for k, v in REC_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jax_shapes.REC_SHAPES.items()}


def test_rec_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.get("sasrec").smoke_config
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sasrec.SASRec(cfg)
    model = sasrec.SASRec(cfg, device="cpu")
    assert model.device.type == "cpu"
    assert model.item_embed.shape == (2048, 50)


def test_params_round_trip_through_the_reference_layout():
    cfg, params, model = _model(4)
    params = jax.tree.map(np.asarray, params)
    assert sorted(dict(model.named_parameters())) == sorted(
        named_rec_params(rec_params_from_reference(cfg, params)))
    back = rec_params_to_reference(model)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="blocks"):
        rec_params_from_reference(dataclasses.replace(cfg, n_blocks=3),
                                  params)


# -------------------------------------------------------------- dedup gather
def test_dedup_gather_and_its_gradient_match_the_reference_lookup():
    """Rows as the reference's ``lookup(dedup=True)`` reads them (negative
    keys row 0, keys past the end row V - 1), the gradient as
    ``jax.grad`` of it."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((40, 6)).astype(np.float32)
    keys = rng.integers(-4, 46, (7, 9)).astype(np.int32)
    cot = rng.standard_normal((7, 9, 6)).astype(np.float32)
    t = torch.from_numpy(table).requires_grad_(True)
    before = dht_ops.dht_gather.launches
    got = dedup_gather(t, torch.from_numpy(keys))
    assert dht_ops.dht_gather.launches == before      # CPU: no kernel
    want, _ = jax_dht.lookup(jnp.asarray(table), jnp.asarray(keys.ravel()))
    np.testing.assert_array_equal(got.detach().numpy().reshape(-1, 6),
                                  np.asarray(want))
    (got * torch.from_numpy(cot)).sum().backward()
    gref = jax.grad(lambda v: (jax_dht.lookup(v, jnp.asarray(keys.ravel()))[0]
                               * cot.reshape(-1, 6)).sum())(
        jnp.asarray(table))
    _within(t.grad, gref, 1e-6)
    with pytest.raises(ValueError, match="without rows"):
        dedup_gather(torch.zeros(0, 6), torch.zeros(3, dtype=torch.int32))


# --------------------------------------------------------------------- model
def test_encode_and_scores_match_jax():
    cfg, params, model = _model()
    seq, _, _ = _batch(8)
    cands = np.random.default_rng(0).integers(1, cfg.n_items,
                                              (8, 64)).astype(np.int32)
    counts = (dht_ops.dht_gather.launches, embag_ops.embedding_bag.launches)
    states = model.encode(seq)
    want = jsr.encode(JCFG, params, jnp.asarray(seq))
    assert tuple(states.shape) == (8, cfg.seq_len, cfg.embed_dim)
    _within(states, want, 1e-5)
    assert bool((states[torch.from_numpy(seq) == 0] == 0).all())
    scores = rec_serve_step(model, seq, cands)
    jscores = jax_steps.rec_serve_step(JCFG, params, jnp.asarray(seq),
                                       jnp.asarray(cands))
    assert tuple(scores.shape) == (8, 64)
    _within(scores, jscores, 1e-5)
    ret = rec_retrieval_step(model, seq[:2])
    jret = jax_steps.rec_retrieval_step(JCFG, params, jnp.asarray(seq[:2]))
    assert tuple(ret.shape) == (2, cfg.n_items)
    _within(ret, jret, 1e-5)
    # the candidates' scores are the retrieval scores at those items
    _within(rec_retrieval_step(model, seq).gather(
        1, torch.from_numpy(cands).long()), jscores, 1e-5)
    assert (dht_ops.dht_gather.launches,
            embag_ops.embedding_bag.launches) == counts


def test_loss_and_gradients_match_jax():
    cfg, params, model = _model(1)
    seq, pos, neg = _batch(8, step=3)
    loss, metrics = model.loss_fn(seq, pos, neg)
    jloss, _ = jsr.loss_fn(JCFG, params, jnp.asarray(seq), jnp.asarray(pos),
                           jnp.asarray(neg))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert metrics["bpr"] is loss
    loss.backward()
    grads = jax.grad(lambda p: jsr.loss_fn(
        JCFG, p, jnp.asarray(seq), jnp.asarray(pos),
        jnp.asarray(neg))[0])(params)
    want = named_rec_params(rec_params_from_reference(
        cfg, jax.tree.map(np.asarray, grads)))
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        _within(p.grad, want[name].numpy(), 1e-4)


def test_rec_train_step_matches_jax():
    cfg, params, model = _model(2)
    seq, pos, neg = _batch(16, step=1)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=100)
    jopt = jax_adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=100)
    jstate = jax_adamw.init_state(params)
    args = (jnp.asarray(seq), jnp.asarray(pos), jnp.asarray(neg))
    # one reference step first, so the port starts from nonzero moments
    params, jstate, _ = jax_steps.rec_train_step(JCFG, jopt, params, jstate,
                                                 *args)
    model = sasrec.SASRec(cfg, rec_params_from_reference(
        cfg, jax.tree.map(np.asarray, params)), device="cpu")
    state = adamw_state_from_reference(cfg, jax.tree.map(np.asarray, jstate))
    jp, js, jm = jax_steps.rec_train_step(JCFG, jopt, params, jstate, *args)
    pm = rec_train_step(model, opt_cfg, state, seq, pos, neg)
    for key in ("loss", "bpr", "grad_norm", "lr"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    assert int(state["step"]) == int(js["step"]) == 2
    want = named_rec_params(rec_params_from_reference(
        cfg, jax.tree.map(np.asarray, jp)))
    want_state = adamw_state_from_reference(cfg,
                                            jax.tree.map(np.asarray, js))
    lr = float(jm["lr"])
    for name, p in model.named_parameters():
        assert float((p.detach() - want[name]).abs().max()) <= 2 * lr, name
        for mom in ("m", "v"):
            assert _moments_close(state[mom][name],
                                  want_state[mom][name].numpy()), (mom, name)
    assert all(p.grad is None for p in model.parameters())


def test_bpr_loss_decreases():
    """As ``tests/test_sasrec.py`` trains the reference: plain gradient
    steps of 0.05 on batches of 16, alternating two stream steps."""
    cfg = registry.get("sasrec").smoke_config
    model = sasrec.SASRec(cfg, device="cpu", seed=0)
    losses = []
    for it in range(8):
        seq, pos, neg = _batch(16, step=it % 2)
        loss, _ = model.loss_fn(seq, pos, neg)
        model.zero_grad(set_to_none=True)
        loss.backward()
        with torch.no_grad():
            for p in model.parameters():
                p -= 0.05 * p.grad
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
