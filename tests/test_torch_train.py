"""The port's LM training path against the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages; a
training step starts both from one state, the reference's ``init_params``
and ``adamw.init_state`` carried over with ``repro_torch.convert``.  On the
CPU the port's ``FlashAttention`` runs its plain forward and backward
(``ref.attention_fwd_lse_ref``, ``ref.attention_bwd_ref``); the CUDA
kernels are held against those in ``tests/test_torch_cuda.py``.

Tolerances, stated before measuring:
- attention gradients in f32: 2e-5 (rtol and atol; the two frameworks sum
  the same products in other orders);
- AdamW on the same inputs: f32 leaves within 1e-6 relative (plus 1e-9
  absolute: XLA's and torch's f32 ``pow`` and division may differ in the
  last bit); bf16 moments within one bf16 ulp of their own (2^-7
  relative);
- a training step in f32: loss and grad norm within 1e-5 relative; the new
  moments within 1e-3 of each element plus 1e-3 of the tensor's RMS (the
  gradients carry the forward's and backward's f32 rounding, largest
  relative to elements near zero); the new parameters within 2 lr (one
  step moves an element by at most about lr per unit of m̂ / sqrt(v̂), and
  near-zero gradients may flip its sign);
- in bf16 compute: loss and grad norm within ``BF16_TOL`` of
  ``tests/test_torch_lm.py`` (2e-2), parameters within 2 lr.
"""
import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm_archs as jax_archs
from repro.kernels.flash_attention.bwd import (_fwd_with_lse,
                                               flash_attention_trainable)
from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro.launch import steps as jax_steps
from repro.models import transformer as jtr
from repro.optim import adamw as jax_adamw

from repro_torch.checkpoint import checkpointer
from repro_torch.configs import lm_archs
from repro_torch.convert import (adamw_state_from_reference,
                                 lm_params_from_reference,
                                 lm_params_to_reference, named_lm_params)
from repro_torch.data.tokens import TokenStreamConfig, batch_at_step
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_lse_ref,
                                                     grad_limit)
from repro_torch.launch.steps import lm_train_step
from repro_torch.launch.train import train_lm
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim import adamw

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return x.detach().float().numpy()


# ---------------------------------------------------------------- backward
BWD_CASES = [
    # the four cases of tests/test_kernels_bwd.py
    (1, 128, 128, 2, 2, 32, True, 0),
    (2, 128, 128, 4, 2, 32, True, 0),     # GQA
    (1, 128, 128, 2, 2, 32, True, 64),    # windowed
    (1, 128, 128, 2, 1, 64, False, 0),    # bidirectional, MQA
    (1, 64, 192, 4, 2, 32, True, 80),     # K > S (q_offset 128), window
    (1, 128, 128, 4, 2, 256, True, 0),    # D 256
]


def _qkv_do(shape, seed=0):
    B, S, K, H, Hkv, D = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, K, Hkv, D), (B, K, Hkv, D),
                      (B, S, H, D))]


@pytest.mark.parametrize("B,S,K,H,Hkv,D,causal,window", BWD_CASES)
def test_plain_backward_matches_jax(B, S, K, H, Hkv, D, causal, window):
    """``attention_bwd_ref`` and the CPU ``FlashAttention`` Function against
    the JAX ``flash_attention_trainable`` VJP (its Pallas backward kernels
    in interpret mode) and ``jax.grad`` of the JAX ``attention_ref``."""
    q, k, v, do = _qkv_do((B, S, K, H, Hkv, D))
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))

    def vjp(fn):
        _, pull = jax.vjp(fn, jq, jk, jv)
        return [_np(g) for g in pull(jdo)]

    want_kernel = vjp(lambda a, b, c: flash_attention_trainable(
        a, b, c, causal, window, 64, 64, True))
    want_grad = vjp(lambda a, b, c: jax_attention(a, b, c, causal=causal,
                                                  window=window))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = attention_fwd_lse_ref(tq, tk, tv, causal, window)
    plain = attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal, window)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = flash_ops.flash_attention(*leaves, causal=causal, window=window)
    function = torch.autograd.grad(out, leaves, tdo)
    for got in (plain, function):
        for name, g, wk, wg in zip("qkv", got, want_kernel, want_grad):
            np.testing.assert_allclose(_t(g), wk, **F32_TOL,
                                       err_msg=f"d{name} vs the JAX VJP")
            np.testing.assert_allclose(_t(g), wg, **F32_TOL,
                                       err_msg=f"d{name} vs jax.grad")
    np.testing.assert_allclose(_t(out), _t(o), rtol=0, atol=0)


@pytest.mark.parametrize("B,S,K,H,Hkv,D,causal,window", BWD_CASES)
def test_plain_forward_lse_matches_jax(B, S, K, H, Hkv, D, causal, window):
    q, k, v, _ = _qkv_do((B, S, K, H, Hkv, D), seed=1)
    want_o, want_lse = _fwd_with_lse(*map(jnp.asarray, (q, k, v)), causal,
                                     window, 64, 64, True)
    o, lse = attention_fwd_lse_ref(*map(torch.from_numpy, (q, k, v)),
                                   causal, window)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    np.testing.assert_allclose(_t(lse), _np(want_lse).reshape(B, H, S),
                               **F32_TOL)
    np.testing.assert_allclose(_t(o), _np(want_o), **F32_TOL)


def _bwd_dropping(q, k, v, o, lse, do, drop_keys, drop_queries):
    """The plain backward of a kernel that skips work: dq without the
    keys in ``drop_keys`` (a dq kernel dropping one kv tile), dk and dv
    without the query rows in ``drop_queries`` (a dk/dv kernel dropping
    one query tile).  Causal, no window."""
    B, S, H, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = D ** -0.5
    qf = q.float().reshape(B, S, Hkv, G, D)
    dof = do.float().reshape(B, S, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    keep = torch.ones(S, K, dtype=torch.bool).tril(K - S)
    s = torch.where(keep, s, -1e30)
    p = torch.exp(s - lse.reshape(B, Hkv, G, S)[..., None])
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    delta = (do.float() * o.float()).sum(-1).reshape(B, S, Hkv, G)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) * scale
    ds_q, ds_kv, p_kv = ds.clone(), ds.clone(), p.clone()
    ds_q[..., drop_keys] = 0
    ds_kv[..., drop_queries, :] = 0
    p_kv[..., drop_queries, :] = 0
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds_q, k.float())
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds_kv, qf)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p_kv, dof)
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_limit_fails_a_backward_that_drops_a_tile(dtype):
    """``grad_limit``, the per-element limit by which the card holds the
    backward kernels against ``attention_bwd_ref``, passes the plain
    backward computed in float64 (another summation order and precision)
    and fails one that drops the last kv tile from dq, or the last query
    tile from dk and dv."""
    B, S, H, Hkv, D, T = 1, 512, 4, 2, 64, 64
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _qkv_do((B, S, S, H, Hkv, D), seed=2))
    o, lse = attention_fwd_lse_ref(q, k, v, True, 0)
    want = attention_bwd_ref(q, k, v, o, lse, do, True, 0)
    sums = (S, 2 * S, 2 * S)    # dq: K keys; dk, dv: G * S query rows

    def worst(got):
        return [float(((g.float() - w.float()).abs()
                       / grad_limit(w, n)).max())
                for g, w, n in zip(got, want, sums)]

    as64 = attention_bwd_ref(q.double(), k.double(), v.double(), o.double(),
                             lse.double(), do.double(), True, 0)
    assert max(worst([g.to(dtype) for g in as64])) <= 1.0
    dropped = _bwd_dropping(q, k, v, o, lse, do, slice(S - T, S),
                            slice(S - T, S))
    assert min(worst(dropped)) > 1.0, worst(dropped)
    first = _bwd_dropping(q, k, v, o, lse, do, slice(0, T), slice(0, T))
    assert min(worst(first)) > 1.0, worst(first)


# ------------------------------------------------------------------- AdamW
def _tree(rng, scale):
    return {"w": (rng.standard_normal((7, 5)) * scale).astype(np.float32),
            "b": (rng.standard_normal((5,)) * scale).astype(np.float32),
            "emb": (rng.standard_normal((3, 4, 6)) * scale).astype(
                np.float32)}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [3, 57])       # in warmup, in the decay
@pytest.mark.parametrize("grad_scale", [1e-2, 10.0])   # clip idle, engaged
def test_adamw_matches_jax(state_dtype, step, grad_scale):
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=10, total_steps=100,
                            state_dtype=state_dtype)
    jcfg = jax_adamw.AdamWConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(step)
    params, grads = _tree(rng, 1.0), _tree(rng, grad_scale)
    m, v = _tree(rng, 0.1), _tree(rng, 0.1)
    v = {n: np.abs(a) for n, a in v.items()}
    jdt = jnp.bfloat16 if state_dtype == "bfloat16" else jnp.float32
    jstate = {"m": {n: jnp.asarray(a, jdt) for n, a in m.items()},
              "v": {n: jnp.asarray(a, jdt) for n, a in v.items()},
              "step": jnp.int32(step)}
    want_p, want_s, want_m = jax_adamw.apply_updates(
        jcfg, jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, grads), jstate)

    tdt = adamw.STATE_DTYPES[state_dtype]
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    state = {"m": {n: torch.from_numpy(a).to(tdt) for n, a in m.items()},
             "v": {n: torch.from_numpy(a).to(tdt) for n, a in v.items()},
             "step": torch.tensor(step, dtype=torch.int32)}
    state, metrics = adamw.apply_updates(
        cfg, tp, {n: torch.from_numpy(a) for n, a in grads.items()}, state)
    assert int(state["step"]) == step + 1 == int(want_s["step"])
    for key in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), float(want_m[key]),
                                   rtol=1e-6)
    assert (float(want_m["grad_norm"]) > cfg.clip_norm) == (grad_scale > 1)
    for n in params:
        np.testing.assert_allclose(_t(tp[n]), _np(want_p[n]), rtol=1e-6,
                                   atol=1e-9)
        for mom in ("m", "v"):
            assert state[mom][n].dtype == tdt
            tol = (dict(rtol=2 ** -7, atol=0) if state_dtype == "bfloat16"
                   else dict(rtol=1e-6, atol=1e-9))
            np.testing.assert_allclose(_t(state[mom][n]),
                                       _np(want_s[mom][n]), **tol)


def test_adamw_init_state_and_schedule():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=4, total_steps=12,
                            state_dtype="bfloat16")
    state = adamw.init_state({"a": torch.ones(3, 2)}, cfg)
    assert state["m"]["a"].dtype == torch.bfloat16
    assert not state["v"]["a"].any() and int(state["step"]) == 0
    jcfg = jax_adamw.AdamWConfig(**dataclasses.asdict(cfg))
    for s in range(15):
        np.testing.assert_allclose(
            float(adamw.schedule(cfg, torch.tensor(s))),
            float(jax_adamw.schedule(jcfg, jnp.int32(s))), rtol=1e-6)


# ------------------------------------------------------ the training step
def _jax_smoke(name, **kw):
    return dataclasses.replace(jax_archs.smoke(getattr(jax_archs, name)),
                               **kw)


def _port_smoke(name, **kw):
    return dataclasses.replace(lm_archs.smoke(getattr(lm_archs, name)),
                               **kw)


def _close(got, want, rtol, floor):
    """|got - want| <= rtol |want| + floor * rms(want), per element."""
    got, want = _t(got), _np(want)
    rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    excess = np.abs(got - want) - (rtol * np.abs(want) + floor * rms)
    return float(excess.max()) <= 0.0


def _step_both(name, jax_kw, port_kw, seq=32, batch=4, seed=0):
    """One training step of both packages from the same state; returns
    (reference metrics, params, opt state) and (port metrics, model,
    opt state)."""
    jcfg = _jax_smoke(name, **jax_kw)
    cfg = _port_smoke(name, **port_kw)
    opt = jax_adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    params = jax.tree.map(np.asarray,
                          jtr.init_params(jcfg, jax.random.PRNGKey(seed)))
    jstate = jax_adamw.init_state(params)
    tokens, labels = batch_at_step(TokenStreamConfig(jcfg.vocab, seq,
                                                     batch), 1)
    step = jax.jit(lambda p, o, t, l: jax_steps.lm_train_step(
        jcfg, opt, p, o, t, l))
    new_p, new_s, jm = step(jax.tree.map(jnp.asarray, params), jstate,
                            jnp.asarray(tokens), jnp.asarray(labels))

    model = TransformerLM(cfg, lm_params_from_reference(cfg, params),
                          device="cpu")
    state = adamw_state_from_reference(
        cfg, jax.tree.map(np.asarray, jstate))
    pm = lm_train_step(model, adamw.AdamWConfig(
        **dataclasses.asdict(opt)), state, tokens, labels)
    return (jm, new_p, new_s), (pm, model, state), opt.lr


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_lm_train_step_matches_jax(n_micro, remat):
    """qwen3-4b smoke, f32 compute: the port's pallas path (the Function's
    plain backward) against the reference's xla path (``jax.grad``)."""
    kw = dict(n_microbatches=n_micro, remat=remat)
    (jm, jp, js), (pm, model, state), lr = _step_both(
        "QWEN3_4B", dict(dtype=jnp.float32, **kw),
        dict(dtype=torch.float32, attention_impl="pallas", **kw))
    for key in ("loss", "nll", "grad_norm", "lr"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    assert float(pm["aux"]) == float(jm["aux"]) == 0.0
    assert int(state["step"]) == int(js["step"]) == 1
    want = named_lm_params(lm_params_from_reference(
        model.cfg, jax.tree.map(np.asarray, jp)))
    want_state = adamw_state_from_reference(model.cfg,
                                            jax.tree.map(np.asarray, js))
    for name, p in model.named_parameters():
        assert float((p.detach() - want[name]).abs().max()) <= 2 * lr, name
        for mom in ("m", "v"):
            assert _close(state[mom][name], want_state[mom][name], 1e-3,
                          1e-3), (mom, name)
    back = lm_params_to_reference(model)
    np.testing.assert_array_equal(back["layers"]["attn"]["wq"][1],
                                  _t(model.layers[1].attn["wq"]))


def test_lm_train_step_bf16_matches_jax():
    (jm, jp, _), (pm, model, _), lr = _step_both(
        "QWEN3_4B", dict(), dict(attention_impl="pallas"))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]),
                                   **BF16_TOL, err_msg=key)
    want = named_lm_params(lm_params_from_reference(
        model.cfg, jax.tree.map(np.asarray, jp)))
    for name, p in model.named_parameters():
        assert float((p.detach() - want[name]).abs().max()) <= 2 * lr, name


def test_windowed_lm_train_step_matches_jax_xla():
    """gemma3 smoke (windows 16, 16, 0, ...; tied embeddings), f32: the
    port's pallas path keeps each layer's window in the forward and the
    backward, as the reference's xla path does."""
    (jm, jp, _), (pm, model, _), lr = _step_both(
        "GEMMA3_12B", dict(dtype=jnp.float32),
        dict(dtype=torch.float32, attention_impl="pallas"), seq=48)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    want = named_lm_params(lm_params_from_reference(
        model.cfg, jax.tree.map(np.asarray, jp)))
    assert "lm_head" not in want
    for name, p in model.named_parameters():
        assert float((p.detach() - want[name]).abs().max()) <= 2 * lr, name


def test_training_lowers_the_loss_and_counts_no_launch_on_cpu():
    cfg = _port_smoke("QWEN3_4B", attention_impl="pallas")
    model = TransformerLM(cfg, device="cpu", seed=3)
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=100)
    state = adamw.init_state(model, opt)
    batch = batch_at_step(TokenStreamConfig(cfg.vocab, 32, 4), 0)
    before = flash_ops.flash_attention.launches
    losses = [float(lm_train_step(model, opt, state, *batch)["loss"])
              for _ in range(8)]    # one batch, learnt
    assert flash_ops.flash_attention.launches == before
    assert losses[-1] < losses[0] - 0.1, losses
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_loss_gradient_in_row_chunks(monkeypatch, dtype):
    """The loss, computed a few rows at a time, and its gradient in the
    logits' type against autograd through the whole f32 cross-entropy:
    f32 within 1e-6, bf16 within one ulp of each element (2^-7) above a
    floor of 1e-9 for the elements that round to near zero."""
    from repro_torch.models import transformer
    monkeypatch.setattr(transformer, "LOSS_CHUNK_ELEMENTS", 3 * 37)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 5, 37)).astype(
        np.float32) * 3).to(dtype)
    labels = torch.from_numpy(rng.integers(0, 37, (2, 5)))
    a = x.clone().requires_grad_()
    loss, m = transformer.lm_loss(a, torch.tensor(0.25), labels, 0.1)
    (ga,) = torch.autograd.grad(loss, a)
    b = x.clone().requires_grad_()
    want = torch.nn.functional.cross_entropy(b.float().reshape(-1, 37),
                                             labels.reshape(-1))
    (gb,) = torch.autograd.grad(want, b)
    assert ga.dtype == dtype
    assert abs(float(m["nll"]) - float(want)) <= 1e-6
    assert abs(float(loss) - float(want) - 0.025) <= 1e-6
    tol = (dict(rtol=0, atol=1e-6) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-9))
    np.testing.assert_allclose(_t(ga), _t(gb), **tol)


# ------------------------------------------------- checkpoints and resume
def test_train_cli_resume(tmp_path):
    """The train driver resumes deterministically (loss curve continuous),
    as the reference's ``test_runtime.py::test_train_cli_resume``."""
    d = str(tmp_path / "ck")
    train_lm("qwen3-4b", True, 6, d, batch=2, seq_len=16, ckpt_every=3,
             log_every=100, device="cpu")
    losses_b = train_lm("qwen3-4b", True, 10, d, batch=2, seq_len=16,
                        ckpt_every=3, log_every=100, device="cpu")
    full = train_lm("qwen3-4b", True, 10, "", batch=2, seq_len=16,
                    log_every=100, device="cpu")
    assert len(losses_b) == 10 - 6             # resumed from step 6
    np.testing.assert_allclose(losses_b, full[6:], rtol=2e-3, atol=2e-3)


def test_checkpointer_saves_atomically_keeps_and_restores(tmp_path):
    d = str(tmp_path)
    tree = {"params": {"w": torch.randn(3, 4),
                       "h": torch.randn(5).to(torch.bfloat16)},
            "opt": {"m": [torch.zeros(2), torch.arange(3)],
                    "step": torch.tensor(7, dtype=torch.int32)}}
    assert checkpointer.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        checkpointer.restore(d, tree)
    for s in range(5):
        checkpointer.save(d, s, tree, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    # a writer stopped midway leaves only a .tmp directory: not a step
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert checkpointer.latest_step(d) == 4
    with open(os.path.join(d, "step_00000004", "manifest.json")) as f:
        names = [rec["name"] for rec in json.load(f)["leaves"]]
    assert names == ["params__w", "params__h", "opt__m__0", "opt__m__1",
                     "opt__step"]
    like = copy.deepcopy(tree)
    like["params"]["w"].zero_()
    got, step = checkpointer.restore(d, like)
    assert step == 4
    flat_got = jax.tree_util.tree_leaves(got)
    flat_want = jax.tree_util.tree_leaves(tree)
    for g, w in zip(flat_got, flat_want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    checkpointer.save(d, 9, tree, keep=0)
    assert checkpointer.latest_step(d) == 9
    assert "step_00000009.tmp" not in os.listdir(d)
