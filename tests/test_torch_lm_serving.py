"""The port's LM serving path against the JAX package's, on the CPU: the
chunked attention, the xla forward from ``CHUNKED_ATTN_THRESHOLD`` on,
``prefill``, ``decode_step`` on a (ring-buffer) KV cache, the serving
steps and ``launch/serve.py``.

Inputs are drawn with numpy from a seed; weights are the JAX package's
``init_params``, carried over with ``lm_params_from_reference``; the JAX
side is jitted.  The configs are the registry's smoke configs at f32.

Tolerances, stated before measuring:
- the chunked attention against JAX's, in both branches, with and
  without a window, with ``p_bf16`` and with K > S: within 1e-5 of the
  largest |output| (the same online softmax over the same chunks; the two
  frameworks' exp and matmuls round otherwise); its gradients under
  checkpointing against ``attention_xla``'s within 1e-5 of each
  gradient's largest |element|;
- logits of a whole forward, ``prefill`` or ``decode_step``: within 1e-5
  of the largest |logit| (plus 1e-5 absolute where the logits are below
  1); the KV cache within 1e-5 of its largest |element|; ``length``
  exactly;
- ``serve``: the generated tokens exactly (the decode is fed its own
  argmax in both packages) and every step's logits as above.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm_archs as jax_archs
from repro.configs import registry as jax_registry
from repro.launch import serve as jax_serve
from repro.launch import steps as jax_steps
from repro.models import layers as jl
from repro.models import transformer as jtr

from repro_torch.configs import lm_archs
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import serve as port_serve
from repro_torch.launch.steps import (lm_cache_shape, lm_decode_step,
                                      lm_prefill_step)
from repro_torch.models import layers as tl
from repro_torch.models.transformer import (CHUNKED_ATTN_THRESHOLD,
                                            TransformerLM)

RTOL = 1e-5
DENSE = ("GEMMA3_12B", "QWEN2_5_32B", "QWEN3_4B")


def _close(got, want, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    limit = RTOL * max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= limit, (what, err, limit)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------ chunked attention
CHUNKED_CASES = {
    # name: (B, S, K, H, Hkv, D, chunk_q, chunk_kv, window, p_bf16)
    "square": (2, 64, 64, 4, 2, 16, 16, 16, None, False),
    "window": (2, 64, 64, 4, 2, 16, 16, 32, 12, False),
    "k_longer": (1, 64, 128, 4, 2, 16, 16, 32, None, False),
    "k_longer_window": (1, 64, 128, 4, 4, 16, 32, 16, 40, False),
    "p_bf16": (2, 64, 64, 4, 2, 16, 16, 16, None, True),
    "p_bf16_window": (1, 64, 128, 4, 2, 16, 32, 32, 24, True),
}


def _attention_inputs(B, S, K, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, K, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, K, Hkv, D)).astype(np.float32)
    # queries aligned to the end of the keys, as the skipping branch asks
    qp = np.broadcast_to(np.arange(K - S, K, dtype=np.int32), (B, S)).copy()
    kp = np.broadcast_to(np.arange(K, dtype=np.int32), (B, K)).copy()
    return q, k, v, qp, kp


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("case", sorted(CHUNKED_CASES))
def test_chunked_attention_matches_jax(case, static):
    B, S, K, H, Hkv, D, cq, ck, window, p_bf16 = CHUNKED_CASES[case]
    q, k, v, qp, kp = _attention_inputs(B, S, K, H, Hkv, D)
    kw = dict(window=window, causal=True, chunk_q=cq, chunk_kv=ck,
              p_bf16=p_bf16, static_positions=static,
              static_window=window if static else None)
    want = jax.jit(functools.partial(jl.attention_xla_chunked, **kw))(
        q, k, v, qp, kp)
    got = tl.attention_xla_chunked(*map(_t, (q, k, v, qp, kp)), **kw)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, case)


def test_chunked_attention_groups_q_chunks_without_changing_them(
        monkeypatch):
    """One KV step over every q chunk at once, or one q chunk at a time
    (``Q_GROUP_ELEMENTS`` at its floor): the same arithmetic."""
    q, k, v, qp, kp = map(_t, _attention_inputs(2, 64, 64, 4, 2, 16))
    kw = dict(window=20, chunk_q=16, chunk_kv=16)
    whole = tl.attention_xla_chunked(q, k, v, qp, kp, **kw)
    monkeypatch.setattr(tl, "Q_GROUP_ELEMENTS", 1)
    one = tl.attention_xla_chunked(q, k, v, qp, kp, **kw)
    torch.testing.assert_close(one, whole, rtol=0, atol=2e-7)


def test_chunked_attention_needs_whole_chunks():
    q, k, v, qp, kp = map(_t, _attention_inputs(1, 48, 48, 2, 2, 8))
    with pytest.raises(ValueError, match="multiples"):
        tl.attention_xla_chunked(q, k, v, qp, kp, chunk_q=32, chunk_kv=16)
    with pytest.raises(ValueError, match="multiples"):
        tl.attention_xla_chunked(q, k, v, qp, kp, chunk_q=16, chunk_kv=32,
                                 static_positions=True)


def _saved_shapes(fn):
    """The shapes of the tensors autograd saves (outside checkpointed
    regions) while ``fn()`` runs, and its result."""
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return shapes, out


@pytest.mark.parametrize("static", [False, True])
def test_chunked_gradients_under_checkpointing(static, monkeypatch):
    """The chunked attention's q, k, v gradients equal ``attention_xla``'s,
    and its KV steps run under checkpointing: autograd keeps no (..., cq,
    ck) logits tensor of a step (without the checkpoint it keeps some)."""
    B, S, H, Hkv, D, cq, ck, window = 2, 64, 4, 2, 8, 16, 32, 24
    q, k, v, qp, kp = map(_t, _attention_inputs(B, S, S, H, Hkv, D, seed=3))
    cot = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, S, H, D)).astype(np.float32))
    kw = dict(window=window, chunk_q=cq, chunk_kv=ck,
              static_positions=static,
              static_window=window if static else None)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    shapes, out = _saved_shapes(
        lambda: tl.attention_xla_chunked(*leaves, qp, kp, **kw))
    assert shapes and not [s for s in shapes if s[-2:] == (cq, ck)], shapes
    (out * cot).sum().backward()
    ref = [x.clone().requires_grad_(True) for x in (q, k, v)]
    mask = tl.make_attention_mask(qp, kp, window, causal=True)
    (tl.attention_xla(*ref, mask[:, None, None]) * cot).sum().backward()
    for name, a, b in zip("qkv", leaves, ref):
        _close(a.grad.numpy(), b.grad.numpy(), name)
    monkeypatch.setattr(tl, "_checkpointed", lambda fn, *args: fn(*args))
    shapes, _ = _saved_shapes(lambda: tl.attention_xla_chunked(
        *[x.clone().requires_grad_(True) for x in (q, k, v)], qp, kp, **kw))
    assert [s for s in shapes if s[-2:] == (cq, ck)]


# ---------------------------------------------------------- whole models
def _configs(name, **kw):
    jcfg = dataclasses.replace(jax_archs.smoke(getattr(jax_archs, name)),
                               dtype=jnp.float32, **kw)
    cfg = dataclasses.replace(lm_archs.smoke(getattr(lm_archs, name)),
                              dtype=torch.float32, **kw)
    return jcfg, cfg


def _models(name, seed=0, **kw):
    jcfg, cfg = _configs(name, **kw)
    params = jax.tree.map(np.asarray,
                          jtr.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, params, TransformerLM(
        cfg, lm_params_from_reference(cfg, params), device="cpu")


def test_xla_forward_at_the_chunked_threshold_matches_jax():
    S = CHUNKED_ATTN_THRESHOLD
    jcfg, params, model = _models("QWEN3_4B")
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab, (1, S))
    want, _ = jax.jit(functools.partial(jtr.forward, jcfg))(params, tokens)
    logits, _ = model(tokens)
    _close(logits.detach().numpy(), want)


def _grow_reference(cache, n_slots):
    pad = n_slots - cache["k"].shape[2]
    widths = ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0))
    return {"k": jnp.pad(cache["k"], widths),
            "v": jnp.pad(cache["v"], widths), "length": cache["length"]}


def _check_cache(cache, want):
    _close(cache["k"].numpy(), want["k"], "k")
    _close(cache["v"].numpy(), want["v"], "v")
    np.testing.assert_array_equal(cache["length"].numpy(),
                                  np.asarray(want["length"]))
    assert cache["length"].dtype == torch.int32


# (arch, prompt length, decode steps, allocated slots, config changes)
SERVING_CASES = {
    "gemma3": ("GEMMA3_12B", 24, 8, 32, {}),
    "qwen2.5": ("QWEN2_5_32B", 24, 8, 32, {}),
    "qwen3": ("QWEN3_4B", 24, 8, 32, {}),
    # every layer windowed: lm_cache_shape bounds the cache at the window,
    # so the ring buffer wraps twice over the 8 slots
    "qwen3_ring": ("QWEN3_4B", 5, 14, None,
                   {"sliding_window": 8, "local_global_ratio": 0}),
    # the prefill's chunked branch, static skipping on
    "qwen3_chunked": ("QWEN3_4B", CHUNKED_ATTN_THRESHOLD, 3, None,
                      {"attn_static_skip": True, "attn_chunk_q": 1024}),
}


@pytest.mark.parametrize("case", sorted(SERVING_CASES))
def test_prefill_and_decode_match_jax(case):
    name, S, steps, slots, kw = SERVING_CASES[case]
    jcfg, params, model = _models(name, seed=2, **kw)
    B = 2
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    feed = rng.integers(0, jcfg.vocab, (steps, B)).astype(np.int32)
    want_logits, want_cache = jax.jit(functools.partial(
        jax_steps.lm_prefill_step, jcfg))(params, tokens)
    logits, cache = lm_prefill_step(model, tokens)
    _close(logits.numpy(), want_logits, "prefill")
    _check_cache(cache, want_cache)
    if slots is None:
        slots = lm_cache_shape(model.cfg, B, S + steps)[2]
        assert slots == jax_steps.lm_cache_shape(jcfg, B, S + steps)[2]
    want_cache = _grow_reference(want_cache, slots)
    cache = port_serve.grow_cache(cache, slots)
    decode = jax.jit(functools.partial(jax_steps.lm_decode_step, jcfg))
    k_buffer = cache["k"]
    for i in range(steps):
        want_logits, want_cache = decode(params, want_cache, feed[i])
        logits, cache = lm_decode_step(model, cache, torch.from_numpy(
            feed[i]))
        _close(logits.numpy(), want_logits, f"decode {i}")
        _check_cache(cache, want_cache)
        assert cache["k"] is k_buffer      # written in place
    assert int(cache["length"][0]) == S + steps
    if case == "qwen3_ring":
        assert slots == 8 and S + steps > 2 * slots


def test_serve_matches_the_reference_step_by_step(monkeypatch):
    """``serve`` on qwen3-4b's smoke config (f32) against the reference's
    ``serve`` (its generated tokens) and its prefill, cache growth and
    decode loop fed those tokens (its logits)."""
    jcfg, params, model = _models("QWEN3_4B", seed=0)
    entry = jax_registry.get("qwen3-4b")
    monkeypatch.setitem(jax_registry.REGISTRY, "qwen3-4b",
                        dataclasses.replace(entry, smoke_config=jcfg))
    batch, prompt_len, gen = 2, 12, 6
    want = jax_serve.serve("qwen3-4b", True, batch, prompt_len, gen, seed=0)
    got = port_serve.serve("qwen3-4b", True, batch, prompt_len, gen,
                           seed=0, model=model)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert tuple(got["logits"].shape) == (gen + 1, batch, jcfg.vocab)
    prompts = np.random.default_rng(0).integers(
        0, jcfg.vocab, (batch, prompt_len)).astype(np.int32)
    logits, cache = jtr.prefill(jcfg, params, prompts)
    cache = _grow_reference(cache, prompt_len + gen)
    _close(got["logits"][0].numpy(), logits, "prefill")
    for i in range(gen):
        logits, cache = jtr.decode_step(
            jcfg, params, cache, jnp.asarray(want["generated"][:, i]))
        _close(got["logits"][i + 1].numpy(), logits, f"step {i}")
    assert got["cache"]["k"].shape[2] == prompt_len + gen
    for key in ("prefill_s", "decode_s", "prefill_tok_s", "decode_tok_s"):
        assert got[key] > 0


def test_grown_cache_is_zero_past_the_prompt():
    k = torch.full((2, 1, 3, 2, 4), float("nan"))
    k[:, :, :3] = 1.0
    cache = {"k": k, "v": k.clone(), "length": torch.tensor(
        [3], dtype=torch.int32)}
    grown = port_serve.grow_cache(cache, 7)
    assert tuple(grown["k"].shape) == (2, 1, 7, 2, 4)
    assert bool((grown["k"][:, :, :3] == 1).all())
    assert bool((grown["v"][:, :, 3:] == 0).all())
    assert grown["length"] is cache["length"]


def test_serve_cli_and_device_rule(monkeypatch, capsys):
    port_serve.main(["--arch", "qwen3-4b", "--device", "cpu", "--batch",
                     "1", "--prompt-len", "8", "--gen", "2"])
    assert "prefill" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_serve.serve("qwen3-4b", True, 1, 4, 1)
    jcfg, params, model = _models("QWEN3_4B")
    with pytest.raises(ValueError, match="cannot serve"):
        port_serve.serve("gemma3-12b", True, 1, 4, 1, model=model)


@pytest.mark.parametrize("name", ("GEMMA3_12B", "QWEN2_5_32B", "QWEN3_4B",
                                  "LLAMA4_SCOUT", "MIXTRAL_8X22B"))
def test_cache_shape_matches_jax(name):
    jcfg, cfg = getattr(jax_archs, name), getattr(lm_archs, name)
    for batch, seq in ((1, 32768), (128, 32784), (4, 100)):
        assert lm_cache_shape(cfg, batch, seq) == \
            jax_steps.lm_cache_shape(jcfg, batch, seq)
    assert cfg.static_window == jcfg.static_window
