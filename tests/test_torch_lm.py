"""The port's LM forward against the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages; the
weights are the JAX package's ``init_params``, carried over with
``repro_torch.convert.lm_params_from_reference``.  On the CPU the port's
``flash_attention`` runs its plain version; the CUDA kernel is held against
that plain version in ``tests/test_torch_cuda.py``.

Tolerances: f32 results agree to rounding (the two frameworks sum matmuls
and softmaxes in other orders): 2e-5 for one attention or layer, 1e-4 for
a whole forward.  bf16 results agree to a few output ulps: 2e-2 absolute,
at values below 1 (as in ``tests/test_kernels.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm_archs as jax_archs
from repro.configs import registry as jax_registry
from repro.data import tokens as jax_tokens
from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro.models import layers as jl
from repro.models import transformer as jtr

from repro_torch.configs import lm_archs, registry
from repro_torch.convert import lm_params_from_reference
from repro_torch.data.tokens import TokenStreamConfig, batch_at_step
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import layers as tl
from repro_torch.models.transformer import (TransformerLM, init_params,
                                            lm_loss)

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
FORWARD_F32_ATOL = 1e-4
ARCHS = ("GEMMA3_12B", "QWEN2_5_32B", "QWEN3_4B", "LLAMA4_SCOUT",
         "MIXTRAL_8X22B")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return x.detach().float().numpy()


def _pair(rng, shape, dtype):
    """The same numbers as a JAX array and a torch tensor of ``dtype``."""
    a = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("B,S,K,H,Hkv,D", [
    (1, 128, 128, 4, 4, 32),      # MHA square
    (2, 256, 256, 4, 2, 64),      # GQA
    (1, 128, 384, 8, 8, 32),      # cross (decode-style, q shorter)
    (2, 256, 256, 8, 2, 128),     # GQA wide head
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_plain_attention_matches_jax_ref(B, S, K, H, Hkv, D, dtype, causal,
                                         window):
    """The whole flash sweep of ``tests/test_kernels.py``."""
    rng = np.random.default_rng(0)
    jq, q = _pair(rng, (B, S, H, D), dtype)
    jk, k = _pair(rng, (B, K, Hkv, D), dtype)
    jv, v = _pair(rng, (B, K, Hkv, D), dtype)
    want = jax_attention(jq, jk, jv, causal=causal, window=window)
    got = attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == DTYPES[dtype][1]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_t(got), _np(want), **tol)
    via_ops = flash_ops.flash_attention(q, k, v, causal=causal,
                                        window=window)
    assert torch.equal(via_ops, got)


@pytest.mark.parametrize("B,S,K,H,Hkv,D,window", [
    (1, 128, 384, 8, 8, 32, 0),       # K > S
    (1, 256, 256, 4, 4, 64, 64),      # window 64
    (1, 128, 384, 4, 2, 32, 64),      # K > S with a window, GQA
])
def test_plain_attention_matches_jax_pallas_interpret(B, S, K, H, Hkv, D,
                                                      window):
    rng = np.random.default_rng(1)
    jq, q = _pair(rng, (B, S, H, D), "float32")
    jk, k = _pair(rng, (B, K, Hkv, D), "float32")
    jv, v = _pair(rng, (B, K, Hkv, D), "float32")
    want = flash_attention_fwd(jq, jk, jv, causal=True, window=window,
                               block_q=64, block_kv=64, interpret=True)
    got = flash_ops.flash_attention(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(_t(got), _np(want), **F32_TOL)


def test_flash_attention_refuses_what_it_would_drop():
    q = torch.zeros(1, 16, 2, 32)
    k = torch.zeros(1, 16, 2, 32)
    with pytest.raises(TypeError, match="window"):
        flash_ops.flash_attention(q, k, k, window=torch.tensor(4))
    with pytest.raises(TypeError, match="window"):
        flash_ops.flash_attention(q, k, k, window=np.int32(4))
    with pytest.raises(ValueError, match="K 8 < S 16"):
        flash_ops.flash_attention(q, k[:, :8], k[:, :8], causal=True)
    before = flash_ops.flash_attention.launches
    flash_ops.flash_attention(q, k, k)
    assert flash_ops.flash_attention.launches == before  # CPU: no kernel


# ------------------------------------------------------------------- layers
def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(2)
    jx, x = _pair(rng, (2, 24, 4, 32), "float32")
    jscale, scale = _pair(rng, (32,), "float32")
    np.testing.assert_allclose(_t(tl.rms_norm(x, scale)),
                               _np(jl.rms_norm(jx, jscale)), **F32_TOL)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32) * 37, (2, 24))
    for theta in (10000.0, 1_000_000.0):
        want = jl.apply_rope(jx, jnp.asarray(pos), theta)
        got = tl.apply_rope(x, torch.from_numpy(pos.copy()), theta)
        np.testing.assert_allclose(_t(got), _np(want), **F32_TOL)


@pytest.mark.parametrize("bias,qk_norm", [(True, True), (True, False),
                                          (False, True)])
def test_attn_qkv_matches_jax(bias, qk_norm):
    spec = tl.AttnParamsSpec(64, 4, 2, 16, bias, qk_norm)
    jp = jl.init_attn(jax.random.PRNGKey(3), spec)
    rng = np.random.default_rng(3)
    if bias:       # nonzero biases and norm scales, so both are exercised
        for name in ("bq", "bk", "bv"):
            jp[name] = jnp.asarray(rng.standard_normal(jp[name].shape),
                                   jnp.float32)
    if qk_norm:
        for name in ("q_norm", "k_norm"):
            jp[name] = jnp.asarray(0.1 * rng.standard_normal(16), jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    jx, x = _pair(rng, (2, 24, 64), "float32")
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    want = jl.attn_qkv(jp, jx, spec, jnp.asarray(pos), 1_000_000.0)
    got = tl.attn_qkv(tp, x, spec, torch.from_numpy(pos.copy()), 1_000_000.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_t(g), _np(w), **F32_TOL)


def test_mlp_swiglu_and_attention_xla_match_jax():
    jp = jl.init_mlp(jax.random.PRNGKey(4), 64, 128)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(4)
    jx, x = _pair(rng, (2, 24, 64), "float32")
    np.testing.assert_allclose(_t(tl.mlp_swiglu(tp, x)),
                               _np(jl.mlp_swiglu(jp, jx)), **F32_TOL)
    jq, q = _pair(rng, (2, 24, 4, 16), "float32")
    jk, k = _pair(rng, (2, 24, 2, 16), "float32")
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    jmask = jl.make_attention_mask(jnp.asarray(pos), jnp.asarray(pos), 8)
    mask = tl.make_attention_mask(torch.from_numpy(pos.copy()),
                                  torch.from_numpy(pos.copy()), 8)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    want = jl.attention_xla(jq, jk, jk, jmask[:, None, None])
    got = tl.attention_xla(q, k, k, mask[:, None, None])
    np.testing.assert_allclose(_t(got), _np(want), **F32_TOL)


# ------------------------------------------------------------ whole forward
def _jax_smoke(name):
    return jax_archs.smoke(getattr(jax_archs, name))


def _port_smoke(name):
    return lm_archs.smoke(getattr(lm_archs, name))


@pytest.fixture(scope="module")
def qwen3():
    """The qwen3-4b smoke config, JAX weights, one batch (S 32), and the
    JAX forward's logits and loss for each dtype and attention_impl."""
    jcfg = _jax_smoke("QWEN3_4B")
    params = jax.tree.map(np.asarray,
                          jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens, labels = batch_at_step(TokenStreamConfig(jcfg.vocab, 32, 2), 0)
    want = {}
    for dtype, (jdt, _) in DTYPES.items():
        for impl in ("xla", "pallas"):
            cfg = dataclasses.replace(jcfg, dtype=jdt, attention_impl=impl)
            logits, _ = jtr.forward(cfg, params, jnp.asarray(tokens))
            loss, _ = jtr.loss_fn(cfg, params, jnp.asarray(tokens),
                                  jnp.asarray(labels))
            want[dtype, impl] = (_np(logits), float(loss))
    return params, tokens, labels, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("port_impl", ["pallas", "xla"])
@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_qwen3_forward_and_loss_match_jax(qwen3, dtype, port_impl, jax_impl):
    params, tokens, labels, want = qwen3
    cfg = dataclasses.replace(_port_smoke("QWEN3_4B"),
                              dtype=DTYPES[dtype][1],
                              attention_impl=port_impl)
    model = TransformerLM(cfg, lm_params_from_reference(cfg, params),
                          device="cpu")
    logits, aux = model(tokens)
    want_logits, want_loss = want[dtype, jax_impl]
    assert logits.dtype == cfg.dtype and float(aux) == 0.0
    loss, metrics = model.loss_fn(tokens, labels)
    if dtype == "float32":
        np.testing.assert_allclose(_t(logits), want_logits, rtol=0,
                                   atol=FORWARD_F32_ATOL)
        assert abs(float(loss) - want_loss) <= FORWARD_F32_ATOL
    else:
        np.testing.assert_allclose(_t(logits), want_logits, **BF16_TOL)
        assert abs(float(loss) - want_loss) <= 2e-2
    assert float(metrics["nll"]) == float(loss)


def test_windowed_forward_keeps_the_window():
    """gemma3 smoke (2 local : 1 global, window 16, tied embeddings) at
    S 48: the port's pallas path equals the JAX xla path.  The JAX pallas
    path drops the window inside its layer scan, so it differs."""
    jcfg = dataclasses.replace(_jax_smoke("GEMMA3_12B"), dtype=jnp.float32)
    params = jax.tree.map(np.asarray,
                          jtr.init_params(jcfg, jax.random.PRNGKey(1)))
    assert "lm_head" not in params
    tokens, labels = batch_at_step(TokenStreamConfig(jcfg.vocab, 48, 2), 3)
    want, _ = jtr.forward(jcfg, params, jnp.asarray(tokens))
    dropped, _ = jtr.forward(dataclasses.replace(jcfg,
                                                 attention_impl="pallas"),
                             params, jnp.asarray(tokens))
    assert np.abs(_np(dropped) - _np(want)).max() > 1e-2
    cfg = dataclasses.replace(_port_smoke("GEMMA3_12B"), dtype=torch.float32,
                              attention_impl="pallas")
    assert list(cfg.layer_windows()) == [16, 16, 0, 16, 16, 0]
    model = TransformerLM(cfg, lm_params_from_reference(cfg, params),
                          device="cpu")
    logits, _ = model(tokens)
    np.testing.assert_allclose(_t(logits), _np(want), rtol=0,
                               atol=FORWARD_F32_ATOL)
    xla = TransformerLM(dataclasses.replace(cfg, attention_impl="xla"),
                        lm_params_from_reference(cfg, params), device="cpu")
    np.testing.assert_allclose(_t(xla(tokens)[0]), _np(want), rtol=0,
                               atol=FORWARD_F32_ATOL)


# ------------------------------------------------------- configs and data
@pytest.mark.parametrize("name", ARCHS)
def test_configs_match_jax(name):
    for full in (True, False):
        jcfg = getattr(jax_archs, name)
        cfg = getattr(lm_archs, name)
        if not full:
            jcfg, cfg = jax_archs.smoke(jcfg), lm_archs.smoke(cfg)
        jfields = dataclasses.asdict(jcfg)
        fields = dataclasses.asdict(cfg)
        assert jfields.pop("dtype") == jnp.bfloat16
        assert fields.pop("dtype") == torch.bfloat16
        assert fields == jfields
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        np.testing.assert_array_equal(cfg.layer_windows(),
                                      jcfg.layer_windows())


def test_registry_and_shapes_match_jax():
    lm = {aid for aid, e in jax_registry.REGISTRY.items() if e.family == "lm"}
    assert list(registry.REGISTRY) == list(jax_registry.REGISTRY)
    for aid in registry.REGISTRY:
        e, je = registry.get(aid), jax_registry.get(aid)
        assert (e.family, e.skip_shapes) == (je.family, je.skip_shapes)
        if aid in lm:
            assert e.config.param_count() == je.config.param_count()
        assert ({k: dataclasses.asdict(v) for k, v in e.shapes.items()}
                == {k: dataclasses.asdict(v) for k, v in je.shapes.items()})
    assert registry.get("qwen3-4b").config.param_count() == 4_411_415_040
    # every arch of the reference's registry resolves in the port
    for aid, e in jax_registry.REGISTRY.items():
        assert registry.get(aid).config.name == e.config.name
    with pytest.raises(KeyError):
        registry.get("no-such-arch")


@pytest.mark.parametrize("step", [0, 7])
def test_token_batches_match_jax(step):
    spec = dict(vocab=151936, seq_len=64, global_batch=3, seed=5)
    got = batch_at_step(TokenStreamConfig(**spec), step)
    want = jax_tokens.batch_at_step(jax_tokens.TokenStreamConfig(**spec),
                                    step)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_init_params_shapes_and_scales_match_jax():
    name = "QWEN2_5_32B"   # qkv bias: every kind of leaf
    jcfg, cfg = _jax_smoke(name), _port_smoke(name)
    want = lm_params_from_reference(
        cfg, jax.tree.map(np.asarray,
                          jtr.init_params(jcfg, jax.random.PRNGKey(0))))
    got = init_params(cfg, torch.Generator().manual_seed(0))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        # same scale: standard deviations within 15% (zeros stay zeros)
        ws, gs = float(w.std()), float(g.std())
        assert (ws == 0) == (gs == 0), path
        if ws:
            assert abs(gs / ws - 1) < 0.15, (path, gs, ws)


def test_bf16_reference_params_carry_over_exactly():
    jcfg, cfg = _jax_smoke("GEMMA3_12B"), _port_smoke("GEMMA3_12B")
    params = jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.bfloat16)),
        jtr.init_params(jcfg, jax.random.PRNGKey(2)))
    got = lm_params_from_reference(cfg, params)
    assert "lm_head" not in got and got["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["embed"].float().numpy(),
                                  params["embed"].astype(np.float32))
    np.testing.assert_array_equal(
        got["layers"][3]["attn"]["wq"].float().numpy(),
        params["layers"]["attn"]["wq"][3].astype(np.float32))


# ----------------------------------------------------------------- refusals
def test_unported_paths_raise():
    """Every LM path runs, MoE configs included (their values are held
    against the JAX package's in ``tests/test_torch_moe.py``, the chunked
    forward's, ``prefill``'s and ``decode_step``'s in
    ``tests/test_torch_lm_serving.py``); what needs what is missing
    raises: ``compressed_psum`` (item 12, ported; its values are held in
    ``tests/test_torch_dht_group.py``) without a process group.  A
    ``TrainRunner`` given shardings (item 11, ported) builds, and refuses
    only ill-formed ones (``tests/test_torch_runtime.py``)."""
    from repro_torch.optim import grad_compression
    from repro_torch.runtime.fault_tolerance import (RunnerConfig,
                                                     TrainRunner)
    for name in ("LLAMA4_SCOUT", "MIXTRAL_8X22B"):
        cfg = _port_smoke(name)
        model = TransformerLM(cfg, device="cpu")
        assert len(model.layers[0].moe.w_gate) == cfg.moe_experts
    g = {"w": torch.ones(3)}
    with pytest.raises(RuntimeError, match="process group"):
        grad_compression.compressed_psum(
            g, grad_compression.init_feedback(g), "data")
    runner = TrainRunner(RunnerConfig("unused"), dict, lambda s, i: s,
                         shardings={"w": None})
    assert runner.shardings == {"w": None}
    base = _port_smoke("QWEN3_4B")
    with pytest.raises(ValueError, match="remat"):
        TransformerLM(dataclasses.replace(base, remat="some"), device="cpu")
    model = TransformerLM(dataclasses.replace(base, max_seq_len=4096),
                          device="cpu")
    logits, _ = model(np.zeros((1, 2048), np.int32))
    assert tuple(logits.shape) == (1, 2048, base.vocab)
    last, cache = model.prefill(np.zeros((1, 8), np.int32))
    assert tuple(cache["k"].shape) == (base.n_layers, 1, 8,
                                       base.n_kv_heads, base.head_dim)
    cache = {"k": torch.cat([cache["k"], torch.zeros_like(cache["k"])], 2),
             "v": torch.cat([cache["v"], torch.zeros_like(cache["v"])], 2),
             "length": cache["length"]}
    logits, cache = model.decode_step(cache, np.zeros((1,), np.int32))
    assert tuple(logits.shape) == tuple(last.shape) == (1, base.vocab)
    assert int(cache["length"][0]) == 9
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TransformerLM(base)


def test_moe_local_dispatch_without_context_is_global_dispatch():
    """The setting of the reference's per-shard MoE dispatch is read only
    under a sharding context (its sharded values are held in
    ``tests/test_torch_sharding.py``).  Without one a config that sets it
    builds and runs as the reference does, the MoE dispatch global: the
    same parameters from one seed and the same logits as the default
    config's, on a dense config and on an MoE one.  The registry's configs
    leave it at its default, and every LM of the registry builds."""
    tokens = np.arange(16, dtype=np.int32).reshape(2, 8)
    for name in ("QWEN3_4B", "MIXTRAL_8X22B"):
        base = dataclasses.replace(_port_smoke(name), dtype=torch.float32)
        cfg = dataclasses.replace(base, moe_local_dispatch=True)
        got = init_params(cfg, torch.Generator().manual_seed(0))
        want = init_params(base, torch.Generator().manual_seed(0))
        assert torch.equal(got["embed"], want["embed"])
        with torch.no_grad():
            got_logits = TransformerLM(cfg, got, device="cpu")(tokens)[0]
            want_logits = TransformerLM(base, want, device="cpu")(tokens)[0]
        assert torch.equal(got_logits, want_logits)
    for entry in registry.REGISTRY.values():
        if entry.family == "lm":
            TransformerLM(entry.smoke_config, device="cpu")


def test_lm_loss_is_the_mean_nll():
    rng = np.random.default_rng(6)
    logits = torch.from_numpy(rng.standard_normal((2, 5, 11)).astype(
        np.float32))
    labels = rng.integers(0, 11, (2, 5))
    loss, m = lm_loss(logits, torch.tensor(0.5), labels, aux_weight=0.1)
    want = torch.nn.functional.cross_entropy(logits.reshape(-1, 11),
                                             torch.from_numpy(labels)
                                             .reshape(-1))
    assert abs(float(m["nll"]) - float(want)) < 1e-6
    assert abs(float(loss) - float(want) - 0.05) < 1e-6
