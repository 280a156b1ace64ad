"""The port's MoE LM (llama4-scout and mixtral, the registry's smoke
configs: 4 experts, ``moe_d_ff`` 64; llama4 top-1 with a shared expert,
mixtral top-2 with a window of 16) against the JAX package's, on the CPU:
the forward, every gradient under each ``remat``, ``lm_train_step`` over
three AdamW steps, ``prefill`` and a wrapping ring-buffer ``decode_step``,
``serve`` and ``train_lm`` with a resume.

Inputs are drawn with numpy from a seed; weights are the JAX package's
``init_params``, carried over with ``lm_params_from_reference`` (and back
with ``lm_params_to_reference``).  The reference is jitted with
``xla_allow_excess_precision`` off (``tests/test_torch_moe.py`` says
why): with it on, its bf16 router product is never rounded to bf16, and
its routes follow other logits than its code writes.

Tolerances, stated before measuring:
- f32 logits of a forward within 1e-4 absolute (``tests/test_torch_lm.py``'s
  ``FORWARD_F32_ATOL``); of ``prefill``, ``decode_step`` and ``serve``
  within 1e-5 of the largest |logit| (``tests/test_torch_lm_serving.py``);
  the aux loss within 1e-5 relative;
- f32 gradients within 1e-4 of each tensor's largest |element|;
- bf16 logits and aux within 2e-2 (``BF16_TOL``), with layer 0's routes
  equal and a later layer's differing only at near ties (the forward
  test says how);
- a training step in f32: loss, aux and grad norm within 1e-5 relative
  at the first step and 1e-4 after (the parameters then differ by the
  steps' f32 rounding, largest where a near-zero gradient flips the sign
  of an update); parameters within 2 lr a step taken; bf16 losses within
  2e-2;
- ``train_lm``: a resumed run's losses equal the uninterrupted run's
  (the same f32 arithmetic on the same state), and the port's losses the
  reference's within 2e-2 (bf16 compute).
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
from repro.launch import train as jax_train
from repro.models import transformer as jtr
from repro.optim import adamw as jax_adamw

from repro_torch.configs import lm_archs
from repro_torch.convert import (adamw_state_from_reference,
                                 lm_params_from_reference,
                                 lm_params_to_reference, named_lm_params)
from repro_torch.data.tokens import TokenStreamConfig, batch_at_step
from repro_torch.launch import serve as port_serve
from repro_torch.launch.steps import (lm_cache_shape, lm_decode_step,
                                      lm_prefill_step, lm_train_step)
from repro_torch.launch.train import train_lm
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim import adamw

MOE = ("LLAMA4_SCOUT", "MIXTRAL_8X22B")
ARCH_IDS = {"LLAMA4_SCOUT": "llama4-scout-17b-a16e",
            "MIXTRAL_8X22B": "mixtral-8x22b"}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FORWARD_F32_ATOL = 1e-4
BF16 = 2e-2
jit = functools.partial(jax.jit,
                        compiler_options={"xla_allow_excess_precision":
                                          False})


def _t(x):
    return x.detach().float().numpy()


def _close_rel(got, want, rtol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    limit = rtol * max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= limit, (what, err, limit)


def _configs(name, dtype="float32", **kw):
    jdt, tdt = DTYPES[dtype]
    jcfg = dataclasses.replace(jax_archs.smoke(getattr(jax_archs, name)),
                               dtype=jdt, **kw)
    cfg = dataclasses.replace(lm_archs.smoke(getattr(lm_archs, name)),
                              dtype=tdt, **kw)
    return jcfg, cfg


def _models(name, dtype="float32", seed=0, **kw):
    jcfg, cfg = _configs(name, dtype, **kw)
    params = jax.tree.map(np.asarray,
                          jtr.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, params, TransformerLM(
        cfg, lm_params_from_reference(cfg, params), device="cpu")


# ------------------------------------------------------------- parameters
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MOE)
def test_moe_params_round_trip_bit_for_bit(name, dtype):
    """The reference's pytree to the port and back, every leaf (the
    ``shared`` sub-dict included) bit for bit; the names the port gives
    them; the AdamW moments carried the same way."""
    jcfg, cfg = _configs(name)
    jdt = DTYPES[dtype][0]
    params = jax.tree.map(lambda a: np.asarray(a.astype(jdt)),
                          jtr.init_params(jcfg, jax.random.PRNGKey(4)))
    assert ("shared" in params["layers"]["moe"]) == cfg.moe_shared_expert
    ported = lm_params_from_reference(cfg, params)
    assert ported["embed"].dtype == DTYPES[dtype][1]
    back = lm_params_to_reference(TransformerLM(cfg, ported, device="cpu"))
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in flat_back] == [p for p, _ in flat_want]
    for (path, got), (_, want) in zip(flat_back, flat_want):
        assert got.shape == want.shape, path
        np.testing.assert_array_equal(got, want.astype(np.float32),
                                      err_msg=str(path))
    named = named_lm_params(ported)
    model = TransformerLM(cfg, lm_params_from_reference(cfg, params),
                          device="cpu")
    assert set(named) == {n for n, _ in model.named_parameters()}
    assert "layers.3.moe.router" in named
    assert ("layers.0.moe.shared.w_gate" in named) == cfg.moe_shared_expert
    state = jax.tree.map(np.asarray, jax_adamw.init_state(params))
    state["m"] = params
    moments = adamw_state_from_reference(cfg, state)
    for n, t in moments["m"].items():
        assert torch.equal(t, named[n]), n


# ---------------------------------------------------------------- forward
def _router_logits(name, dtype, tokens, monkeypatch, seed=1):
    """Both forwards (the port's pallas path, the reference's xla path)
    with each layer's f32 router logits (T, E) recorded on both sides."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    jcfg, params, model = _models(name, dtype, seed=seed)
    model.cfg = dataclasses.replace(model.cfg, attention_impl="pallas")
    want_rec, got_rec = [], []

    def jax_apply(p, x, spec, **kw):
        T = x.shape[0] * x.shape[1]
        logits = (x.reshape(T, -1) @ p["router"].astype(x.dtype)).astype(
            jnp.float32)
        jax.debug.callback(lambda a: want_rec.append(np.asarray(a)), logits,
                           ordered=True)
        return jmoe.moe_apply(p, x, spec, **kw)

    def port_route(router, xt, spec):
        got_rec.append(_t(xt @ router.to(xt.dtype)))
        return route(router, xt, spec)

    route = tmoe.route
    monkeypatch.setattr(jtr, "moe_apply", jax_apply)
    monkeypatch.setattr(tmoe, "route", port_route)
    want, want_aux = jit(functools.partial(jtr.forward, jcfg))(
        params, jnp.asarray(tokens))
    logits, aux = model(tokens)
    monkeypatch.undo()
    return (jcfg, params, model), (want, want_aux, want_rec), \
        (logits, aux, got_rec)


def _top_k(logits, K):
    """Top-k sets by the probabilities, ties to the lower expert."""
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return p, np.sort(np.argsort(-p, axis=-1, kind="stable")[:, :K], 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MOE)
def test_moe_forward_matches_jax(name, dtype, monkeypatch):
    """Logits and the summed aux loss; the port's pallas path (each
    layer's window kept) against the reference's xla path.

    f32: every layer's router logits within 1e-5 of their largest, every
    route equal, the logits within 1e-4.  bf16: layer 0's router logits
    within 2e-2 of their largest and its routes equal.  Past layer 0 the
    two packages' bf16 roundings move a layer's input, so a token whose
    top-k probabilities nearly tie may take another expert.  A flip moves
    its own row's later positions (attention) and, through the capacity
    ranks, every later token of its layer, so only a first-hand flip (no
    flip at an earlier layer at or before its token) is held to be a near
    tie: the reference's probabilities of the two experts within 2e-2, at
    most a tenth of a layer's tokens.  The logits compare, within
    ``BF16_TOL``, on the tokens before the first flip; the aux and the
    loss, averages over every token, within 2e-2."""
    tokens, labels = batch_at_step(TokenStreamConfig(512, 32, 2), 0)
    (jcfg, params, model), (want, want_aux, want_rec), \
        (logits, aux, got_rec) = _router_logits(name, dtype, tokens,
                                                monkeypatch)
    cfg = model.cfg
    assert logits.dtype == cfg.dtype and aux.dtype == torch.float32
    assert 0 < float(aux.detach()) <= cfg.n_layers * cfg.moe_experts
    assert len(want_rec) == len(got_rec) == cfg.n_layers
    B, S = tokens.shape
    first = B * S                # the first token, in flat order, to flip
    for layer, (a, b) in enumerate(zip(want_rec, got_rec)):
        pa, ka = _top_k(a.astype(np.float64), cfg.moe_top_k)
        _, kb = _top_k(b.astype(np.float64), cfg.moe_top_k)
        scale = max(float(np.abs(a).max()), 1.0)
        err = float(np.abs(a - b)[:first].max()) if first else 0.0
        if dtype == "float32" or layer == 0:
            np.testing.assert_array_equal(kb, ka, err_msg=f"layer {layer}")
            assert err <= (1e-5 if dtype == "float32" else BF16) * scale, \
                (layer, err)
            continue
        flips = np.where((ka != kb).any(1))[0]
        firsthand = flips[flips <= first]
        assert len(firsthand) <= B * S // 10, (layer, firsthand)
        for t in firsthand:
            extra = np.setdiff1d(kb[t], ka[t])
            gap = float(pa[t, ka[t]].min() - pa[t, extra].max())
            assert gap <= BF16, (layer, t, gap)
        if len(flips):
            first = min(first, int(flips[0]))
    keep = np.arange(B * S).reshape(B, S) < first
    got, ref = _t(logits)[keep], np.asarray(want, np.float32)[keep]
    if dtype == "float32":
        assert keep.all()
        np.testing.assert_allclose(got, ref, rtol=0, atol=FORWARD_F32_ATOL)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    else:
        np.testing.assert_allclose(got, ref, rtol=BF16, atol=BF16)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=BF16)
    loss, metrics = model.loss_fn(tokens, labels)
    want_loss, want_m = jit(functools.partial(jtr.loss_fn, jcfg))(
        params, jnp.asarray(tokens), jnp.asarray(labels))
    tol = 1e-4 if dtype == "float32" else BF16
    assert abs(float(loss) - float(want_loss)) <= tol
    assert abs(float(metrics["nll"]) - float(want_m["nll"])) <= tol


@functools.lru_cache(maxsize=None)
def _jax_gradients(name):
    """The reference's gradients of the loss (next-token NLL plus 0.01
    aux) on one batch, f32, by parameter name; the same for every remat."""
    jcfg, params, model = _models(name, seed=2)
    tokens, labels = batch_at_step(TokenStreamConfig(jcfg.vocab, 32, 2), 1)
    want = jit(jax.grad(lambda p: jtr.loss_fn(
        jcfg, p, jnp.asarray(tokens), jnp.asarray(labels))[0]))(params)
    return named_lm_params(lm_params_from_reference(
        model.cfg, jax.tree.map(np.asarray, want)))


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("name", MOE)
def test_moe_gradients_match_jax(name, remat):
    """Every gradient of the loss, f32; recomputing a layer routes as its
    first pass did."""
    jcfg, params, model = _models(name, seed=2)
    model.cfg = dataclasses.replace(model.cfg, attention_impl="pallas",
                                    remat=remat)
    tokens, labels = batch_at_step(TokenStreamConfig(jcfg.vocab, 32, 2), 1)
    want = _jax_gradients(name)
    loss, _ = model.loss_fn(tokens, labels)
    loss.backward()
    for n, p in model.named_parameters():
        assert p.grad is not None, n
        _close_rel(_t(p.grad), want[n].numpy(), 1e-4, n)


# ----------------------------------------------------------- train steps
def _train_both(name, n_micro, dtype="float32", steps=3, batch=4, seq=32):
    """``steps`` AdamW steps of both packages from one state, each on
    ``batch_at_step(stream, step)``; returns both packages' metrics, the
    reference's last params and the port's model and state."""
    jcfg, params, model = _models(name, dtype, seed=3,
                                  n_microbatches=n_micro)
    model.cfg = dataclasses.replace(model.cfg, attention_impl="pallas")
    opt = jax_adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    jstate = jax_adamw.init_state(params)
    state = adamw_state_from_reference(model.cfg,
                                       jax.tree.map(np.asarray, jstate))
    opt_port = adamw.AdamWConfig(**dataclasses.asdict(opt))
    step = jit(lambda p, o, t, l: jax_steps.lm_train_step(
        jcfg, opt, p, o, t, l))
    stream = TokenStreamConfig(jcfg.vocab, seq, batch)
    jp = jax.tree.map(jnp.asarray, params)
    jm_all, pm_all = [], []
    for i in range(steps):
        tokens, labels = batch_at_step(stream, i)
        jp, jstate, jm = step(jp, jstate, jnp.asarray(tokens),
                              jnp.asarray(labels))
        jm_all.append({k: float(v) for k, v in jm.items()})
        pm = lm_train_step(model, opt_port, state, tokens, labels)
        pm_all.append({k: float(v) for k, v in pm.items()})
    return jm_all, pm_all, jp, jstate, model, state, opt.lr


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("name", MOE)
def test_moe_lm_train_step_matches_jax(name, n_micro):
    """Three steps in f32; with 2 microbatches each microbatch's tokens
    set its own capacity, as in the reference's scan."""
    jm, pm, jp, js, model, state, lr = _train_both(name, n_micro)
    for i, (w, g) in enumerate(zip(jm, pm)):
        rtol = 1e-5 if i == 0 else 1e-4
        for key in ("loss", "nll", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(g[key], w[key], rtol=rtol,
                                       err_msg=f"step {i} {key}")
        assert g["aux"] > 0
    assert int(state["step"]) == int(js["step"]) == 3
    want = named_lm_params(lm_params_from_reference(
        model.cfg, jax.tree.map(np.asarray, jp)))
    for n, p in model.named_parameters():
        assert float((p.detach() - want[n]).abs().max()) <= 2 * lr * 3, n


@pytest.mark.parametrize("name", MOE)
def test_moe_lm_train_step_bf16_matches_jax(name):
    jm, pm, jp, _, model, _, lr = _train_both(name, 2, "bfloat16")
    for i, (w, g) in enumerate(zip(jm, pm)):
        for key in ("loss", "aux"):
            np.testing.assert_allclose(g[key], w[key], rtol=BF16, atol=BF16,
                                       err_msg=f"step {i} {key}")
    want = named_lm_params(lm_params_from_reference(
        model.cfg, jax.tree.map(np.asarray, jp)))
    for n, p in model.named_parameters():
        assert float((p.detach() - want[n]).abs().max()) <= 2 * lr * 3, n


# ---------------------------------------------------------------- serving
def _grow_reference(cache, n_slots):
    pad = n_slots - cache["k"].shape[2]
    widths = ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0))
    return {"k": jnp.pad(cache["k"], widths),
            "v": jnp.pad(cache["v"], widths), "length": cache["length"]}


# arch -> (prompt length, decode steps, config changes): each ring of
# lm_cache_shape's slots wraps at least twice
RING_CASES = {"LLAMA4_SCOUT": (5, 14, {"sliding_window": 8}),
              "MIXTRAL_8X22B": (6, 30, {})}


@pytest.mark.parametrize("name", MOE)
def test_moe_prefill_and_ring_decode_match_jax(name):
    """``prefill`` routes the whole prompt at once; each ``decode_step``
    routes the batch's B tokens (capacity ceil(B K / E · 1.25): llama4's
    two tokens share one slot an expert, so one drops where both pick the
    same expert)."""
    S, steps, kw = RING_CASES[name]
    jcfg, params, model = _models(name, seed=4, **kw)
    B = 2
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    feed = rng.integers(0, jcfg.vocab, (steps, B)).astype(np.int32)
    want_logits, want_cache = jit(functools.partial(
        jax_steps.lm_prefill_step, jcfg))(params, tokens)
    logits, cache = lm_prefill_step(model, tokens)
    _close_rel(logits.numpy(), want_logits, 1e-5, "prefill")
    slots = lm_cache_shape(model.cfg, B, S + steps)[2]
    assert slots == jax_steps.lm_cache_shape(jcfg, B, S + steps)[2]
    assert S + steps > 2 * slots
    want_cache = _grow_reference(want_cache, slots)
    cache = port_serve.grow_cache(cache, slots)
    decode = jit(functools.partial(jax_steps.lm_decode_step, jcfg))
    for i in range(steps):
        want_logits, want_cache = decode(params, want_cache, feed[i])
        logits, cache = lm_decode_step(model, cache,
                                       torch.from_numpy(feed[i]))
        _close_rel(logits.numpy(), want_logits, 1e-5, f"decode {i}")
        _close_rel(cache["k"].numpy(), want_cache["k"], 1e-5, f"k {i}")
        _close_rel(cache["v"].numpy(), want_cache["v"], 1e-5, f"v {i}")
    assert int(cache["length"][0]) == S + steps


@pytest.mark.parametrize("name", MOE)
def test_moe_serve_matches_the_reference_step_by_step(name, monkeypatch):
    """``serve`` (f32) against the reference's ``serve`` (its generated
    tokens) and its prefill, cache growth and decode loop fed those tokens
    (its logits)."""
    arch = ARCH_IDS[name]
    jcfg, params, model = _models(name, seed=0)
    entry = jax_registry.get(arch)
    monkeypatch.setitem(jax_registry.REGISTRY, arch,
                        dataclasses.replace(entry, smoke_config=jcfg))
    monkeypatch.setattr(jax, "jit", jit)
    batch, prompt_len, gen = 2, 12, 6
    want = jax_serve.serve(arch, True, batch, prompt_len, gen, seed=0)
    got = port_serve.serve(arch, True, batch, prompt_len, gen, seed=0,
                           model=model)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    prompts = np.random.default_rng(0).integers(
        0, jcfg.vocab, (batch, prompt_len)).astype(np.int32)
    logits, cache = jit(functools.partial(jtr.prefill, jcfg))(params,
                                                               prompts)
    cache = _grow_reference(cache, prompt_len + gen)
    _close_rel(got["logits"][0].numpy(), logits, 1e-5, "prefill")
    decode = jit(functools.partial(jtr.decode_step, jcfg))
    for i in range(gen):
        logits, cache = decode(params, cache,
                               jnp.asarray(want["generated"][:, i]))
        _close_rel(got["logits"][i + 1].numpy(), logits, 1e-5, f"step {i}")


@pytest.mark.parametrize("name", MOE)
def test_moe_train_lm_resumes_and_matches_jax(name, tmp_path, monkeypatch):
    """``train_lm`` on the smoke config (bf16 compute, f32 parameters):
    4 steps with checkpoints, then a resume to 7, equal to an
    uninterrupted run of 7; the uninterrupted losses against the
    reference's ``train_lm``."""
    arch = ARCH_IDS[name]
    d = str(tmp_path / "ck")
    kw = dict(batch=2, seq_len=16, log_every=100, device="cpu")
    train_lm(arch, True, 4, d, ckpt_every=2, **kw)
    resumed = train_lm(arch, True, 7, d, ckpt_every=2, **kw)
    full = train_lm(arch, True, 7, "", **kw)
    assert len(resumed) == 7 - 4
    assert resumed == full[4:]
    monkeypatch.setattr(jax, "jit", jit)
    want = jax_train.train_lm(arch, True, 7, "", batch=2, seq_len=16,
                              log_every=100)
    np.testing.assert_allclose(full, want, rtol=BF16, atol=BF16)
