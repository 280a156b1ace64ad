"""Port tests that need the card: the CUDA ``dht_gather`` kernel and the
engine on CUDA, each held against the port's own CPU path (exact).

This file imports no JAX, so it also runs on a machine with a card and no
JAX:  ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Elsewhere every test skips (a CUDA kernel has no CPU mode).
"""
import numpy as np
import pytest
import torch

from repro_torch.ampc import AmpcEngine
from repro_torch.ampc.engine import _field_eq
from repro_torch.graph import generators as gen
from repro_torch.kernels.dht_gather import ops
from repro_torch.kernels.dht_gather.ref import dht_gather_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("D,dtype", [(1, torch.int32), (64, torch.float32),
                                     (128, torch.bfloat16), (3, torch.int32)])
def test_kernel_matches_plain_version(card, D, dtype):
    V, Q = 5000, 20000
    rng = np.random.default_rng(0)
    table = torch.randn(V, D, device=card).to(dtype)
    keys = rng.integers(-3, V + 5, size=Q).astype(np.int32)
    keys[::7] = -1
    keys = torch.from_numpy(keys).to(card)
    before = ops.dht_gather.launches
    out, hits = ops.dht_gather(table, keys)
    assert ops.dht_gather.launches == before + 1
    sk, order = torch.sort(keys, stable=True)
    ref_out, ref_hits = dht_gather_ref(table, sk)
    expect = torch.empty_like(ref_out)
    expect[order] = ref_out
    assert torch.equal(out, expect) and int(hits) == int(ref_hits)


def test_kernel_empty_batch_launches_nothing(card):
    table = torch.zeros(10, 1, dtype=torch.int32, device=card)
    before = ops.dht_gather.launches
    out, hits = ops.dht_gather(table, torch.zeros(0, dtype=torch.int32,
                                                  device=card))
    assert out.shape == (0, 1) and int(hits) == 0
    assert ops.dht_gather.launches == before


@pytest.mark.parametrize("problem", ["mis", "connectivity", "msf"])
def test_cuda_solve_equals_cpu_solve(card, problem):
    g = gen.rmat(10, 8.0, seed=1)
    if problem == "msf":
        g = g.with_random_weights(2)
    want = AmpcEngine(seed=0, device="cpu").solve(g, problem)
    before = ops.dht_gather.launches
    got = AmpcEngine(seed=0).solve(g, problem)
    assert ops.dht_gather.launches - before == \
        (2 if problem == "connectivity" else 0)
    np.testing.assert_array_equal(got.output, want.output)
    assert _field_eq(got.stats, want.stats)
    for key in got.ledger:
        if key not in ("wall_time_s", "phase_times"):
            assert got.ledger[key] == want.ledger[key], key


# ------------------------------------------------------------ flash attention
# kernel against its plain version on the same inputs, element by element:
# |got - want| <= atol + rtol |want|.  Both sum in f32 (the kernel by online
# softmax over 64-key tiles, the plain version over whole rows) and round
# once to the output type.  f32 agrees to 1e-5; a bf16 element may land one
# ulp of its own away, at most 2^-7 of it, and the 1e-3 covers the f32
# sums' difference near 0.
FLASH_TOL = {torch.float32: dict(rtol=0.0, atol=1e-5),
             torch.bfloat16: dict(rtol=2 ** -7, atol=1e-3)}


@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,K,H,Hkv,causal,window", [
    (2, 256, 256, 4, 2, True, 0),       # GQA, causal
    (1, 256, 256, 4, 4, True, 64),      # sliding window
    (1, 128, 384, 8, 8, True, 0),       # K > S: q_offset = K - S
    (1, 128, 384, 8, 2, True, 100),     # K > S with a window
    (2, 200, 200, 4, 2, True, 0),       # ragged S = K (not a tile multiple)
    (1, 77, 300, 4, 1, True, 37),       # ragged S and K, window
    (1, 192, 160, 4, 2, False, 0),      # not causal, K < S
    (1, 130, 130, 2, 1, False, 50),     # not causal, window
])
def test_flash_kernel_matches_plain_version(card, D, dtype, B, S, K, H, Hkv,
                                            causal, window):
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator(device=card).manual_seed(D + S + K)
    q = torch.randn(B, S, H, D, device=card, generator=g).to(dtype)
    k = torch.randn(B, K, Hkv, D, device=card, generator=g).to(dtype)
    v = torch.randn(B, K, Hkv, D, device=card, generator=g).to(dtype)
    before = fops.flash_attention.launches
    got = fops.flash_attention(q, k, v, causal=causal, window=window)
    assert fops.flash_attention.launches == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


def test_flash_kernel_takes_strided_inputs(card):
    """q, k, v as views with a unit-stride last axis (heads sliced out of a
    wider tensor) give the same output as their contiguous copies."""
    from repro_torch.kernels.flash_attention import ops as fops
    g = torch.Generator(device=card).manual_seed(5)
    big = torch.randn(2, 256, 12, 64, device=card, generator=g)
    q, k, v = big[:, :, :8], big[:, :, 8:10], big[:, :, 10:12]
    got = fops.flash_attention(q, k, v, causal=True, window=0)
    want = fops.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True, window=0)
    assert torch.equal(got, want)


def test_flash_kernel_refuses_grad_and_bad_shapes(card):
    """A CUDA input that requires grad goes through the backward kernels
    (one launch each); a head width the kernels do not take raises."""
    from repro_torch.kernels.flash_attention import bwd, ops as fops
    q = torch.randn(1, 64, 2, 64, device=card, requires_grad=True)
    k = torch.randn(1, 64, 2, 64, device=card)
    counts = (fops.flash_attention.launches, bwd.flash_bwd_dq.launches,
              bwd.flash_bwd_dkv.launches)
    out = fops.flash_attention(q, k, k)
    (dq,) = torch.autograd.grad(out.sum(), (q,))
    assert (fops.flash_attention.launches, bwd.flash_bwd_dq.launches,
            bwd.flash_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    assert dq.shape == q.shape and bool(torch.isfinite(dq).all())
    with pytest.raises(ValueError, match="head width"):
        fops.flash_attention(torch.randn(1, 64, 2, 48, device=card),
                             torch.randn(1, 64, 2, 48, device=card),
                             torch.randn(1, 64, 2, 48, device=card))


def test_flash_kernel_counts_only_launches(card):
    """An empty q launches nothing and is not counted; a second card (where
    there is one) takes the kernel as the first does."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    before = fops.flash_attention.launches
    empty = torch.zeros(1, 0, 4, 128, device=card)
    k = torch.zeros(1, 16, 2, 128, device=card)
    assert fops.flash_attention(empty, k, k).shape == (1, 0, 4, 128)
    assert fops.flash_attention.launches == before
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        g = torch.Generator(device=dev).manual_seed(i)
        q, k, v = (torch.randn(1, 96, 4, 256, device=dev, generator=g)
                   for _ in range(3))
        got = fops.flash_attention(q, k, v, causal=True, window=40)
        assert got.device == dev
        torch.testing.assert_close(
            got, attention_ref(q, k, v, causal=True, window=40),
            **FLASH_TOL[torch.float32])
    assert fops.flash_attention.launches == before + \
        torch.cuda.device_count()


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("B,S,K,H,Hkv,causal,window", [
    (2, 256, 256, 4, 2, True, 0),
    (1, 256, 256, 4, 4, True, 64),
    (1, 128, 384, 8, 2, True, 100),
    (2, 200, 200, 4, 2, True, 0),
    (1, 77, 300, 4, 1, True, 37),
    (1, 192, 160, 4, 2, False, 0),
    (1, 130, 130, 2, 1, False, 50),
])
def test_flash_wgmma_route_is_counted_and_bit_stable(card, D, B, S, K, H,
                                                      Hkv, causal, window):
    """bf16 at D 64, 128 and 256 takes the wgmma kernel: one count on that
    route a call and none on the SIMT route, two calls equal bit for bit,
    and within the bf16 limit of ``ref.attention_split_p_ref``, the plain
    mirror of its split-P arithmetic."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_split_p_ref
    g = torch.Generator(device=card).manual_seed(D + S + K + 1)
    q = torch.randn(B, S, H, D, device=card, generator=g).to(torch.bfloat16)
    k = torch.randn(B, K, Hkv, D, device=card, generator=g).to(torch.bfloat16)
    v = torch.randn(B, K, Hkv, D, device=card, generator=g).to(torch.bfloat16)
    before = dict(fops.flash_attention.launches_by_route)
    runs = [fops.flash_attention(q, k, v, causal=causal, window=window)
            for _ in range(2)]
    assert fops.flash_attention.launches_by_route == {
        "wgmma": before["wgmma"] + 2, "simt": before["simt"]}
    want = attention_split_p_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    torch.testing.assert_close(runs[0].float(), want.float(),
                               **FLASH_TOL[torch.bfloat16])


def test_flash_routes_split_by_type_and_width(card):
    """f32 at any head width and bf16 at 16 or 32 take the SIMT kernel;
    bf16 heads sliced out of a wider tensor take the wgmma kernel and equal
    their contiguous copies bit for bit; a layout TMA cannot take raises
    before any launch."""
    from repro_torch.kernels.flash_attention import ops as fops
    g = torch.Generator(device=card).manual_seed(7)
    for dtype, D in ((torch.float32, 64), (torch.float32, 128),
                     (torch.float32, 256), (torch.bfloat16, 16),
                     (torch.bfloat16, 32)):
        q = torch.randn(1, 96, 4, D, device=card, generator=g).to(dtype)
        before = dict(fops.flash_attention.launches_by_route)
        fops.flash_attention(q, q[:, :, :2], q[:, :, 2:])
        assert fops.flash_attention.launches_by_route == {
            "wgmma": before["wgmma"], "simt": before["simt"] + 1}
    big = torch.randn(2, 256, 12, 128, device=card,
                      generator=g).to(torch.bfloat16)
    q, k, v = big[:, :, :8], big[:, :, 8:10], big[:, :, 10:12]
    before = dict(fops.flash_attention.launches_by_route)
    got = fops.flash_attention(q, k, v, causal=True, window=0)
    want = fops.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True, window=0)
    assert fops.flash_attention.launches_by_route == {
        "wgmma": before["wgmma"] + 2, "simt": before["simt"]}
    assert torch.equal(got, want)
    padded = torch.randn(1, 64, 4 * 64 + 4, device=card).to(torch.bfloat16)
    q = padded[..., :256].unflatten(-1, (4, 64))
    launches = fops.flash_attention.launches
    with pytest.raises(ValueError, match="TMA"):
        fops.flash_attention(q, q[:, :, :2], q[:, :, 2:])
    assert fops.flash_attention.launches == launches


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma3-12b"])
def test_cuda_lm_forward_equals_cpu_forward(card, arch):
    """The smoke config's f32 forward through the kernel on the card equals
    the same forward through the plain version on the CPU (1e-4: the
    matmuls and the softmax sum in other orders on the two devices)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.data.tokens import TokenStreamConfig, batch_at_step
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models.transformer import TransformerLM, init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(registry.get(arch).smoke_config,
                              dtype=torch.float32, attention_impl="pallas")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tokens, labels = batch_at_step(TokenStreamConfig(cfg.vocab, 64, 2), 0)
    want, _ = TransformerLM(cfg, params, device="cpu").loss_fn(tokens,
                                                              labels)
    model = TransformerLM(cfg, params, device=card)
    before = fops.flash_attention.launches
    logits, aux = model(tokens)
    assert fops.flash_attention.launches - before == cfg.n_layers
    ref_logits, _ = TransformerLM(cfg, params, device="cpu")(tokens)
    err = (logits.cpu() - ref_logits).abs().max().item()
    assert err <= 1e-4, err
    got, _ = model.loss_fn(tokens, labels)
    assert abs(got.item() - want.item()) <= 1e-4


# ------------------------------------------------- flash attention backward
# the backward kernels against their plain version (ref.attention_bwd_ref)
# on the same q, k, v, o, lse and do, element by element within
# ref.grad_limit: one ulp of each bf16 element's own size or 2^-14 of an f32
# one, above a floor of 2 n 2^-24 for a sum of n terms (dq: K keys; dk, dv:
# G * S query rows; the forward kernel's lse: K keys)
BWD_CASES = [
    (2, 256, 256, 4, 2, True, 0),       # GQA, causal
    (1, 256, 256, 4, 4, True, 64),      # sliding window
    (1, 128, 384, 8, 2, True, 100),     # K > S with a window
    (2, 200, 200, 4, 2, True, 0),       # ragged S = K
    (1, 77, 300, 4, 1, True, 37),       # ragged S and K, window
    (1, 192, 160, 4, 2, False, 0),      # not causal, K < S
    (1, 130, 130, 2, 1, False, 50),     # not causal, window
]


def _bwd_inputs(card, B, S, K, H, Hkv, D, dtype, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn(*shape, device=card, generator=g).to(dtype)
            for shape in ((B, S, H, D), (B, K, Hkv, D), (B, K, Hkv, D),
                          (B, S, H, D))]


def _assert_within(got, want, n, what):
    from repro_torch.kernels.flash_attention.ref import grad_limit
    assert got.dtype == want.dtype and got.shape == want.shape, what
    over = ((got.float() - want.float()).abs() / grad_limit(want, n)).max()
    assert float(over) <= 1.0, f"{what}: {float(over)} times its limit"


@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,K,H,Hkv,causal,window", BWD_CASES)
def test_flash_bwd_kernels_match_plain_version(card, D, dtype, B, S, K, H,
                                               Hkv, causal, window):
    """dq and dk/dv within their limits, the forward kernel's lse within
    its own, each kernel launched once a call, and a second run equal to
    the first bit for bit (no atomics)."""
    from repro_torch.kernels.flash_attention import bwd, kernel
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_ref, attention_fwd_lse_ref)
    q, k, v, do = _bwd_inputs(card, B, S, K, H, Hkv, D, dtype, D + S + K)
    o, lse = attention_fwd_lse_ref(q, k, v, causal, window)
    _, lse_kernel = kernel.flash_attention_cuda(q, k, v, causal, window,
                                                with_lse=True)
    _assert_within(lse_kernel, lse, K, "lse")
    delta = bwd.row_delta(o, do)
    before = (bwd.flash_bwd_dq.launches, bwd.flash_bwd_dkv.launches)
    runs = [(bwd.flash_bwd_dq(q, k, v, do, lse, delta, causal, window),
             *bwd.flash_bwd_dkv(q, k, v, do, lse, delta, causal, window))
            for _ in range(2)]
    assert (bwd.flash_bwd_dq.launches, bwd.flash_bwd_dkv.launches) == \
        (before[0] + 2, before[1] + 2)
    want = attention_bwd_ref(q, k, v, o, lse, do, causal, window)
    torch.cuda.synchronize()
    G = H // Hkv
    for name, got, ref, n in zip(("dq", "dk", "dv"), runs[0], want,
                                 (K, G * S, G * S)):
        _assert_within(got, ref, n, name)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_flash_bwd_kernels_take_strided_inputs(card):
    """q, k, v and do as views with a unit-stride last axis give the
    gradients of their contiguous copies, bit for bit."""
    from repro_torch.kernels.flash_attention import bwd
    from repro_torch.kernels.flash_attention.ref import attention_fwd_lse_ref
    g = torch.Generator(device=card).manual_seed(6)
    big = torch.randn(2, 256, 20, 64, device=card, generator=g)
    q, k, v, do = big[:, :, :8], big[:, :, 8:10], big[:, :, 10:12], \
        big[:, :, 12:]
    o, lse = attention_fwd_lse_ref(q, k, v, True, 0)
    delta = bwd.row_delta(o, do)
    views = (bwd.flash_bwd_dq(q, k, v, do, lse, delta),
             *bwd.flash_bwd_dkv(q, k, v, do, lse, delta))
    c = [t.contiguous() for t in (q, k, v, do)]
    copies = (bwd.flash_bwd_dq(*c, lse, delta),
              *bwd.flash_bwd_dkv(*c, lse, delta))
    assert all(torch.equal(a, b) for a, b in zip(views, copies))


def test_flash_function_grads_on_card_equal_cpu_grads(card):
    """autograd through ``ops.flash_attention`` on the card (the three
    kernels) against the same Function on the CPU (the plain versions), in
    f32, within the kernels' limits: the card's o and lse come from the
    forward kernel and differ from the plain ones by f32 rounding only."""
    from repro_torch.kernels.flash_attention import ops as fops
    B, S, K, H, Hkv, D, window = 1, 160, 224, 8, 2, 64, 48
    q, k, v, do = _bwd_inputs(card, B, S, K, H, Hkv, D, torch.float32, 11)
    grads = {}
    for dev in (card, torch.device("cpu")):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        out = fops.flash_attention(*leaves, causal=True, window=window)
        grads[dev.type] = torch.autograd.grad(out, leaves, do.to(dev))
    for name, got, ref, n in zip(("dq", "dk", "dv"), grads["cuda"],
                                 grads["cpu"], (K, 4 * S, 4 * S)):
        _assert_within(got.cpu(), ref, n, name)


@pytest.mark.parametrize("n_micro,remat", [(1, "none"), (2, "full"),
                                           (2, "dots")])
def test_cuda_lm_train_step_equals_cpu_step(card, n_micro, remat):
    """One f32 ``lm_train_step`` of the qwen3-4b smoke config on the card
    (the kernels) equals the same step on the CPU (the plain versions):
    loss and grad norm within 1e-4 relative, every parameter within 2 lr
    (one AdamW step moves an element by at most lr per unit of
    m̂ / sqrt(v̂), whose sign a near-zero gradient may flip), the
    launch counts those of the layers."""
    import copy
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.data.tokens import TokenStreamConfig, batch_at_step
    from repro_torch.kernels.flash_attention import bwd, ops as fops
    from repro_torch.launch.steps import lm_train_step
    from repro_torch.models.transformer import TransformerLM, init_params
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(registry.get("qwen3-4b").smoke_config,
                              dtype=torch.float32, attention_impl="pallas",
                              n_microbatches=n_micro, remat=remat)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tokens, labels = batch_at_step(TokenStreamConfig(cfg.vocab, 64, 2), 0)
    out = {}
    for dev in ("cpu", card):
        # the model trains its given tensors in place: each gets a copy
        model = TransformerLM(cfg, copy.deepcopy(params), device=dev)
        state = adamw.init_state(model, opt_cfg)
        counts = (fops.flash_attention.launches, bwd.flash_bwd_dq.launches,
                  bwd.flash_bwd_dkv.launches)
        metrics = lm_train_step(model, opt_cfg, state, tokens, labels)
        launched = (fops.flash_attention.launches - counts[0],
                    bwd.flash_bwd_dq.launches - counts[1],
                    bwd.flash_bwd_dkv.launches - counts[2])
        out[str(dev)] = (model, metrics, launched)
    cpu, gpu = out["cpu"], out[str(card)]
    L = cfg.n_layers
    assert cpu[2] == (0, 0, 0)
    assert gpu[2] == ((2 if remat != "none" else 1) * L * n_micro,
                      L * n_micro, L * n_micro)
    for key in ("loss", "grad_norm"):
        a, b = float(gpu[1][key]), float(cpu[1][key])
        assert abs(a - b) <= 1e-4 * abs(b), (key, a, b)
    for (name, p), (_, p_cpu) in zip(gpu[0].named_parameters(),
                                     cpu[0].named_parameters()):
        err = float((p.detach().cpu() - p_cpu.detach()).abs().max())
        assert err <= 2 * opt_cfg.lr, (name, err)


# ------------------------------------------------------------ segment_matmul
# kernel against its plain version on the same inputs: the f32 neighbour
# sums are equal bit for bit (both add the valid slots in order from 0),
# and the outputs within ``ref.product_limit`` (the D-term product in two
# f32 orders, and for bf16 one unit of the final rounding).  Cases: (M rows
# of nbr, N rows of x, K, D, F, layout).
SEG_CASES = [
    (169984, 169984, 15, 602, 64, "block"),   # GIN layer 1, minibatch_lg
    (169984, 169984, 15, 64, 64, "block"),    # GIN layers 2-5
    (1001, 1001, 7, 37, 24, "random"),        # ragged M, D 37
    (96, 96, 6, 70, 16, "empty_rows"),        # rows without a neighbour
    (40, 40, 1, 16, 8, "random"),             # K 1
    (64, 64, 3, 20, 130, "random"),           # F past one CTA's 64
    (50, 21, 4, 9, 8, "out_of_range"),        # M != N, clipped indices
    (70, 70, 300, 12, 8, "random"),           # K 300: over 48 KB of smem
    (33, 33, 0, 12, 8, "random"),             # K 0: no slot at all
]


def _seg_inputs(card, M, N, K, D, F, layout, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    w = (rng.standard_normal((D, F)) / np.sqrt(max(D, 1))).astype(np.float32)
    nbr = rng.integers(-1, N, (M, K)).astype(np.int32)
    if layout == "block":       # 1024 seeds with K slots, then K' = 10
        nbr[:] = -1
        hop1 = 1024 * K
        nbr[:1024] = (1024 + np.arange(hop1)).reshape(1024, K)
        nbr[1024:1024 + hop1, :10] = (1024 + hop1 + np.arange(
            hop1 * 10)).reshape(hop1, 10)
    elif layout == "empty_rows":
        nbr[::3] = -1
    elif layout == "out_of_range":
        nbr = rng.integers(-1, N + 5, (M, K)).astype(np.int32)
    return (torch.from_numpy(x).to(card).to(dtype),
            torch.from_numpy(nbr).to(card),
            torch.from_numpy(w).to(card).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,N,K,D,F,layout", SEG_CASES)
def test_segment_matmul_kernel_matches_plain_version(card, monkeypatch, M, N,
                                                     K, D, F, layout, dtype):
    from repro_torch.kernels.segment_matmul import kernel as skernel
    from repro_torch.kernels.segment_matmul import ops as sops
    from repro_torch.kernels.segment_matmul.ref import (neighbor_sum,
                                                        product_limit,
                                                        segment_matmul_ref)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    x, nbr, w = _seg_inputs(card, M, N, K, D, F, layout, dtype)
    before = sops.segment_matmul.launches
    out = sops.segment_matmul(x, nbr, w)
    again = sops.segment_matmul(x, nbr, w)
    assert sops.segment_matmul.launches == before + 2
    out_agg, agg = skernel.segment_matmul_cuda(x, nbr, w, with_agg=True)
    torch.cuda.synchronize()
    assert out.dtype == dtype and tuple(out.shape) == (M, F)
    assert torch.equal(out, again) and torch.equal(out, out_agg)
    want_agg = neighbor_sum(x, nbr)
    assert torch.equal(agg, want_agg)
    want = segment_matmul_ref(x, nbr, w)
    limit = product_limit(want_agg, w, dtype)
    assert bool(((out.float() - want.float()).abs() <= limit).all())


def test_segment_matmul_kernel_refuses_what_it_does_not_take(card):
    from repro_torch.kernels.segment_matmul import kernel as skernel
    from repro_torch.kernels.segment_matmul import ops as sops
    x, nbr, w = _seg_inputs(card, 16, 16, 3, 8, 4, "random", torch.float32)
    with pytest.raises(ValueError, match="bf16"):
        sops.segment_matmul(x, nbr, w.bfloat16())
    with pytest.raises(ValueError, match="int32"):
        sops.segment_matmul(x, nbr.long(), w)
    with pytest.raises(ValueError, match="slots"):
        skernel.segment_matmul_cuda(
            x, torch.zeros(16, skernel.MAX_K + 1, dtype=torch.int32,
                           device=card), w)
    with pytest.raises(ValueError, match="same device"):
        sops.segment_matmul(x, nbr.cpu(), w)
    before = sops.segment_matmul.launches
    empty = sops.segment_matmul(x, nbr[:0], w)
    assert empty.shape == (0, 4) and sops.segment_matmul.launches == before


def test_segment_matmul_function_grads_match_the_plain_version(card,
                                                              monkeypatch):
    """The Function's gradients (kernel forward with ``agg``, dW by
    ``torch.matmul``, dx by ``index_add_``) against autograd through the
    plain version on the card: within 1e-5 of each element plus 1e-5 of
    the tensor's largest |value| (dx's atomics and the plain version's
    scatter add in orders that vary)."""
    from repro_torch.kernels.segment_matmul import ops as sops
    from repro_torch.kernels.segment_matmul.ref import segment_matmul_ref
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for case in SEG_CASES[1:4]:
        x, nbr, w = _seg_inputs(card, *case, torch.float32, seed=1)
        dout = torch.randn(case[0], case[4], device=card,
                           generator=torch.Generator(card).manual_seed(2))
        grads = []
        for fn in (sops.segment_matmul, segment_matmul_ref):
            xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
            grads.append(torch.autograd.grad(fn(xa, nbr, wa), (xa, wa),
                                             dout))
        for got, want in zip(*grads):
            scale = float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=1e-5,
                                       atol=1e-5 * scale)


# card against CPU, f32 with TF32 off, relative to the largest logit: the
# bound chip_smoke.py's GNN_RTOL states for the gin-tu forward
GNN_RTOL = 1e-4


def test_cuda_gnn_train_step_equals_cpu_step(card, monkeypatch):
    """One f32 ``gnn_train_step`` of the gin-tu smoke config on a sampled
    block, on the card (the kernel, 5 launches) and on the CPU (the plain
    version): grad norm within 1e-4 relative, every parameter within
    2 lr.  Two card forwards give equal bits (no atomics on the path: the
    readout is a one-hot product there).  The card's logits are within
    GNN_RTOL of the CPU's largest logit: the two sum the same terms in
    other orders, each layer's D-term product within 2 D 2^-24 of its sum
    of |terms|, carried through 5 layers and the readout's sum over the
    block's nodes; the loss, the gap between two logits at this
    initialization, within twice that (logsumexp and the gold logit each
    move by at most the largest logit's error).  Both are the bounds
    ``chip_smoke.py`` states for this forward."""
    import copy
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.data import graphs
    from repro_torch.kernels.segment_matmul import ops as sops
    from repro_torch.launch.steps import gnn_forward_step, gnn_train_step
    from repro_torch.models.gnn.gin import GIN, init_params
    from repro_torch.optim import adamw
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = registry.get("gin-tu").smoke_config
    g = gen.rmat(10, 10.0, seed=0)
    feat = np.random.default_rng(0).standard_normal(
        (g.n, cfg.d_feat)).astype(np.float32)
    seeds = np.random.default_rng(1).integers(0, g.n, 64)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    out = {}
    label = None
    for dev in ("cpu", card):
        sampler = graphs.NeighborSampler(g, (15, 10), seed=1, device=dev)
        block = sampler.sample_block(seeds, torch.from_numpy(feat).to(dev),
                                     None)
        model = GIN(cfg, copy.deepcopy(params), device=dev)
        if label is None:
            # the smaller logit: the sum readout saturates the softmax at
            # initialization, and the other label would give no gradient
            label = int(gnn_forward_step(model, dataclasses.replace(
                block, labels=torch.zeros(1, dtype=torch.long))).argmin())
        block = dataclasses.replace(block, labels=torch.tensor(
            [label], device=dev))
        state = adamw.init_state(model, opt_cfg)
        before = sops.segment_matmul.launches
        logits = gnn_forward_step(model, block)
        again = gnn_forward_step(model, block)
        metrics = gnn_train_step(model, opt_cfg, state, block)
        out[str(dev)] = (model, metrics, logits.cpu(),
                         sops.segment_matmul.launches - before,
                         torch.equal(logits, again))
    cpu, gpu = out["cpu"], out[str(card)]
    assert cpu[3] == 0 and gpu[3] == 3 * cfg.n_layers
    assert gpu[4], "two card forwards differ"
    assert float(cpu[1]["loss"]) > 0 and float(cpu[1]["grad_norm"]) > 0
    scale = float(cpu[2].abs().max())
    # the measured difference, shown with pytest -rP
    print(f"gin-tu logits: max |card - cpu| / max |cpu| = "
          f"{float((gpu[2] - cpu[2]).abs().max()) / scale}")
    torch.testing.assert_close(gpu[2], cpu[2], rtol=0,
                               atol=GNN_RTOL * scale)
    a, b = float(gpu[1]["loss"]), float(cpu[1]["loss"])
    assert abs(a - b) <= 2 * GNN_RTOL * scale, ("loss", a, b)
    a, b = float(gpu[1]["grad_norm"]), float(cpu[1]["grad_norm"])
    assert abs(a - b) <= 1e-4 * abs(b), ("grad_norm", a, b)
    lr = float(cpu[1]["lr"])
    for (name, p), (_, q) in zip(gpu[0].named_parameters(),
                                 cpu[0].named_parameters()):
        assert float((p.detach().cpu() - q.detach()).abs().max()) <= 2 * lr, \
            name


# -------------------------------------------------------------- embedding_bag
# the kernel sums each bag's rows in f32 in slot order and rounds once, as
# its plain version does: equal bit for bit.  (V, D, B, L): the JAX
# package's test shapes, D 37, L 0 and 1, a ragged B, L past the kernel's
# 128-id staging chunk, SASRec's table width with a ragged B
EMBAG_CASES = [(64, 16, 16, 4), (256, 32, 32, 10), (1024, 64, 8, 50),
               (300, 37, 13, 7), (50, 8, 5, 0), (50, 8, 5, 1),
               (500, 130, 3, 300), (20000, 50, 1001, 50)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V,D,B,L", EMBAG_CASES)
def test_embedding_bag_kernel_matches_plain_version(card, V, D, B, L, dtype):
    """Ids over [-3, V + 5): padding (0, negative) and ids past the table."""
    from repro_torch.kernels.embedding_bag import ops as eops
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    rng = np.random.default_rng(7)
    table = torch.from_numpy(rng.standard_normal((V, D)).astype(
        np.float32)).to(card).to(dtype)
    ids = rng.integers(-3, V + 5, (B, L)).astype(np.int32)
    if L:
        ids[:, -1] = 0
    ids = torch.from_numpy(ids).to(card)
    before = eops.embedding_bag.launches
    got = eops.embedding_bag(table, ids)
    again = eops.embedding_bag(table, ids)
    assert eops.embedding_bag.launches == before + 2
    want = embedding_bag_ref(table, ids)
    assert got.dtype == dtype and got.device == table.device
    assert torch.equal(got, want) and torch.equal(got, again)
    # on the CPU, the same op runs the plain version: the same bits
    assert torch.equal(got.cpu(), eops.embedding_bag(table.cpu(), ids.cpu()))


def test_embedding_bag_kernel_refuses_what_it_does_not_take(card):
    from repro_torch.kernels.embedding_bag import kernel as ekernel
    from repro_torch.kernels.embedding_bag import ops as eops
    table = torch.randn(16, 8, device=card)
    ids = torch.ones(4, 3, dtype=torch.int32, device=card)
    before = eops.embedding_bag.launches
    with pytest.raises(ValueError, match="no backward"):
        eops.embedding_bag(table.clone().requires_grad_(True), ids)
    with pytest.raises(ValueError, match="int32"):
        eops.embedding_bag(table, ids.long())
    with pytest.raises(ValueError, match="f32 or bf16"):
        eops.embedding_bag(table.half(), ids)
    with pytest.raises(ValueError, match=r"\(B, L\)"):
        eops.embedding_bag(table, ids[0])
    with pytest.raises(ValueError, match="same device"):
        eops.embedding_bag(table, ids.cpu())
    with pytest.raises(ValueError, match="CUDA device"):
        ekernel.embedding_bag_cuda(table.cpu(), ids.cpu())
    assert eops.embedding_bag.launches == before
    # no bags, or rows of width 0: nothing launched, nothing counted
    assert eops.embedding_bag(table, ids[:0]).shape == (0, 8)
    assert eops.embedding_bag(table[:, :0], ids).shape == (4, 0)
    assert eops.embedding_bag.launches == before
    with torch.no_grad():
        out = eops.embedding_bag(table.clone().requires_grad_(True), ids)
    assert eops.embedding_bag.launches == before + 1
    assert torch.equal(out, 3 * table[1].expand(4, 8))


def _rec_on(dev, cfg, params):
    import copy
    from repro_torch.models.sasrec import SASRec
    return SASRec(cfg, copy.deepcopy(params), device=dev)


def test_cuda_rec_serve_equals_cpu_serve(card, monkeypatch):
    """The smoke config's serve and retrieval steps on the card (the
    ``dht_gather`` kernel: 2 launches a serve call, 1 a retrieval call) and
    on the CPU: candidate scores within 1e-5 of the largest |score| (TF32
    off; the two devices' f32 matmuls and reductions sum in other
    orders)."""
    from repro_torch.configs import registry
    from repro_torch.data.recsys import RecStreamConfig, batch_at_step
    from repro_torch.kernels.embedding_bag import ops as eops
    from repro_torch.launch.steps import rec_retrieval_step, rec_serve_step
    from repro_torch.models.sasrec import init_params
    cfg = registry.get("sasrec").smoke_config
    params = init_params(cfg, torch.Generator().manual_seed(0))
    seq, _, _ = batch_at_step(RecStreamConfig(cfg.n_items, cfg.seq_len, 64),
                              0)
    cands = np.random.default_rng(0).integers(1, cfg.n_items, (64, 256))
    out = {}
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for dev in ("cpu", card):
        model = _rec_on(dev, cfg, params)
        counts = (ops.dht_gather.launches, eops.embedding_bag.launches)
        scores = rec_serve_step(model, seq, cands)
        mid = ops.dht_gather.launches
        ret = rec_retrieval_step(model, seq[:1])
        out[str(dev)] = (scores.cpu(), ret.cpu(),
                         mid - counts[0], ops.dht_gather.launches - mid,
                         eops.embedding_bag.launches - counts[1])
    cpu, gpu = out["cpu"], out[str(card)]
    assert cpu[2:] == (0, 0, 0) and gpu[2:] == (2, 1, 0)
    for a, b in zip(gpu[:2], cpu[:2]):
        assert bool(torch.isfinite(a).all())
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale)


def test_cuda_rec_train_step_equals_cpu_step(card, monkeypatch):
    """One f32 ``rec_train_step`` of the smoke config on the card (3
    ``dht_gather`` launches) and on the CPU: loss and grad norm within 1e-4
    relative, every parameter within 2 lr (TF32 off)."""
    from repro_torch.configs import registry
    from repro_torch.data.recsys import RecStreamConfig, batch_at_step
    from repro_torch.launch.steps import rec_train_step
    from repro_torch.models.sasrec import init_params
    from repro_torch.optim import adamw
    cfg = registry.get("sasrec").smoke_config
    params = init_params(cfg, torch.Generator().manual_seed(1))
    seq, pos, neg = batch_at_step(RecStreamConfig(cfg.n_items, cfg.seq_len,
                                                  32), 2)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    out = {}
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for dev in ("cpu", card):
        model = _rec_on(dev, cfg, params)
        state = adamw.init_state(model, opt_cfg)
        before = ops.dht_gather.launches
        metrics = rec_train_step(model, opt_cfg, state, seq, pos, neg)
        out[str(dev)] = (model, metrics, ops.dht_gather.launches - before)
    cpu, gpu = out["cpu"], out[str(card)]
    assert cpu[2] == 0 and gpu[2] == 3
    for key in ("loss", "grad_norm"):
        a, b = float(gpu[1][key]), float(cpu[1][key])
        assert abs(a - b) <= 1e-4 * abs(b), (key, a, b)
    lr = float(cpu[1]["lr"])
    for (name, p), (_, q) in zip(gpu[0].named_parameters(),
                                 cpu[0].named_parameters()):
        assert float((p.detach().cpu() - q.detach()).abs().max()) <= 2 * lr, \
            name


def test_cuda_gin_on_an_edge_list_with_a_hub(card, monkeypatch):
    """gin-tu's smoke config on a star of in-degree 20,000 as an edge list:
    a table of ``K_CAP`` slots through the kernel (5 launches) and the
    hub's other in-edges by ``index_add_``, on the card in f32 (TF32 off)
    against the same forward in f64 on the CPU (the plain version, no
    launch): logits within 1e-4 of the largest |logit|.  The reference is
    f64 because the f32 CPU forward sums the readout over the 20,001
    near-equal node rows in the reference's order, one add at a time, and
    that sum's rounding drifts past 1e-4 of the largest logit; the card's
    one-hot readout sums in blocks and does not."""
    import copy
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.data import graphs
    from repro_torch.kernels.segment_matmul import ops as sops
    from repro_torch.models.gnn.gin import GIN, init_params
    cfg = registry.get("gin-tu").smoke_config
    g = gen.star(20_001)
    feat = np.random.default_rng(0).standard_normal(
        (g.n, cfg.d_feat)).astype(np.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    out = {}
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for name, dev, dtype in (("f64", "cpu", torch.float64),
                             ("cpu_f32", "cpu", torch.float32),
                             ("card", card, torch.float32)):
        batch = graphs._to_batch(g, node_feat=feat, device=dev)
        model = GIN(dataclasses.replace(cfg, dtype=dtype),
                    copy.deepcopy(params), device=dev)
        before = sops.segment_matmul.launches
        out[name] = (model(batch).detach().cpu().double(),
                     sops.segment_matmul.launches - before)
    want = out["f64"][0]
    assert out["f64"][1] == 0 and out["card"][1] == cfg.n_layers
    scale = float(want.abs().max())
    # the measured differences, shown with pytest -rP
    for name in ("card", "cpu_f32"):
        print(f"hub logits: max |{name} - f64| / max |f64| = "
              f"{float((out[name][0] - want).abs().max()) / scale}")
    torch.testing.assert_close(out["card"][0], want, rtol=0,
                               atol=1e-4 * scale)
