"""Port tests that need the card: the CUDA ``dht_gather`` kernel and the
engine on CUDA, each held against the port's own CPU path (exact).

This file imports no JAX, so it also runs on a machine with a card and no
JAX:  ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Elsewhere every test skips (a CUDA kernel has no CPU mode).
"""
import numpy as np
import pytest
import torch

from repro_torch.ampc import AmpcEngine, registry
from repro_torch.ampc.engine import _field_eq
from repro_torch.graph import generators as gen
from repro_torch.kernels.dht_gather import ops
from repro_torch.kernels.dht_gather.ref import dht_gather_fused_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def _dht_table(card, V, D, dtype, seed=1):
    gen = torch.Generator(card).manual_seed(seed)
    if dtype == torch.int32:
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (V, D), device=card,
                             dtype=torch.int32, generator=gen)
    return torch.randn(V, D, device=card, generator=gen).to(dtype)


def _assert_dht_gather_exact(table, keys, presorted=False):
    """ops.dht_gather on the card: one launch, rows bit-equal to the plain
    version (sort, plain rows, unsort), exact hits, and a second call
    bit-equal to the first."""
    before = ops.dht_gather.launches
    out, hits = ops.dht_gather(table, keys, presorted=presorted)
    again, hits2 = ops.dht_gather(table, keys, presorted=presorted)
    assert ops.dht_gather.launches == before + 2 * bool(keys.numel())
    if presorted:
        sk, order = keys, None
    else:
        sk, order = torch.sort(keys, stable=True)
    expect, ref_hits = dht_gather_fused_ref(table, sk, order)
    torch.cuda.synchronize()
    assert out.dtype == table.dtype and out.shape == expect.shape
    assert torch.equal(out, expect) and int(hits) == int(ref_hits)
    assert torch.equal(again, out) and int(hits2) == int(hits)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("D", [1, 2, 3, 25, 50, 64, 128])
def test_kernel_matches_plain_version(card, D, dtype):
    V, Q = 5000, 20000
    rng = np.random.default_rng(0)
    table = _dht_table(card, V, D, dtype)
    keys = rng.integers(-3, V + 5, size=Q).astype(np.int32)
    keys[::7] = -1
    keys[1000:1400] = 17        # a long duplicate run
    _assert_dht_gather_exact(table, torch.from_numpy(keys).to(card))


@pytest.mark.parametrize("case", ["row_offset", "element_offset",
                                  "all_invalid", "q1", "q31", "q33", "q4097",
                                  "presorted"])
@pytest.mark.parametrize("D,dtype", [(1, torch.int32), (50, torch.float32),
                                     (64, torch.float32),
                                     (3, torch.bfloat16)])
def test_kernel_edge_cases(card, D, dtype, case):
    """Table views off 16-byte alignment (from row 1 of a larger table, and
    from its second element), keys that are all padding, batches around a
    warp's and a tile's size, and presorted keys."""
    from repro_torch.kernels.dht_gather import kernel
    V = 3000
    rng = np.random.default_rng(1)
    table = _dht_table(card, V + 1, D, dtype)
    if case == "row_offset":
        table = table[1:]
    elif case == "element_offset":
        table = table.reshape(-1)[1:1 + V * D].view(V, D)
        assert kernel.chunk_bytes(D * table.element_size(),
                                  table.data_ptr()) == table.element_size()
    Q = {"q1": 1, "q31": 31, "q33": 33, "q4097": 4097}.get(case, 10000)
    keys = rng.integers(-2, V + 3, size=Q).astype(np.int32)
    if case == "all_invalid":
        keys[:] = -1
    if case == "presorted":
        keys = np.sort(keys)
    _assert_dht_gather_exact(table, torch.from_numpy(keys).to(card),
                             presorted=case == "presorted")


def test_kernel_empty_batch_launches_nothing(card):
    table = torch.zeros(10, 1, dtype=torch.int32, device=card)
    before = ops.dht_gather.launches
    out, hits = ops.dht_gather(table, torch.zeros(0, dtype=torch.int32,
                                                  device=card))
    assert out.shape == (0, 1) and int(hits) == 0
    assert ops.dht_gather.launches == before


@pytest.mark.parametrize("problem", registry.names())
def test_cuda_solve_equals_cpu_solve(card, problem):
    spec = registry.get(problem)
    opts = {"p": 1 / 8} if problem == "one-vs-two" else {}
    if spec.needs_cycles:
        g = gen.two_cycles(500)
    else:
        g = gen.rmat(10, 8.0, seed=1)
    if spec.needs_weights:
        g = g.with_random_weights(2)
    want = AmpcEngine(seed=0, device="cpu").solve(g, problem, **opts)
    before = ops.dht_gather.launches
    got = AmpcEngine(seed=0).solve(g, problem, **opts)
    assert ops.dht_gather.launches - before == \
        (2 if problem == "connectivity" else 0)
    np.testing.assert_array_equal(got.output, want.output)
    assert _field_eq(got.stats, want.stats)
    for key in got.ledger:
        if key not in ("wall_time_s", "phase_times"):
            assert got.ledger[key] == want.ledger[key], key


def _ledger_counts(ledger):
    return {k: v for k, v in ledger.items()
            if k not in ("wall_time_s", "phase_times")}


@pytest.mark.parametrize("problem", [
    "mis", "matching", "weighted-matching", "vertex-cover", "msf",
    "connectivity", "one-vs-two"])
def test_cuda_serving_layers_equal_cpu(card, problem):
    """``solve_many`` (no kernel launch), a cold and a warm session solve
    (2 launches each for connectivity) and a submitted solve on the card,
    each equal to the same call on the CPU."""
    spec = registry.get(problem)
    opts = {"p": 1 / 8} if problem == "one-vs-two" else {}
    if spec.needs_cycles:
        fleet = [gen.two_cycles(k) for k in (60, 90, 100, 300)]
    else:
        fleet = [gen.erdos_renyi(n, 4.0 if i % 2 else 40.0, seed=i)
                 for i, n in enumerate((200, 240, 500, 700))]
    if spec.needs_weights:
        fleet = [g.with_random_weights(i) for i, g in enumerate(fleet)]
    cpu = AmpcEngine(seed=0, device="cpu")
    with AmpcEngine(seed=0, max_workers=2) as eng:
        before = ops.dht_gather.launches
        got = eng.solve_many(fleet, problem, **opts)
        assert ops.dht_gather.launches == before
        for g, w in zip(got, cpu.solve_many(fleet, problem, **opts)):
            np.testing.assert_array_equal(g.output, w.output)
            assert _field_eq(g.stats, w.stats)
            assert _ledger_counts(g.ledger) == _ledger_counts(w.ledger)
        sess, csess = eng.session(fleet[2]), cpu.session(fleet[2])
        for _ in ("cold", "warm"):
            before = ops.dht_gather.launches
            got, want = sess.solve(problem, **opts), csess.solve(problem,
                                                                 **opts)
            assert ops.dht_gather.launches - before == \
                (2 if problem == "connectivity" else 0)
            np.testing.assert_array_equal(got.output, want.output)
            assert _ledger_counts(got.ledger) == _ledger_counts(want.ledger)
        fut = eng.submit(fleet[3], problem, **opts)
        np.testing.assert_array_equal(
            fut.result(timeout=300).output,
            cpu.solve(fleet[3], problem, **opts).output)


@pytest.mark.parametrize("problem", [
    "mis", "matching", "weighted-matching", "vertex-cover", "msf",
    "connectivity", "one-vs-two"])
def test_cuda_routed_and_eager_solves_equal_cpu(card, problem):
    """A routed solve over 8 shards on the card (no kernel launch: the
    router answers by indexing) and an eager solve on the card, each equal
    to the same solve on the CPU, counters included."""
    from repro_torch.core.dht import make_mesh
    spec = registry.get(problem)
    opts = {"p": 1 / 8} if problem == "one-vs-two" else {}
    g = gen.two_cycles(500) if spec.needs_cycles else gen.rmat(10, 8.0,
                                                               seed=1)
    if spec.needs_weights:
        g = g.with_random_weights(2)
    for kw in ({"mesh": make_mesh(8), "dht_backend": "routed"},
               {"deferred_accounting": False}):
        want = AmpcEngine(seed=0, device="cpu", **kw).solve(g, problem,
                                                            **opts)
        before = ops.dht_gather.launches
        got = AmpcEngine(seed=0, **kw).solve(g, problem, **opts)
        launches = ops.dht_gather.launches - before
        routed = "mesh" in kw
        assert launches == (2 if problem == "connectivity" and not routed
                            else 0)
        np.testing.assert_array_equal(got.output, want.output)
        assert _field_eq(got.stats, want.stats)
        assert _ledger_counts(got.ledger) == _ledger_counts(want.ledger)
        assert got.ledger["dht_overflows"] == 0


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


# The wgmma forward's outputs (o and lse, bit for bit) on numpy-seeded bf16
# inputs, as the kernel gave them before its helpers moved into the shared
# header ``csrc/hopper_wgmma.cuh``: that move must change no bit.
# ``python tests/test_torch_cuda.py`` prints the digests of the
# ``repro_torch`` on ``PYTHONPATH``, which is how these were made.
FWD_DIGEST_CASES = [
    (1, 256, 256, 4, 2, 64, True, 0),
    (1, 192, 160, 4, 2, 64, False, 0),
    (2, 200, 200, 4, 2, 128, True, 0),
    (1, 77, 300, 4, 1, 128, True, 37),
    (1, 256, 256, 4, 4, 256, True, 64),
]
FWD_DIGESTS = {
    "(1, 256, 256, 4, 2, 64, True, 0)": "ef95034fd0c462f2",
    "(1, 192, 160, 4, 2, 64, False, 0)": "1a6c6b4e62475d37",
    "(2, 200, 200, 4, 2, 128, True, 0)": "03ce02061f0aa9be",
    "(1, 77, 300, 4, 1, 128, True, 37)": "924d77e9e522dfa6",
    "(1, 256, 256, 4, 4, 256, True, 64)": "413ffe11e173e5ea",
}


def flash_fwd_digests(card=torch.device("cuda")):
    """{case: the first 16 hex digits of the sha256 of o's and lse's bits}
    from ``kernel.flash_attention_cuda`` at each of ``FWD_DIGEST_CASES``
    (B, S, K, H, Hkv, D, causal, window)."""
    import hashlib
    from repro_torch.kernels.flash_attention import kernel
    digests = {}
    for case in FWD_DIGEST_CASES:
        B, S, K, H, Hkv, D, causal, window = case
        rng = np.random.default_rng(sum(case[:6]))
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                   .to(card).to(torch.bfloat16)
                   for shape in ((B, S, H, D), (B, K, Hkv, D),
                                 (B, K, Hkv, D)))
        assert kernel.route(q) == "wgmma"
        o, lse = kernel.flash_attention_cuda(q, k, v, causal, window,
                                             with_lse=True)
        h = hashlib.sha256(o.view(torch.int16).cpu().numpy().tobytes())
        h.update(lse.cpu().numpy().tobytes())
        digests[str(case)] = h.hexdigest()[:16]
    return digests


def test_flash_wgmma_forward_bits_unchanged(card):
    """The forward built from the shared header gives the bits it gave
    before the move, at D 64, 128 and 256."""
    assert flash_fwd_digests(card) == FWD_DIGESTS


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
    its own, each kernel launched once a call on its route (bf16 at D 64
    and 128: wgmma; the rest: SIMT), and a second run equal to the first
    bit for bit (no atomics)."""
    from repro_torch.kernels.flash_attention import bwd, kernel
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_ref, attention_fwd_lse_ref)
    q, k, v, do = _bwd_inputs(card, B, S, K, H, Hkv, D, dtype, D + S + K)
    o, lse = attention_fwd_lse_ref(q, k, v, causal, window)
    _, lse_kernel = kernel.flash_attention_cuda(q, k, v, causal, window,
                                                with_lse=True)
    _assert_within(lse_kernel, lse, K, "lse")
    delta = bwd.row_delta(o, do)
    route = ("wgmma" if dtype == torch.bfloat16 and D in (64, 128)
             else "simt")
    fns = (bwd.flash_bwd_dq, bwd.flash_bwd_dkv)
    before = [(fn.launches, dict(fn.launches_by_route)) for fn in fns]
    runs = [(bwd.flash_bwd_dq(q, k, v, do, lse, delta, causal, window),
             *bwd.flash_bwd_dkv(q, k, v, do, lse, delta, causal, window))
            for _ in range(2)]
    for fn, (launches, by_route) in zip(fns, before):
        assert fn.launches == launches + 2
        by_route[route] += 2
        assert fn.launches_by_route == by_route
    want = attention_bwd_ref(q, k, v, o, lse, do, causal, window)
    torch.cuda.synchronize()
    G = H // Hkv
    for name, got, ref, n in zip(("dq", "dk", "dv"), runs[0], want,
                                 (K, G * S, G * S)):
        _assert_within(got, ref, n, name)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B,S,K,H,Hkv,causal,window", BWD_CASES)
def test_flash_bwd_wgmma_keeps_p_and_ds_at_f32(card, monkeypatch, D, B, S,
                                               K, H, Hkv, causal, window):
    """The wgmma kernels take P and dS as bf16 hi and lo parts, so they keep
    f32 accuracy: in each gradient, the elements that are not the correctly
    rounded f32 gradient (``attention_bwd_ref``'s) number no more than
    ``ref.rounding_miss_limit`` of the split mirror's count and a bf16-only
    P and dS mirror's count on the same inputs.  Kernels that dropped the
    lo parts would land near the bf16-only count, far above the limit, yet
    within ``grad_limit``."""
    from repro_torch.kernels.flash_attention import bwd
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_ref, attention_bwd_split_ref, attention_fwd_lse_ref,
        rounding_miss_limit)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v, do = _bwd_inputs(card, B, S, K, H, Hkv, D, torch.bfloat16,
                              D + S + K)
    o, lse = attention_fwd_lse_ref(q, k, v, causal, window)
    delta = bwd.row_delta(o, do)
    assert bwd.route(q) == "wgmma"
    got = (bwd.flash_bwd_dq(q, k, v, do, lse, delta, causal, window),
           *bwd.flash_bwd_dkv(q, k, v, do, lse, delta, causal, window))
    args = (q, k, v, o, lse, do, causal, window)
    for name, g, want, split, one in zip(
            ("dq", "dk", "dv"), got, attention_bwd_ref(*args),
            attention_bwd_split_ref(*args),
            attention_bwd_split_ref(*args, lo=False)):
        misses = [int((x != want).sum()) for x in (g, split, one)]
        assert misses[0] <= rounding_miss_limit(*misses[1:]), (name, misses)


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


@pytest.mark.parametrize("D", [64, 128])
def test_flash_function_bf16_grads_on_card_match_plain_backward(card, D):
    """The bf16 twin of the test above: autograd through
    ``ops.flash_attention`` on the card at D 64 and 128 takes the wgmma
    route forward and backward (one launch of each kernel), and its
    gradients lie within the kernels' limits of the plain backward on the
    CPU fed the same residuals: the forward kernel's o and lse, which a
    second forward launch gives bit for bit.  (The CPU Function's own bf16
    o may sit an ulp away from the kernel's, and delta = rowsum(do o)
    carries that into every gradient of the row.)"""
    from repro_torch.kernels.flash_attention import bwd, kernel
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    B, S, K, H, Hkv, window = 1, 160, 224, 8, 2, 48
    q, k, v, do = _bwd_inputs(card, B, S, K, H, Hkv, D, torch.bfloat16,
                              11 + D)
    fns = (fops.flash_attention, bwd.flash_bwd_dq, bwd.flash_bwd_dkv)
    before = [dict(fn.launches_by_route) for fn in fns]
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fops.flash_attention(*leaves, causal=True, window=window)
    grads = torch.autograd.grad(out, leaves, do)
    for fn, was in zip(fns, before):
        assert fn.launches_by_route == dict(was, wgmma=was["wgmma"] + 1)
    o, lse = kernel.flash_attention_cuda(q, k, v, True, window,
                                         with_lse=True)
    assert torch.equal(o, out.detach())
    want = attention_bwd_ref(*(t.cpu() for t in (q, k, v, o, lse, do)),
                             True, window)
    for name, got, ref, n in zip(("dq", "dk", "dv"), grads, want,
                                 (K, 4 * S, 4 * S)):
        _assert_within(got.cpu(), ref, n, name)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_function_bf16_takes_any_do_layout(card, D):
    """Autograd may hand the Function a ``do`` that TMA cannot load: here a
    view one element into the gradient of a concatenation (a misaligned
    base), and a gradient broadcast over b and s (stride 0).  On the wgmma
    route the Function copies it, and the gradients equal those of a
    contiguous ``do`` of the same values, bit for bit."""
    from repro_torch.kernels.flash_attention import bwd
    from repro_torch.kernels.flash_attention import ops as fops
    B, S, K, H, Hkv, window = 1, 160, 224, 8, 2, 48
    q, k, v, do = _bwd_inputs(card, B, S, K, H, Hkv, D, torch.bfloat16,
                              21 + D)
    w = do[0, 0].contiguous()                                  # (H, D)
    pad = torch.zeros(1, dtype=torch.bfloat16, device=card)

    def grads(loss, seed_grad):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = fops.flash_attention(*leaves, causal=True, window=window)
        return torch.autograd.grad(loss(out), leaves, seed_grad)

    before = [dict(fn.launches_by_route)
              for fn in (bwd.flash_bwd_dq, bwd.flash_bwd_dkv)]
    cases = (
        (grads(lambda o: o, do),
         grads(lambda o: torch.cat([pad, o.flatten()]),
               torch.cat([pad, do.flatten()]))),
        (grads(lambda o: o, w.expand(B, S, H, D).contiguous()),
         grads(lambda o: (o.sum((0, 1)) * w).sum(), None)))
    for want, got in cases:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    for fn, was in zip((bwd.flash_bwd_dq, bwd.flash_bwd_dkv), before):
        assert fn.launches_by_route == dict(was, wgmma=was["wgmma"] + 4)


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
    (1000, 1200, 40, 602, 64, "random"),      # K 40: two groups of 32 slots
    (150, 120, 5, 1300, 72, "out_of_range"),  # D 1300: three column chunks
    (777, 500, 15, 37, 80, "out_of_range"),   # ragged M, D 37, 2 col tiles
    (300, 300, 15, 602, 80, "empty_rows"),    # empty rows inside tiles
    (200, 200, 15, 602, 64, "x_offset"),      # x off 8 bytes: 1-wide loads
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
    xt = torch.from_numpy(x).to(card).to(dtype)
    if layout == "x_offset":    # the same rows from x's second element
        flat = torch.zeros(N * D + 1, dtype=dtype, device=card)
        flat[1:] = xt.reshape(-1)
        xt = flat[1:].view(N, D)
    return (xt, torch.from_numpy(nbr).to(card),
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
    # the loads' width follows D and the addresses
    vec = skernel.load_width(D, x.element_size(), x.data_ptr(),
                             agg.data_ptr())
    assert vec == (1 if D % 2 or layout == "x_offset" else 2)


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
# package's test shapes, D 37, L 0 and 1, a ragged B, a long L with rows
# wider than a warp's chunks (passes), SASRec's table width with a ragged
# B; then each chunk width and packed warp (kernel.layout): D 4 (f32 one
# 16-byte chunk, 32 bags a warp), D 64 (f32 16 lanes a bag, 2 bags a warp;
# bf16 8 lanes, 4 bags), D 8 (bf16 one 16-byte chunk, 32 bags a warp), D 1
# (one 4- or 2-byte chunk), each with a B that leaves a warp part full
EMBAG_CASES = [(64, 16, 16, 4), (256, 32, 32, 10), (1024, 64, 8, 50),
               (300, 37, 13, 7), (50, 8, 5, 0), (50, 8, 5, 1),
               (500, 130, 3, 300), (20000, 50, 1001, 50),
               (100, 4, 301, 9), (700, 64, 77, 33), (90, 8, 1000, 13),
               (60, 1, 333, 27)]


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 50, 64])
def test_embedding_bag_kernel_on_a_table_view_one_element_in(card, D, dtype):
    """A table view that starts one element into its storage (f32: only
    4-byte aligned, bf16: 2-byte) takes chunks of that width, and still
    equals the plain version bit for bit, twice."""
    from repro_torch.kernels.embedding_bag import kernel as ekernel
    from repro_torch.kernels.embedding_bag import ops as eops
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    V, B, L = 500, 203, 21
    rng = np.random.default_rng(11)
    flat = torch.zeros(V * D + 1, dtype=dtype, device=card)
    flat[1:] = torch.from_numpy(rng.standard_normal(V * D).astype(
        np.float32)).to(card).to(dtype)
    table = flat[1:].view(V, D)
    ids = torch.from_numpy(rng.integers(-3, V + 5, (B, L)).astype(
        np.int32)).to(card)
    es = table.element_size()
    width, _, _ = ekernel.layout(D, es, table.data_ptr(), 1 << 20)
    assert table.data_ptr() % 16 == es and width == es
    before = eops.embedding_bag.launches
    got = eops.embedding_bag(table, ids)
    again = eops.embedding_bag(table, ids)
    assert eops.embedding_bag.launches == before + 2
    want = embedding_bag_ref(table, ids)
    assert torch.equal(got, want) and torch.equal(got, again)


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



# ------------------------------------------------ GCN, SchNet, MACE; serving
@pytest.mark.parametrize("arch", ["gcn-cora", "schnet", "mace"])
def test_cuda_gnn_models_train_step_equals_cpu_step(card, monkeypatch, arch):
    """One f32 ``gnn_train_step`` of a smoke config on molecules, on the
    card and on the CPU, TF32 off: the output within
    1e-4 of the CPU's largest |element| (``index_add_`` adds in atomic
    order on the card), loss and grad norm within 1e-4 relative, every
    parameter within 2 lr."""
    import copy
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.data import graphs
    from repro_torch.launch.steps import (GNN_MODELS, GNN_MODULES,
                                          gnn_forward_step, gnn_train_step)
    from repro_torch.optim import adamw
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = registry.get(arch).smoke_config
    if arch == "gcn-cora":
        cfg = dataclasses.replace(cfg, d_feat=16)
    params = GNN_MODULES[arch].init_params(cfg,
                                           torch.Generator().manual_seed(0))
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    out = {}
    for dev in ("cpu", card):
        batch = graphs.molecules(n_graphs=8, n_atoms=12, seed=3, d_feat=16,
                                 device=dev)
        if arch == "gcn-cora":
            batch = dataclasses.replace(batch, labels=batch.species % 7)
        model = GNN_MODELS[arch](cfg, copy.deepcopy(params), device=dev)
        state = adamw.init_state(model, opt_cfg)
        y = gnn_forward_step(model, batch).cpu()
        metrics = gnn_train_step(model, opt_cfg, state, batch)
        out[str(dev)] = (model, metrics, y)
    cpu, gpu = out["cpu"], out[str(card)]
    scale = float(cpu[2].abs().max())
    print(f"{arch}: max |card - cpu| / max |cpu| = "
          f"{float((gpu[2] - cpu[2]).abs().max()) / scale}")
    torch.testing.assert_close(gpu[2], cpu[2], rtol=0, atol=1e-4 * scale)
    for key in ("loss", "grad_norm"):
        a, b = float(gpu[1][key]), float(cpu[1][key])
        assert abs(a - b) <= 1e-4 * abs(b), (key, a, b)
    lr = float(cpu[1]["lr"])
    for (name, p), (_, q) in zip(gpu[0].named_parameters(),
                                 cpu[0].named_parameters()):
        assert float((p.detach().cpu() - q.detach()).abs().max()) <= 2 * lr, \
            name


def test_cuda_prefill_and_decode_equal_cpu(card, monkeypatch):
    """qwen3-4b's smoke config in f32, TF32 off: ``prefill`` at S 2048 (the
    chunked attention) and at S 24, then 4 ``decode_step``s on a grown
    cache, on the card and on the CPU: logits within 1e-4 of the CPU's
    largest, the cache within 1e-4 of its largest, lengths equal."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.launch.serve import grow_cache
    from repro_torch.models.transformer import TransformerLM, init_params
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(registry.get("qwen3-4b").smoke_config,
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    for S in (24, 2048):
        tokens = rng.integers(0, cfg.vocab, (2, S))
        feed = rng.integers(0, cfg.vocab, (4, 2))
        runs = {}
        for dev in ("cpu", card):
            model = TransformerLM(cfg, params, device=dev)
            logits, cache = model.prefill(tokens)
            seen = [logits.cpu()]
            cache = grow_cache(cache, S + 4)
            for tok in feed:
                logits, cache = model.decode_step(cache, torch.from_numpy(
                    tok).to(dev))
                seen.append(logits.cpu())
            runs[str(dev)] = (seen, cache["k"].cpu(),
                              cache["length"].cpu())
        cpu, gpu = runs["cpu"], runs[str(card)]
        for a, b in zip(gpu[0], cpu[0]):
            torch.testing.assert_close(
                a, b, rtol=0, atol=1e-4 * float(b.abs().max()))
        torch.testing.assert_close(gpu[1], cpu[1], rtol=0,
                                   atol=1e-4 * float(cpu[1].abs().max()))
        assert torch.equal(gpu[2], cpu[2])

# ------------------------------------------------------- MoE LM on the card
# the flash kernels at the MoE archs' head groups: llama4-scout's 40 query
# heads over 8 kv heads (G 5) and mixtral's 48 over 8 (G 6), D 128, bf16,
# with mixtral's window of 4096 at S 4096 (every key inside it) and S 8192
# (where it bites); dk/dv sums the G heads of a group
MOE_FLASH_CASES = [(S, H, window) for S in (4096, 8192)
                   for H in (40, 48) for window in (0, 4096)]


@pytest.mark.parametrize("S,H,window", MOE_FLASH_CASES)
def test_flash_kernels_at_moe_head_groups(card, S, H, window):
    from repro_torch.kernels.flash_attention import bwd, kernel
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_ref, attention_fwd_lse_ref)
    Hkv, D = 8, 128
    q, k, v, do = _bwd_inputs(card, 1, S, S, H, Hkv, D, torch.bfloat16,
                              S + H + window)
    assert kernel.route(q) == bwd.route(q) == "wgmma"
    before = fops.flash_attention.launches_by_route["wgmma"]
    got = fops.flash_attention(q, k, v, causal=True, window=window)
    assert fops.flash_attention.launches_by_route["wgmma"] == before + 1
    o, lse = attention_fwd_lse_ref(q, k, v, True, window)
    torch.testing.assert_close(got.float(), o.float(),
                               **FLASH_TOL[torch.bfloat16])
    del got
    _, lse_kernel = kernel.flash_attention_cuda(q, k, v, True, window,
                                                with_lse=True)
    _assert_within(lse_kernel, lse, S, "lse")
    delta = bwd.row_delta(o, do)
    dq = bwd.flash_bwd_dq(q, k, v, do, lse, delta, True, window)
    dk, dv = bwd.flash_bwd_dkv(q, k, v, do, lse, delta, True, window)
    want = attention_bwd_ref(q, k, v, o, lse, do, True, window)
    torch.cuda.synchronize()
    G = H // Hkv
    for name, g, ref, n in zip(("dq", "dk", "dv"), (dq, dk, dv), want,
                               (S, G * S, G * S)):
        _assert_within(g, ref, n, name)


def _moe_on(dev, spec, params, x):
    from repro_torch.models import moe
    p = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
             else v.to(dev)) for k, v in params.items()}
    out, aux = moe.moe_apply(p, x.to(dev), spec)
    r = moe.route(p["router"], x.to(dev).reshape(-1, x.shape[-1]), spec)
    return out.cpu(), aux.cpu(), r.gate_idx.cpu(), r.kept_by_token().cpu()


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "mixtral-8x22b"])
def test_cuda_moe_apply_equals_cpu(card, monkeypatch, arch):
    """The smoke configs' MoE layer (4 experts, top-1 with a shared expert
    or top-2) at T 512 in f32 with TF32 off, on the card and on the CPU:
    routes and keep mask equal, output within 1e-5 of the CPU's largest,
    aux within 1e-6 relative."""
    from repro_torch.configs import registry
    from repro_torch.models import moe
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    spec = registry.get(arch).smoke_config.moe_spec
    params = moe.init_moe(torch.Generator().manual_seed(3), spec)
    x = torch.randn(2, 256, spec.d_model,
                    generator=torch.Generator().manual_seed(4))
    cpu = _moe_on("cpu", spec, params, x)
    gpu = _moe_on(card, spec, params, x)
    assert torch.equal(gpu[2], cpu[2]) and torch.equal(gpu[3], cpu[3])
    torch.testing.assert_close(gpu[0], cpu[0], rtol=0,
                               atol=1e-5 * float(cpu[0].abs().max()))
    torch.testing.assert_close(gpu[1], cpu[1], rtol=1e-6, atol=0)


@pytest.mark.parametrize("top_k", [1, 2])
def test_cuda_moe_ties_route_as_on_cpu(card, top_k):
    """A tie-heavy bf16 router: x and the router in {-1, 0, 1} (every
    logit an exact integer, the same on both devices) and pairs of equal
    router columns, so many tokens tie at the top.  The card's routes,
    ties to the lower expert, and its keep mask equal the CPU's; the
    output within 2e-2 of the CPU's largest (bf16 expert products)."""
    from repro_torch.models import moe
    E, d = 8, 64
    spec = moe.MoeSpec(d, 32, E, top_k, capacity_factor=1.0)
    g = torch.Generator().manual_seed(5)
    params = moe.init_moe(g, spec)
    router = torch.randint(-1, 2, (d, E // 2), generator=g).float()
    params["router"] = router.repeat_interleave(2, dim=1)
    x = torch.randint(-1, 2, (4, 128, d), generator=g).to(torch.bfloat16)
    logits = (x.reshape(-1, d).float() @ params["router"])
    top = logits.max(-1, keepdim=True).values
    assert bool(((logits == top).sum(-1) > 2).any())   # ties past the pair
    cpu = _moe_on("cpu", spec, params, x)
    gpu = _moe_on(card, spec, params, x)
    assert torch.equal(gpu[2], cpu[2]) and torch.equal(gpu[3], cpu[3])
    assert not bool(gpu[3].all())           # capacity 1.0 drops some
    torch.testing.assert_close(gpu[0].float(), cpu[0].float(), rtol=0,
                               atol=2e-2 * float(cpu[0].abs().max()))
    torch.testing.assert_close(gpu[1], cpu[1], rtol=1e-6, atol=0)


def test_cuda_compress_is_bit_equal_to_cpu(card):
    """int8 compression with error feedback on the card equals the same
    call on the CPU bit for bit (q, scale, feedback), on gradients whose
    largest magnitude over 127 a reciprocal multiplication would round
    otherwise than the division."""
    from repro_torch.optim import grad_compression as gc
    g = torch.Generator().manual_seed(6)
    grads = {f"g{i}": torch.randn(1000 + i, generator=g) * 10 ** (i % 5 - 2)
             for i in range(64)}
    fb = {k: torch.randn(v.shape, generator=g) * 1e-3
          for k, v in grads.items()}
    cpu = gc.compress_tree(grads, fb)
    gpu = gc.compress_tree({k: v.to(card) for k, v in grads.items()},
                           {k: v.to(card) for k, v in fb.items()})
    for want, got in zip(cpu, gpu):
        for k in grads:
            assert torch.equal(got[k].cpu(), want[k]), k


if __name__ == "__main__":
    import json
    print(json.dumps(flash_fwd_digests()))
