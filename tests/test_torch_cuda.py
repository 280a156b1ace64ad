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
    from repro_torch.kernels.flash_attention import ops as fops
    q = torch.randn(1, 64, 2, 64, device=card, requires_grad=True)
    k = torch.randn(1, 64, 2, 64, device=card)
    with pytest.raises(NotImplementedError, match="training"):
        fops.flash_attention(q, k, k)
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
