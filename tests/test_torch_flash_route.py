"""The flash forward's two routes, on the CPU: which inputs each kernel
takes, what the wgmma route's TMA loads refuse, and the wgmma route's
split-P arithmetic (``ref.attention_split_p_ref``, its plain mirror) held
against the JAX package's ``attention_ref``.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import (
    attention_ref as jax_attention_ref)
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     attention_split_p_ref)

# the card tests' limit for a bf16 kernel against a plain version: one ulp of
# each element's own size (2^-7 |ref|) plus 1e-3 for the f32 sums near 0
FLASH_TOL = dict(rtol=2 ** -7, atol=1e-3)
# test_torch_cuda.py::test_flash_kernel_matches_plain_version's cases
CASES = [
    (2, 256, 256, 4, 2, True, 0),       # GQA, causal
    (1, 256, 256, 4, 4, True, 64),      # sliding window
    (1, 128, 384, 8, 8, True, 0),       # K > S: q_offset = K - S
    (1, 128, 384, 8, 2, True, 100),     # K > S with a window
    (2, 200, 200, 4, 2, True, 0),       # ragged S = K (not a tile multiple)
    (1, 77, 300, 4, 1, True, 37),       # ragged S and K, window
    (1, 192, 160, 4, 2, False, 0),      # not causal, K < S
    (1, 130, 130, 2, 1, False, 50),     # not causal, window
]


def _inputs(B, S, K, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, D), (B, K, Hkv, D), (B, K, Hkv, D))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", kernel.HEAD_DIMS)
def test_route_by_type_and_head_width(dtype, D):
    """bf16 at D 64, 128, 256 takes the tensor cores; f32 at any D (an f32
    product there would be TF32) and bf16 at D 16, 32 the SIMT kernel."""
    q = torch.zeros(1, 4, 2, D, dtype=dtype)
    want = ("wgmma" if dtype == torch.bfloat16 and D in (64, 128, 256)
            else "simt")
    assert kernel.route(q) == want


def _bf16_view(shape, pad=0, offset=0):
    """A bf16 (B, S, H, D) view whose rows are ``pad`` elements wider than
    H D and whose base is ``offset`` elements into its storage."""
    B, S, H, D = shape
    flat = torch.zeros(offset + B * S * (H * D + pad), dtype=torch.bfloat16)
    rows = flat[offset:].reshape(B, S, H * D + pad)[..., :H * D]
    return rows.unflatten(-1, (H, D))


@pytest.mark.parametrize("which", ["q", "k", "v"])
@pytest.mark.parametrize("defect", ["base", "stride"])
def test_tma_route_refuses_what_tma_cannot_take(which, defect):
    """A base off 16 bytes, or a row stride that is no multiple of 16
    bytes, raises ValueError on the wgmma route; no silent copy."""
    ok = {"q": (1, 64, 4, 64), "k": (1, 64, 2, 64), "v": (1, 64, 2, 64)}
    t = {n: _bf16_view(shape) for n, shape in ok.items()}
    kernel.check_kernel_inputs(t["q"], t["k"], t["v"])   # aligned: taken
    t[which] = (_bf16_view(ok[which], offset=1) if defect == "base"
                else _bf16_view(ok[which], pad=4))
    with pytest.raises(ValueError, match="TMA"):
        kernel.check_kernel_inputs(t["q"], t["k"], t["v"])


def test_simt_route_takes_any_stride():
    """The same misaligned layouts are the SIMT kernel's to take in f32 and
    bf16 at D 32 (elementwise loads): no TMA check there."""
    q = _bf16_view((1, 64, 4, 32), pad=4)
    k = _bf16_view((1, 64, 2, 32), offset=1)
    assert kernel.route(q) == "simt"
    kernel.check_kernel_inputs(q, k, k)
    q32 = torch.zeros(1 + 64 * (4 * 64 + 3), dtype=torch.float32)[1:]
    q32 = q32.reshape(1, 64, 4 * 64 + 3)[..., :256].unflatten(-1, (4, 64))
    kernel.check_kernel_inputs(q32, q32[:, :, :2], q32[:, :, 2:])


def test_tma_route_takes_strided_heads():
    """Heads sliced out of a wider tensor, as the LM's fused projections
    and chip_smoke's strided case give them, meet TMA's alignment."""
    wide = torch.zeros(2, 128, 4 + 2 + 2, 128, dtype=torch.bfloat16)
    kernel.check_kernel_inputs(wide[:, :, :4], wide[:, :, 4:6],
                               wide[:, :, 6:])


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B,S,K,H,Hkv,causal,window", CASES)
def test_split_p_matches_jax_attention_ref(D, B, S, K, H, Hkv, causal,
                                           window):
    """The wgmma route's split-P arithmetic on bf16 inputs against the JAX
    package's f32-P attention, within the card tests' bf16 limit."""
    arrays = _inputs(B, S, K, H, Hkv, D, seed=D + S + K)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    got = attention_split_p_ref(q, k, v, causal=causal, window=window)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
                  for t in (q, k, v))
    want = np.array(jax_attention_ref(jq, jk, jv, causal=causal,
                                      window=window).astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), torch.from_numpy(want),
                               **FLASH_TOL)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("B,S,K,H,Hkv,causal,window", CASES[::3])
def test_split_p_carries_p_to_f32(D, B, S, K, H, Hkv, causal, window):
    """In f32, the split P's output stays within 2^-16 (sum p |v|) / l of
    the whole-row f32 softmax's (plus f32 rounding of the sums): P_hi +
    P_lo carries P to 2^-16 of itself, where a bf16 P would carry 2^-9."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(B, S, K, H, Hkv, D, 3))
    got = attention_split_p_ref(q, k, v, causal=causal, window=window)
    want = attention_ref(q, k, v, causal=causal, window=window)
    # sum_k p |v| / l, the split's bound: the plain attention of |v|
    scale = attention_ref(q, k, v.abs(), causal=causal, window=window)
    limit = 2.0 ** -16 * scale + 64 * 2.0 ** -24 * want.abs().amax()
    assert bool(((got - want).abs() <= limit).all())
