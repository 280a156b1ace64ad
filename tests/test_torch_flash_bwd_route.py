"""The flash backward's two routes, on the CPU: which inputs each pair of
kernels takes, what the wgmma route's TMA loads refuse, and the wgmma
route's split arithmetic (``ref.attention_bwd_split_ref``, its plain
mirror) held against the JAX package's backward: the
``flash_attention_trainable`` VJP (its Pallas kernels in interpret mode)
and the VJP of its ``attention_ref``; the rounding-miss statistic by which
the card tests hold the kernels' P and dS to f32; the layout of ``do`` that
the autograd Function hands the kernels; and the build's up-to-date check,
which follows the header the wgmma sources share.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.bwd import (_fwd_with_lse,
                                               flash_attention_trainable)
from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import bwd, kernel
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref, attention_bwd_split_ref, attention_fwd_lse_ref,
    bwd_terms, grad_limit, rounding_miss_limit)

# test_torch_cuda.py::test_flash_bwd_kernels_match_plain_version's cases
BWD_CASES = [
    (2, 256, 256, 4, 2, True, 0),       # GQA, causal
    (1, 256, 256, 4, 4, True, 64),      # sliding window
    (1, 128, 384, 8, 2, True, 100),     # K > S with a window
    (2, 200, 200, 4, 2, True, 0),       # ragged S = K
    (1, 77, 300, 4, 1, True, 37),       # ragged S and K, window
    (1, 192, 160, 4, 2, False, 0),      # not causal, K < S
    (1, 130, 130, 2, 1, False, 50),     # not causal, window
]
F32_ULP = 2.0 ** -24


def _inputs(B, S, K, H, Hkv, D, seed):
    """q, k, v, do as f32 numpy arrays, standard normal from ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, D), (B, K, Hkv, D), (B, K, Hkv, D),
                          (B, S, H, D))]


def _jnp(t, dtype):
    return jnp.asarray(t.float().numpy(), dtype=dtype)


def _torch(a):
    return torch.from_numpy(np.array(a, np.float32))


def _assert_within(got, want, n, what):
    """|got - want| <= ref.grad_limit(want, n) at every element."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    over = ((got.float() - want.float()).abs() / grad_limit(want, n)).max()
    assert float(over) <= 1.0, f"{what}: {float(over)} times its limit"


@pytest.mark.parametrize("dtype", kernel.DTYPES)
@pytest.mark.parametrize("D", kernel.HEAD_DIMS)
def test_route_by_type_and_head_width(dtype, D):
    """bf16 at D 64 and 128 takes the tensor cores; f32 at any D (an f32
    product there would be TF32) and bf16 at D 16, 32 and 256 the SIMT
    kernels."""
    q = torch.zeros(1, 4, 2, D, dtype=dtype)
    want = ("wgmma" if dtype == torch.bfloat16 and D in (64, 128)
            else "simt")
    assert bwd.route(q) == want


def _bf16_view(shape, pad=0, offset=0):
    """A bf16 (B, S, H, D) view whose rows are ``pad`` elements wider than
    H D and whose base is ``offset`` elements into its storage."""
    B, S, H, D = shape
    flat = torch.zeros(offset + B * S * (H * D + pad), dtype=torch.bfloat16)
    rows = flat[offset:].reshape(B, S, H * D + pad)[..., :H * D]
    return rows.unflatten(-1, (H, D))


def _rows(B, H, S):
    return torch.zeros(B, H, S), torch.zeros(B, H, S)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("defect", ["base", "stride"])
def test_wgmma_route_refuses_a_do_tma_cannot_take(D, defect):
    """A ``do`` whose base is off 16 bytes, or whose row stride is no
    multiple of 16 bytes, raises ValueError on the wgmma route before any
    launch; no silent copy.  q, k and v are checked as the forward checks
    them."""
    q, k = _bf16_view((1, 64, 4, D)), _bf16_view((1, 64, 2, D))
    lse, delta = _rows(1, 4, 64)
    bwd._check(q, k, k, _bf16_view((1, 64, 4, D)), lse, delta)
    do = (_bf16_view((1, 64, 4, D), offset=1) if defect == "base"
          else _bf16_view((1, 64, 4, D), pad=4))
    with pytest.raises(ValueError, match="do's .*TMA"):
        bwd._check(q, k, k, do, lse, delta)
    with pytest.raises(ValueError, match="k's .*TMA"):
        bwd._check(q, _bf16_view((1, 64, 2, D), pad=4), k, q, lse, delta)


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 32),
                                     (torch.bfloat16, 256),
                                     (torch.float32, 64)])
def test_simt_route_takes_any_do_stride(dtype, D):
    """The SIMT kernels load elementwise: a misaligned ``do`` is theirs to
    take (bf16 at D 256 keeps the forward's TMA check of q, k and v)."""
    q = torch.zeros(1, 64, 4, D, dtype=dtype)
    do = torch.zeros(1 + 64 * (4 * D + 4), dtype=dtype)[1:]
    do = do.reshape(1, 64, 4 * D + 4)[..., :4 * D].unflatten(-1, (4, D))
    assert bwd.route(q) == "simt"
    bwd._check(q, q[:, :, :2], q[:, :, 2:], do, *_rows(1, 4, 64))


def _same(a, b):
    return a.data_ptr() == b.data_ptr() and a.stride() == b.stride()


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("layout", ["base", "stride", "broadcast",
                                    "last_axis"])
def test_function_copies_a_do_the_wgmma_kernels_cannot_take(D, layout):
    """Autograd chooses the layout of the gradient it hands the Function:
    on the wgmma route a ``do`` with a misaligned base, a row stride of no
    multiple of 16 bytes, a broadcast axis or a strided last axis goes to
    the kernels as a contiguous copy of equal values, which TMA takes."""
    shape = (1, 64, 4, D)
    values = torch.randn(shape).to(torch.bfloat16)
    if layout == "broadcast":
        do = values[:, :1].expand(shape)            # stride 0 over s
    else:
        do = (torch.zeros(1, 64, 4, 2 * D, dtype=torch.bfloat16)[..., ::2]
              if layout == "last_axis" else
              _bf16_view(shape, offset=1) if layout == "base" else
              _bf16_view(shape, pad=4))
        do.copy_(values)
    q = torch.zeros(shape, dtype=torch.bfloat16)
    got = bwd.kernel_do(q, do)
    assert not _same(got, do) and got.is_contiguous()
    assert torch.equal(got, do) and kernel.tma_fault(got, "do") == ""


@pytest.mark.parametrize("dtype,D,pad,offset", [
    (torch.bfloat16, 64, 0, 0),          # contiguous
    (torch.bfloat16, 128, 8, 8),         # 16-byte-aligned strided view
    (torch.bfloat16, 32, 4, 1),          # SIMT route: any layout
    (torch.float32, 64, 4, 1)])          # SIMT route: any layout
def test_function_hands_a_do_the_kernels_take_as_it_is(dtype, D, pad,
                                                       offset):
    """A ``do`` the route's kernels can load goes to them uncopied."""
    B, S, H = 1, 64, 4
    flat = torch.zeros(offset + B * S * (H * D + pad), dtype=dtype)
    do = flat[offset:].reshape(B, S, H * D + pad)[..., :H * D].unflatten(
        -1, (H, D))
    assert _same(bwd.kernel_do(torch.zeros(B, S, H, D, dtype=dtype), do),
                 do)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B,S,K,H,Hkv,causal,window", BWD_CASES)
def test_rounding_misses_tell_split_from_bf16_only(D, B, S, K, H, Hkv,
                                                   causal, window):
    """The card tests count the elements of each bf16 gradient that are not
    the correctly rounded f32 gradient (``attention_bwd_ref``'s) and hold
    the kernel's count to ``ref.rounding_miss_limit`` of the split mirror's
    and a bf16-only mirror's counts.  Here, at the card tests' shapes, the
    bf16-only mirror misses at least sixteen times as many elements as the
    split in each gradient, so the limit lies at least four times from
    either: a kernel that dropped the lo parts would land far above it."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(B, S, K, H, Hkv, D, seed=D + S + K))
    o, lse = attention_fwd_lse_ref(q.float(), k.float(), v.float(), causal,
                                   window)
    o = o.to(torch.bfloat16)
    args = (q, k, v, o, lse, do, causal, window)
    want = attention_bwd_ref(*args)
    split = attention_bwd_split_ref(*args)
    one_part = attention_bwd_split_ref(*args, lo=False)
    for name, w, sp, bf in zip(("dq", "dk", "dv"), want, split, one_part):
        n_split, n_bf16 = int((sp != w).sum()), int((bf != w).sum())
        limit = rounding_miss_limit(n_split, n_bf16)
        assert 4 * n_split <= limit <= n_bf16 / 4, (name, n_split, n_bf16)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B,S,K,H,Hkv,causal,window", BWD_CASES)
def test_split_backward_matches_jax(D, B, S, K, H, Hkv, causal, window):
    """The wgmma route's split arithmetic on bf16 inputs against the JAX
    package's backward, within ``ref.grad_limit`` (one ulp of each bf16
    element's own size, above a floor of 2 n 2^-24):

    - the ``flash_attention_trainable`` VJP on the same bf16 inputs, its
      Pallas kernels in interpret mode (one tile covers ragged S and K),
      the split fed the VJP's own residuals (``_fwd_with_lse``'s bf16 o and
      lse), so both take delta from the same rounded o;
    - the VJP of the JAX ``attention_ref`` on the same values in f32, the
      split fed the f32 o and lse, each gradient rounded to bf16."""
    arrays = _inputs(B, S, K, H, Hkv, D, seed=D + S + K)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    G = H // Hkv
    sums = (K, G * S, G * S)       # dq: K keys; dk, dv: G * S query rows

    jq, jk, jv, jdo = (_jnp(t, jnp.bfloat16) for t in (q, k, v, do))
    _, pull = jax.vjp(lambda a, b, c: flash_attention_trainable(
        a, b, c, causal, window, S, K, True), jq, jk, jv)
    want = [_torch(g.astype(jnp.float32)).to(torch.bfloat16)
            for g in pull(jdo)]
    o, lse = _fwd_with_lse(jq, jk, jv, causal, window, S, K, True)
    got = attention_bwd_split_ref(q, k, v, _torch(o.astype(jnp.float32)),
                                  _torch(lse).reshape(B, H, S), do, causal,
                                  window)
    for name, g, w, n in zip(("dq", "dk", "dv"), got, want, sums):
        _assert_within(g, w, n, f"{name} vs the JAX VJP")

    f32 = [_jnp(t, jnp.float32) for t in (q, k, v, do)]
    _, pull = jax.vjp(lambda a, b, c: jax_attention(
        a, b, c, causal=causal, window=window), *f32[:3])
    want = [_torch(g).to(torch.bfloat16) for g in pull(f32[3])]
    o, lse = attention_fwd_lse_ref(q.float(), k.float(), v.float(), causal,
                                   window)
    got = attention_bwd_split_ref(q, k, v, o, lse, do, causal, window)
    for name, g, w, n in zip(("dq", "dk", "dv"), got, want, sums):
        _assert_within(g, w, n, f"{name} vs the VJP of attention_ref")


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B,S,K,H,Hkv,causal,window", BWD_CASES[::2])
def test_split_carries_p_and_ds_to_f32(D, B, S, K, H, Hkv, causal, window):
    """In f32, the split's dq, dk and dv stay within 2^-16 of their own
    scale (dq: sum_k |dS| |k|; dk: sum |dS| |q|; dv: sum |P| |do|) of
    ``attention_bwd_ref``'s, plus the f32 rounding of the two sums (at
    most 3 n 2^-24 of the scale for n terms: the split adds 2 n): X_hi +
    X_lo carries X to 2^-16 of itself.  A bf16-only P and dS, which carry
    2^-9, fail that bound in each of the three."""
    q, k, v, do = (torch.from_numpy(a)
                   for a in _inputs(B, S, K, H, Hkv, D, seed=5))
    o, lse = attention_fwd_lse_ref(q, k, v, causal, window)
    got = attention_bwd_split_ref(q, k, v, o, lse, do, causal, window)
    want = attention_bwd_ref(q, k, v, o, lse, do, causal, window)
    p, ds, qf, dof = bwd_terms(q, k, v, o, lse, do, causal, window)

    def products(p, ds, a=lambda x: x):
        dq = torch.einsum("bhgqk,bkhd->bqhgd", a(ds), a(k.float()))
        return (dq.reshape(q.shape),
                torch.einsum("bhgqk,bqhgd->bkhd", a(ds), a(qf)),
                torch.einsum("bhgqk,bqhgd->bkhd", a(p), a(dof)))

    scales = products(p, ds, torch.abs)
    sums = (K, (H // Hkv) * S, (H // Hkv) * S)
    one_part = products(p.to(torch.bfloat16).float(),
                        ds.to(torch.bfloat16).float())
    for name, g, w, sc, n, bf in zip(("dq", "dk", "dv"), got, want, scales,
                                     sums, one_part):
        limit = (2.0 ** -16 + 3 * n * F32_ULP) * sc
        assert bool(((g - w).abs() <= limit).all()), name
        assert bool(((bf - w).abs() > limit).any()), \
            f"a bf16-only {name} passes the split's bound"


def test_build_is_current_follows_included_headers(tmp_path):
    """A library is current only while it is no older than its source and
    the headers beside it that the source includes, so an edit to a header
    the two wgmma sources share rebuilds both."""
    src, header, other = (tmp_path / n for n in ("k.cu", "shared.cuh",
                                                   "other.cuh"))
    header.write_text("// shared\n")
    other.write_text("// not included\n")
    src.write_text('#include <cuda_runtime.h>\n#include "shared.cuh"\n')
    lib = tmp_path / "libk.so"
    assert not _build.is_current(src, lib)
    lib.write_bytes(b"")
    for path, when in ((src, 100), (header, 100), (other, 300), (lib, 200)):
        os.utime(path, (when, when))
    assert _build.is_current(src, lib)        # other.cuh is not an input
    os.utime(header, (300, 300))
    assert not _build.is_current(src, lib)
    os.utime(lib, (300, 300))
    assert _build.is_current(src, lib)
    os.utime(src, (400, 400))
    assert not _build.is_current(src, lib)
