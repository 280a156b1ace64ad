"""The port's ``segment_matmul`` on the CPU against the JAX package's.

On CPU tensors ``ops.segment_matmul`` runs the plain version
(``ref.segment_matmul_ref``); the CUDA kernel is held against that in
``tests/test_torch_cuda.py``.  The Pallas kernel's interpret mode fails
under the installed JAX (ROADMAP queue 3), so the reference here is the
JAX ``ref.py``.  Inputs are drawn with numpy from a seed and handed to
both.

Tolerances, stated before measuring:
- f32: within 1e-5 of each element plus 1e-5 of the largest |output|
  (both sum in f32, in other orders);
- bf16: the port's bf16 result against the JAX ref on the f32-upcast
  inputs (as ``tests/test_kernels.py`` holds the Pallas kernel), within the
  f32 limit plus 2^-8 of each element: the port sums and multiplies in
  f32 and rounds once to bf16, at most half a bf16 unit (2^-8 relative);
- gradients in f32: within 1e-5 of each element plus 1e-5 of the
  tensor's largest |value|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_matmul.ref import segment_matmul_ref as jax_ref

from repro_torch.kernels.segment_matmul import kernel, ops
from repro_torch.kernels.segment_matmul.ref import (neighbor_sum,
                                                    product_limit,
                                                    segment_matmul_ref)

# (M rows of nbr, N rows of x, K, D, F, how padding is laid out)
CASES = [
    # tests/test_kernels.py's shapes, padding at random slots
    (32, 32, 3, 16, 8, "random"),
    (64, 64, 8, 32, 32, "random"),
    (16, 16, 15, 64, 128, "random"),
    # ragged N (no multiple of 8), D 37, rows without a neighbour, K 1
    (37, 37, 4, 16, 8, "random"),
    (40, 40, 5, 37, 24, "random"),
    (48, 48, 6, 20, 16, "empty_rows"),
    (33, 33, 1, 12, 8, "random"),
    # a sampled block's layout: valid slots first, then -1
    (45, 45, 15, 19, 70, "block"),
    # more nbr rows than x rows, and indices past the last row (clipped)
    (50, 21, 4, 9, 8, "out_of_range"),
]


def _inputs(M, N, K, D, F, layout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    w = rng.standard_normal((D, F)).astype(np.float32)
    nbr = rng.integers(-1, N, (M, K)).astype(np.int32)
    if layout == "empty_rows":
        nbr[::3] = -1
    elif layout == "block":
        n_valid = rng.integers(0, K + 1, M)
        nbr = np.where(np.arange(K)[None, :] < n_valid[:, None],
                       rng.integers(0, N, (M, K)), -1).astype(np.int32)
    elif layout == "out_of_range":
        nbr = rng.integers(-1, N + 5, (M, K)).astype(np.int32)
    return x, nbr, w


def _assert_close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 * scale)


@pytest.mark.parametrize("M,N,K,D,F,layout", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_matches_jax_ref(M, N, K, D, F, layout, dtype):
    x, nbr, w = _inputs(M, N, K, D, F, layout)
    xt = torch.from_numpy(x).to(dtype)
    wt = torch.from_numpy(w).to(dtype)
    before = ops.segment_matmul.launches
    got = ops.segment_matmul(xt, torch.from_numpy(nbr), wt)
    assert ops.segment_matmul.launches == before   # CPU: no kernel
    assert got.dtype == dtype and tuple(got.shape) == (M, F)
    # the JAX ref on the f32 values of the port's inputs
    want = jax_ref(jnp.asarray(xt.float().numpy()), jnp.asarray(nbr),
                   jnp.asarray(wt.float().numpy()))
    _assert_close(got.float().numpy(), want,
                  rtol=1e-5 if dtype == torch.float32 else 2 ** -8 + 1e-5)
    if dtype == torch.float32:
        np.testing.assert_array_equal(
            got.numpy(), segment_matmul_ref(xt, torch.from_numpy(nbr),
                                            wt).numpy())


def test_neighbor_sum_sums_slots_in_order_and_skips_padding():
    x = torch.tensor([[1.0, 2.0], [10.0, 20.0], [100.0, 200.0]])
    nbr = torch.tensor([[-1, 2, 0], [-1, -1, -1], [1, 7, -1]],
                       dtype=torch.int32)
    agg = neighbor_sum(x, nbr)
    assert agg.dtype == torch.float32
    torch.testing.assert_close(agg, torch.tensor(
        [[101.0, 202.0], [0.0, 0.0], [110.0, 220.0]]), rtol=0, atol=0)


@pytest.mark.parametrize("M,N,K,D,F,layout", [c for c in CASES
                                             if c[-1] != "out_of_range"])
def test_function_gradients_match_jax_vjp(M, N, K, D, F, layout):
    """The Function's CPU backward (dW = aggᵀ dO, dx by ``index_add_``)
    against ``jax.vjp`` of the JAX ref and against autograd through the
    plain version."""
    x, nbr, w = _inputs(M, N, K, D, F, layout, seed=1)
    dout = np.random.default_rng(2).standard_normal((M, F)).astype(
        np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    nt = torch.from_numpy(nbr)
    out = ops.segment_matmul(xt, nt, wt)
    dx, dw = torch.autograd.grad(out, (xt, wt), torch.from_numpy(dout))
    _, vjp = jax.vjp(lambda a, b: jax_ref(a, jnp.asarray(nbr), b),
                     jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dout))
    _assert_close(dx.numpy(), jdx)
    _assert_close(dw.numpy(), jdw)
    # autograd through a plain gather, mask and sum
    xa = torch.from_numpy(x).requires_grad_()
    wa = torch.from_numpy(w).requires_grad_()
    safe = nt.clamp(0, N - 1).long()
    plain = (torch.where((nt >= 0)[..., None], xa[safe], 0.0).sum(1) @ wa)
    pdx, pdw = torch.autograd.grad(plain, (xa, wa), torch.from_numpy(dout))
    _assert_close(dx.numpy(), pdx.numpy())
    _assert_close(dw.numpy(), pdw.numpy())


def test_function_keeps_the_sum_only_when_w_needs_a_gradient():
    x, nbr, w = _inputs(16, 16, 3, 8, 4, "random")
    xt = torch.from_numpy(x).requires_grad_()
    out = ops.segment_matmul(xt, torch.from_numpy(nbr), torch.from_numpy(w))
    assert out.grad_fn is not None
    (dx,) = torch.autograd.grad(out.sum(), xt)
    assert dx.shape == xt.shape
    wt = torch.from_numpy(w).requires_grad_()
    out = ops.segment_matmul(torch.from_numpy(x), torch.from_numpy(nbr), wt)
    (dw,) = torch.autograd.grad(out.sum(), wt)
    agg = neighbor_sum(torch.from_numpy(x), torch.from_numpy(nbr))
    torch.testing.assert_close(dw, agg.T @ torch.ones(16, 4))


def test_product_limit_holds_two_orders_and_fails_a_dropped_slot():
    """The card's kernel-vs-plain limit: another order of the f32 product
    stays inside it, a sum that drops one valid slot does not."""
    x, nbr, w = _inputs(64, 64, 15, 602, 64, "block", seed=3)
    xt, wt, nt = (torch.from_numpy(a) for a in (x, w, nbr))
    agg = neighbor_sum(xt, nt)
    want = agg @ wt
    other = (agg.double() @ wt.double()).float()   # a better-ordered sum
    lim = product_limit(agg, wt, torch.float32)
    assert bool(((other - want).abs() <= lim).all())
    dropped = nt.clone()
    row = int(torch.nonzero((nt >= 0).sum(1) > 1)[0])
    dropped[row, int(torch.nonzero(nt[row] >= 0)[0])] = -1
    bad = neighbor_sum(xt, dropped) @ wt
    assert not bool(((bad - want).abs() <= lim).all())
    bf = (agg @ wt).to(torch.bfloat16).float()
    assert bool(((bf - want).abs()
                 <= product_limit(agg, wt, torch.bfloat16)).all())


@pytest.mark.parametrize("D,elem_bytes,x_address,agg_address,width", [
    (602, 4, 0, 0, 2),           # GIN layer 0, f32: 8-byte pairs
    (602, 2, 0, None, 2),        # bf16: 4-byte pairs
    (64, 4, 512, 1024, 2),       # layers 1-4
    (37, 4, 0, 0, 1),            # odd D: single elements
    (37, 2, 0, None, 1),
    (602, 4, 4, 0, 1),           # x from its second f32 element
    (602, 2, 2, None, 1),        # x from its second bf16 element
    (602, 2, 4, None, 2),        # bf16 pairs need 4 bytes only
    (602, 4, 0, 4, 1),           # agg off 8 bytes
    (0, 4, 0, 0, 2),             # D 0: nothing to load
])
def test_load_width_follows_d_and_the_addresses(D, elem_bytes, x_address,
                                                agg_address, width):
    assert kernel.load_width(D, elem_bytes, x_address, agg_address) == width


def test_wrappers_refuse_what_they_do_not_take():
    x = torch.zeros(8, 4)
    w = torch.zeros(4, 3)
    nbr = torch.zeros(8, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        ops.segment_matmul(x, nbr.long(), w)
    with pytest.raises(ValueError, match="columns"):
        ops.segment_matmul(x, nbr, torch.zeros(5, 3))
    with pytest.raises(ValueError, match="without rows"):
        ops.segment_matmul(torch.zeros(0, 4), nbr, w)
    # meta tensors (the dry-run's) get an empty output of the kernel's
    # shape and its work counted, with no launch
    launches, ops.segment_matmul.meta_flops = ops.segment_matmul.launches, 0
    out = ops.segment_matmul(x.to("meta"), nbr.to("meta"), w.to("meta"))
    assert out.device.type == "meta" and tuple(out.shape) == (8, 3)
    assert ops.segment_matmul.meta_flops == 8 * 2 * 4 + 2 * 8 * 4 * 3
    assert ops.segment_matmul.launches == launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel.segment_matmul_cuda(x, nbr, w)
