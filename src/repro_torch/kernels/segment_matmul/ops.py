"""``segment_matmul``: a padded-neighbour gather-sum and one matmul, the
aggregation of a GIN layer.

On a CUDA tensor it launches the Hopper kernel (``kernel.py``); on a CPU
tensor it runs the plain version (``ref.py``).  There is no fallback from
one to the other.  ``SegmentMatmul`` is its ``torch.autograd.Function``:
the JAX package has no backward kernel (its GIN gradient is ``jax.grad`` of
``take`` and ``segment_sum``), so the backward is plain torch on every
device.
"""
from __future__ import annotations

import torch

from .kernel import segment_matmul_cuda
from .ref import check_inputs, neighbor_sum, segment_matmul_ref


class SegmentMatmul(torch.autograd.Function):
    """``apply(x, nbr, w)`` -> out (M, F) in x's type.

    The forward keeps the f32 neighbour sum ``agg`` (M, D) when w needs a
    gradient (the kernel writes it beside out, as the flash forward writes
    its ``lse``).  The backward computes ``dW = aggᵀ dO`` with
    ``torch.matmul`` and ``dx`` by adding the rows of ``dO Wᵀ`` into each
    valid slot's neighbour row (``index_add_``; on the card its atomics
    make the f32 bits of dx vary from run to run).
    """

    @staticmethod
    def forward(ctx, x, nbr, w):
        want_agg = ctx.needs_input_grad[2]
        if x.is_cuda:
            if want_agg:
                out, agg = segment_matmul_cuda(x, nbr, w, with_agg=True)
            else:
                out, agg = segment_matmul_cuda(x, nbr, w), None
        else:
            agg = neighbor_sum(x, nbr)
            out = (agg @ w.float()).to(x.dtype)
            if not want_agg:
                agg = None
        ctx.save_for_backward(nbr, w, agg)
        ctx.x_shape, ctx.x_dtype = tuple(x.shape), x.dtype
        return out

    @staticmethod
    def backward(ctx, dout):
        nbr, w, agg = ctx.saved_tensors
        g = dout.float()
        dx = dw = None
        if ctx.needs_input_grad[2]:
            dw = (agg.T @ g).to(w.dtype)
        if ctx.needs_input_grad[0]:
            N, D = ctx.x_shape
            rows, slots = torch.nonzero(nbr >= 0, as_tuple=True)
            dst = nbr[rows, slots].clamp(max=N - 1).long()
            dx = torch.zeros((N, D), dtype=torch.float32, device=g.device)
            if rows.numel():
                dx.index_add_(0, dst, (g @ w.float().T)[rows])
            dx = dx.to(ctx.x_dtype)
        return dx, None, dw


def segment_matmul(x: torch.Tensor, nbr: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """out[m] = (sum_k x[nbr[m, k]]) @ w for x (N, D), nbr (M, K) int32
    with -1 as padding, w (D, F); (M, F) in x's type, summed in f32.

    Where grad is enabled and x or w requires it, the call goes through
    :class:`SegmentMatmul`.  ``segment_matmul.launches`` counts kernel
    launches (CUDA tensors, M and F nonzero).
    """
    check_inputs(x, nbr, w)
    if not (x.device == nbr.device == w.device):
        raise ValueError("x, nbr and w must be on the same device")
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"segment_matmul runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        out = SegmentMatmul.apply(x, nbr, w)
    elif x.is_cuda:
        out = segment_matmul_cuda(x, nbr, w)
    else:
        return segment_matmul_ref(x, nbr, w)
    if x.is_cuda and nbr.shape[0] and w.shape[1]:
        segment_matmul.launches += 1
    return out


segment_matmul.launches = 0
