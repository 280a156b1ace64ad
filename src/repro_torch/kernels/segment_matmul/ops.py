"""``segment_matmul``: a padded-neighbour gather-sum and one matmul, the
aggregation of a GIN layer.

On a CUDA tensor it launches the Hopper kernel (``kernel.py``); on a CPU
tensor it runs the plain version (``ref.py``); on a ``meta`` tensor it
returns empty outputs of the right shapes (no launch, no count).  There is
no fallback from one to the other.  ``SegmentMatmul`` is its
``torch.autograd.Function``: the JAX package has no backward kernel (its
GIN gradient is ``jax.grad`` of ``take`` and ``segment_sum``), so the
backward is plain torch on every device.

Under a ``ShardCtx`` (``sctx``; ``x`` and ``nbr`` DTensors whose rows lie
over every mesh axis, ``w`` replicated) the call is an explicit region on
the local shards: ``x`` all-gathered (``nbr`` holds global row ids of
it), the kernel run on this rank's rows of ``nbr`` and writing this
rank's rows of the output, ``w`` as it is.  In the backward ``dx`` is a
full-N partial sum, reduce-scattered back to the rows, and ``dW`` a
partial sum, which the step all-reduces.  The counts (``launches``,
``meta_flops``) are of the local rows.
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
        if x.device.type == "meta":
            out = x.new_empty((nbr.shape[0], w.shape[1]))
            agg = (x.new_empty((nbr.shape[0], x.shape[1]),
                               dtype=torch.float32) if want_agg else None)
        elif x.is_cuda:
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
        if ctx.needs_input_grad[0] and g.device.type == "meta":
            # the valid slots are data: count every row's product once
            dx = (g @ w.float().T).new_zeros(ctx.x_shape).to(ctx.x_dtype)
        elif ctx.needs_input_grad[0]:
            N, D = ctx.x_shape
            rows, slots = torch.nonzero(nbr >= 0, as_tuple=True)
            dst = nbr[rows, slots].clamp(max=N - 1).long()
            dx = torch.zeros((N, D), dtype=torch.float32, device=g.device)
            if rows.numel():
                dx.index_add_(0, dst, (g @ w.float().T)[rows])
            dx = dx.to(ctx.x_dtype)
        return dx, None, dw


def segment_matmul(x: torch.Tensor, nbr: torch.Tensor,
                   w: torch.Tensor, sctx=None) -> torch.Tensor:
    """out[m] = (sum_k x[nbr[m, k]]) @ w for x (N, D), nbr (M, K) int32
    with -1 as padding, w (D, F); (M, F) in x's type, summed in f32.

    Where grad is enabled and x or w requires it, the call goes through
    :class:`SegmentMatmul`.  ``segment_matmul.launches`` counts kernel
    launches (CUDA tensors, M and F nonzero); ``segment_matmul.meta_flops``
    the kernel's work, M·K·D additions and 2·M·D·F for the product, and
    ``segment_matmul.meta_bytes`` the bytes it reads (the table, every
    slot's row, w; its outputs are the allocations a counter sees), in
    the calls answered on ``meta``.  Under ``sctx``, the region of the
    module's docstring.
    """
    if sctx is not None:
        rows, rep = sctx.rows_pl, sctx.replicated_pl
        return sctx.local(segment_matmul, [rows], [rep, rows, rep],
                          [sctx.partial_pl, rows, sctx.partial_pl])(
                              x, nbr, w)
    check_inputs(x, nbr, w)
    if not (x.device == nbr.device == w.device):
        raise ValueError("x, nbr and w must be on the same device")
    if x.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"segment_matmul runs on CUDA, CPU or meta tensors, "
                         f"got {x.device}")
    if x.device.type == "meta":
        M, K = nbr.shape
        segment_matmul.meta_flops += M * K * x.shape[1] \
            + 2 * M * x.shape[1] * w.shape[1]
        segment_matmul.meta_bytes += M * K * (4 + x.shape[1] * x.itemsize) \
            + w.numel() * w.itemsize
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        out = SegmentMatmul.apply(x, nbr, w)
    elif x.is_cuda:
        out = segment_matmul_cuda(x, nbr, w)
    elif x.device.type == "meta":
        return x.new_empty((nbr.shape[0], w.shape[1]))
    else:
        return segment_matmul_ref(x, nbr, w)
    if x.is_cuda and nbr.shape[0] and w.shape[1]:
        segment_matmul.launches += 1
    return out


segment_matmul.launches = 0
segment_matmul.meta_flops = 0
segment_matmul.meta_bytes = 0
