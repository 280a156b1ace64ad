"""The rule that turns a sharding spec into DTensor placements, and the
:class:`ShardCtx` the models run under, shared by the models (the LM, the
GNNs, SASRec) and the launch layer (``launch.sharding``, ``launch.steps``).

A *spec* has one entry a tensor dimension, as a ``PartitionSpec`` does:
an axis name, a tuple of axis names, or None.  Its placements have one
entry a mesh dimension: ``Shard(d)`` on every mesh dimension whose axis
shards tensor dimension d, ``Replicate()`` elsewhere.  A tensor
dimension over ("pod", "data") is ``Shard(d)`` on both, pod first, which
is JAX's row-major order.  An axis that does not divide its dimension
falls back to replicated (:func:`fix_divisibility`).

A mesh here is a ``DeviceMesh`` or anything with a ``shape`` mapping axis
names to sizes (``launch.mesh.MeshShape``, when only sizes are reckoned).

A dimension over every axis (the GNNs' node and edge arrays, the
reference's ``flat_shard``) is ``Shard(0)`` on every mesh dimension:
DTensor splits over the first mesh dimension, then each part over the
next, so rank (d, m) of a ("data", "model") mesh holds block d·M + m,
JAX's row-major flattening of the axes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from .devices import is_dtensor

Spec = Tuple[Any, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``MeshShape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return dict(mesh.shape)
    return dict(zip(names, mesh.shape))


def axis_size(mesh, axis) -> int:
    """The number of devices ``axis`` (a name, a tuple of names, or None)
    spans on ``mesh``."""
    sizes = mesh_axes(mesh)
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def fix_divisibility(spec: Spec, shape, mesh) -> Spec:
    """``spec`` with every axis that does not divide its dimension
    dropped (that dimension replicated), cut to the tensor's rank."""
    fixed = []
    for i, axis in enumerate(spec):
        if axis is None or i >= len(shape):
            fixed.append(None)
        elif shape[i] % axis_size(mesh, axis) == 0:
            fixed.append(axis)
        else:
            fixed.append(None)
    return tuple(fixed)


def placements(spec: Spec, mesh) -> tuple:
    """One DTensor placement a mesh dimension for ``spec``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh_axes(mesh):
        dims = [d for d, axis in enumerate(spec) if axis == name
                or (isinstance(axis, (tuple, list)) and name in axis)]
        if len(dims) > 1:
            raise ValueError(f"axis {name!r} shards dimensions {dims}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def dtensor_types():
    """(DTensor, Partial, Replicate, Shard), imported when first needed."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    return DTensor, Partial, Replicate, Shard


def all_reduce(t, op: str, group):
    """``t`` reduced by ``op`` ("sum", "max") over ``group``: a functional
    collective, which ``launch.collectives.LocalCounter`` records."""
    f = torch.ops._c10d_functional
    return f.wait_tensor(f.all_reduce(t.contiguous(), op, group.group_name))


def all_gather(t, dim: int, group):
    """The ranks' ``t`` of ``group`` concatenated along ``dim``, in rank
    order (a functional all-gather)."""
    f = torch.ops._c10d_functional
    moved = t.movedim(dim, 0).contiguous()
    out = f.wait_tensor(f.all_gather_into_tensor(moved, group.size(),
                                                 group.group_name))
    return out.movedim(0, dim)


def reduce_scatter(t, dim: int, group):
    """The sum over ``group`` of ``t``, this rank keeping its block of
    ``dim`` (a functional reduce-scatter)."""
    f = torch.ops._c10d_functional
    moved = t.movedim(dim, 0).contiguous()
    out = f.wait_tensor(f.reduce_scatter_tensor(moved, "sum", group.size(),
                                                group.group_name))
    return out.movedim(0, dim)


def all_to_all(t, group):
    """Block i of ``t``'s dimension 0 (one block a rank of ``group``) sent
    to rank i; block j of the result is what rank j sent (a functional
    all-to-all)."""
    f = torch.ops._c10d_functional
    splits = [t.shape[0] // group.size()] * group.size()
    return f.wait_tensor(f.all_to_all_single(t.contiguous(), splits, splits,
                                             group.group_name))


def _own_block(t, dim: int, group):
    return t.chunk(group.size(), dim)[group.rank()]


def _trade_d(t, group, d_l: int):
    """(R, D) rows, D read as (O, p, d_l) -> (p·R, O·d_l): sub-block j of
    the p goes to rank j of ``group``, whose rows come back in rank
    order."""
    p = group.size()
    R, D = t.shape
    x = t.reshape(R, D // (p * d_l), p, d_l).permute(2, 0, 1, 3)
    return all_to_all(x, group).reshape(p * R, D // p)


def _trade_rows(t, group, d_l: int):
    """The inverse of :func:`_trade_d`: (p·R, O·d_l) -> (R, O·p·d_l)."""
    p = group.size()
    R, D = t.shape[0] // p, t.shape[1]
    y = all_to_all(t.reshape(p, R, D // d_l, d_l), group)
    return y.permute(1, 2, 0, 3).reshape(R, D * p)


def _to_d(t, groups, d_l):
    for g in reversed(groups):
        t = _trade_d(t, g, d_l)
    return t


def _to_rows(t, groups, d_l):
    for g in groups:
        t = _trade_rows(t, g, d_l)
    return t


class _Reduce(torch.autograd.Function):
    """All-reduce over the groups forward, identity backward: a sum of
    partial products whose result every rank then uses alike."""

    @staticmethod
    def forward(ctx, t, op, groups):
        for g in groups:
            t = all_reduce(t, op, g)
        return t

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _ReduceGrad(torch.autograd.Function):
    """Identity forward, all-reduce over the groups backward: the input of
    products whose gradients are partial over the groups."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        for g in ctx.groups:
            grad = all_reduce(grad, "sum", g)
        return grad, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward (the innermost group first);
    backward, each group's block of the gradient: reduce-scattered where
    ``summed`` (the ranks' gradients are partial sums), taken where not
    (they are the same)."""

    @staticmethod
    def forward(ctx, t, dim, groups, summed):
        ctx.dim, ctx.groups, ctx.summed = dim, groups, summed
        for g in reversed(groups):
            t = all_gather(t, dim, g)
        return t

    @staticmethod
    def backward(ctx, grad):
        for g, s in zip(ctx.groups, ctx.summed):
            grad = (reduce_scatter(grad, ctx.dim, g) if s
                    else _own_block(grad, ctx.dim, g))
        return grad, None, None, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter along ``dim`` forward, all-gather backward."""

    @staticmethod
    def forward(ctx, t, dim, groups):
        ctx.dim, ctx.groups = dim, groups
        for g in groups:
            t = reduce_scatter(t, dim, g)
        return t

    @staticmethod
    def backward(ctx, grad):
        for g in reversed(ctx.groups):
            grad = all_gather(grad, ctx.dim, g)
        return grad, None, None


class _Trade(torch.autograd.Function):
    """(R, D) rows of a token block -> (P·R, D/P): every token of the P
    ranks' blocks, this rank's block of D (an all-to-all a group, the
    innermost first); ``inverse`` the other way.  Each is the other's
    backward."""

    @staticmethod
    def forward(ctx, t, groups, d_l, inverse):
        ctx.groups, ctx.d_l, ctx.inverse = groups, d_l, inverse
        return (_to_rows if inverse else _to_d)(t, groups, d_l)

    @staticmethod
    def backward(ctx, grad):
        back = _to_d if ctx.inverse else _to_rows
        return back(grad, ctx.groups, ctx.d_l), None, None, None


def shard_axes(placements, mesh, dim: int) -> tuple:
    """The names of the mesh dimensions whose placement shards tensor
    dimension ``dim``, in mesh order (the first the outermost)."""
    return tuple(name for name, p in zip(mesh_axes(mesh), placements)
                 if p.is_shard(dim))


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Activation placements threaded through the models: the reference's
    GSPMD hints as DTensor redistributions, and the explicit regions
    (``local``) where an op runs on each rank's local shards.  ``mesh`` is
    a ``DeviceMesh``; ``dp`` the data-parallel axis name or names
    (("pod", "data") folds the pod axis into data); ``model`` the
    tensor-parallel axis."""
    mesh: Any
    dp: Any
    model: str = "model"

    @property
    def dp_axes(self) -> tuple:
        return self.dp if isinstance(self.dp, tuple) else (self.dp,)

    @property
    def dp_size(self) -> int:
        sizes = mesh_axes(self.mesh)
        return math.prod(sizes[a] for a in self.dp_axes)

    def data_rank(self) -> int:
        """This rank's index among the data shards, row-major over the
        data axes (JAX's order)."""
        sizes, r = mesh_axes(self.mesh), 0
        for a in self.dp_axes:
            r = r * sizes[a] + self.mesh.get_local_rank(a)
        return r

    def placements(self, shape, *spec) -> tuple:
        """``spec``'s placements for ``shape``, an axis that does not
        divide its dimension dropped (replicated), as the reference's
        ``cs``."""
        return placements(fix_divisibility(spec, shape, self.mesh),
                          self.mesh)

    def cs(self, x, *spec):
        """``x`` redistributed to ``spec``'s placements; identity on a
        plain tensor."""
        if not is_dtensor(x):
            return x
        pl = self.placements(x.shape, *spec)
        return x if tuple(x.placements) == pl else x.redistribute(
            self.mesh, pl)

    def replicate(self, x):
        return self.cs(x, *([None] * x.dim()))

    def batch(self, x):
        """A global (B, ...) tensor, the same on every rank, as a DTensor
        of rows over the data axes: each data rank keeps its contiguous
        block (every rank keeps all rows when B does not divide)."""
        pl = self.placements(x.shape, self.dp, *([None] * (x.dim() - 1)))
        n = self.dp_size if any(p.is_shard() for p in pl) else 1
        rows = x.shape[0] // n
        r = self.data_rank() if n > 1 else 0
        return dtensor_types()[0].from_local(
            x[r * rows:(r + 1) * rows], self.mesh, pl, run_check=False)

    # ------------------------------------------ every axis (GNN arrays)
    @property
    def rows_pl(self) -> tuple:
        """Placements of a tensor whose dimension 0 is split over every
        mesh axis (``Shard(0)`` on each mesh dimension)."""
        return (dtensor_types()[3](0),) * self.mesh.ndim

    @property
    def replicated_pl(self) -> tuple:
        return (dtensor_types()[2](),) * self.mesh.ndim

    @property
    def partial_pl(self) -> tuple:
        """Placements of per-rank partial sums over every mesh axis."""
        return (dtensor_types()[1](),) * self.mesh.ndim

    def implicit(self):
        """The context in which plain tensors (a model's constants: RBF
        centres, Bessel orders, the identity) act as replicated DTensors,
        which the GNN and SASRec forwards under a context need.  Autograd
        keeps those constants plain, so the backward runs in it too.  Inside
        one already open it does nothing (``implicit_replication`` would
        switch the flag off on its way out)."""
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import implicit_replication
        if DTensor._op_dispatcher._allow_implicit_replication:
            return contextlib.nullcontext()
        return implicit_replication()

    def grad_placements(self, act_placements) -> tuple:
        """The placements of the gradient of a replicated parameter used
        with activations placed ``act_placements``: partial sums over
        every mesh dimension that splits the activations, replicated over
        the others (where every rank computes the same gradient)."""
        _, Partial, Replicate, _ = dtensor_types()
        return tuple(Partial() if p.is_shard() else Replicate()
                     for p in act_placements)

    # ------------------------------- one mesh axis (local_map regions)
    # These act on a rank's local tensors (inside a ``local_map`` region,
    # or on ``to_local()`` shards); each takes the axes that split the
    # dimension in question, in mesh order, and skips an axis of one rank.
    # Each is an autograd Function over the functional collectives (which
    # ``launch.collectives.LocalCounter`` records), its backward the
    # collective that carries the gradient back.
    def _groups(self, axes):
        return [self.mesh.get_group(a) for a in axes
                if mesh_axes(self.mesh)[a] > 1]

    def block(self, n: int, axes) -> slice:
        """The block of a dimension of ``n`` this rank holds when ``axes``
        split it as ``Shard`` does (the first axis outermost); the whole
        dimension when ``axes`` is empty, where the placement fell back
        to replicated."""
        sizes, index = mesh_axes(self.mesh), 0
        for a in axes:
            n //= sizes[a]
            index = index * sizes[a] + self.mesh.get_local_rank(a)
        return slice(index * n, (index + 1) * n)

    def reduce(self, t, axes, op: str = "sum"):
        """``t`` all-reduced by ``op`` over each of ``axes``; its gradient
        passes unchanged (every rank uses the reduced ``t`` alike)."""
        groups = self._groups(axes)
        return _Reduce.apply(t, op, groups) if groups else t

    def reduce_grad(self, t, axes):
        """``t`` itself, its gradient all-reduced over ``axes``: the input
        of products on blocks that ``axes`` split, each rank's gradient a
        partial sum."""
        groups = self._groups(axes)
        return _ReduceGrad.apply(t, groups) if groups else t

    def gather(self, t, axes, dim: int, summed=None):
        """The blocks of ``dim`` that ``axes`` split, all-gathered whole
        (the innermost axis first).  The gradient is reduce-scattered back
        over the axes in ``summed`` (all of ``axes`` by default: each
        rank's a partial sum) and this rank's block is taken over the
        others."""
        axes = [a for a in axes if mesh_axes(self.mesh)[a] > 1]
        if not axes:
            return t
        summed = axes if summed is None else summed
        return _Gather.apply(
            t, dim, self._groups(axes), tuple(a in summed for a in axes))

    def scatter(self, t, axes, dim: int = 0):
        """``t`` summed over ``axes``, this rank keeping its block of
        ``dim`` as ``Shard(dim)`` on those axes places it; the gradient
        all-gathered."""
        groups = self._groups(axes)
        return _Scatter.apply(t, dim, groups) if groups else t

    def to_d_blocks(self, t, axes):
        """(R, D): this rank's block of R rows (``axes`` split the rows) ->
        (P·R, D/P): every rank's rows, in order, and this rank's block of
        D as ``axes`` split it (an all-to-all over each axis).  The
        gradient goes back the other way (:meth:`to_row_blocks`)."""
        groups = self._groups(axes)
        if not groups:
            return t
        n = math.prod(g.size() for g in groups)
        return _Trade.apply(t, groups, t.shape[1] // n, False)

    def to_row_blocks(self, t, axes):
        """The inverse of :meth:`to_d_blocks`: (P·R, D/P) -> (R, D)."""
        groups = self._groups(axes)
        if not groups:
            return t
        return _Trade.apply(t, groups, t.shape[1], True)

    def local(self, fn, outs, ins, grads=None):
        """``fn`` on each rank's local shards (``local_map``): ``outs``
        lists the placements of each output, ``ins`` of each input (the
        inputs are redistributed to them first) and ``grads`` of each
        input's gradient (``ins`` when None)."""
        from torch.distributed.tensor.experimental import local_map
        outs = [list(p) for p in outs]
        return local_map(
            fn, out_placements=outs[0] if len(outs) == 1 else tuple(outs),
            in_placements=tuple(list(p) for p in ins),
            in_grad_placements=None if grads is None else tuple(
                list(p) for p in grads),
            device_mesh=self.mesh, redistribute_inputs=True)


def maybe_implicit(sctx):
    """``sctx.implicit()``, or no context without one."""
    return contextlib.nullcontext() if sctx is None else sctx.implicit()
