"""Per-device analysis of a sharded step: FLOPs, HBM bytes, live bytes
and the collective schedule of one rank.  The counterpart of the JAX
package's ``launch/hlo.py``.

The reference compiles a cell for the 16x16 or 2x16x16 mesh and walks
the partitioned HLO text (``parse_hlo``, ``analyze_hlo``).  The port has
no HLO to parse: the step runs eagerly, as rank 0 of a process group
whose collectives move no data (``torch.distributed``'s "fake" backend),
on ``meta`` tensors, and :class:`LocalCounter` watches every op that
rank's device would run.  What stands for what:

  * :class:`LocalCounter` is ``analyze_hlo``'s walk.  A
    ``TorchDispatchMode`` that returns ``NotImplemented`` for any op with
    a ``DTensor`` argument, so DTensor runs first and desugars it into the
    ops on the rank's local shards, which reach the mode.  DTensor's own
    shape propagation runs the op once more at global shapes under a
    ``FakeTensorMode`` it opens for that; an op seen while a fake mode is
    active that was not active on entry is that, and is not counted.
  * dot FLOPs: ``torch.utils.flop_counter``'s formulas on the local ops
    (the caller adds the hand-written kernels' ``meta_flops``, which
    their ``meta`` branches count on the local shards inside
    ``local_map``);
  * HBM bytes: every local op's inputs and outputs, views excluded (the
    one-card ``dryrun.ByteCounter``'s rule);
  * live bytes: each storage a local op creates, rounded up to the CUDA
    caching allocator's 512-byte blocks, held until it is freed, on top
    of the state the caller hands to :meth:`LocalCounter.track`; the peak
    is the device's peak;
  * collectives: every ``_c10d_functional`` (and ``_dtensor``) collective
    under the reference's kind names, with its result bytes and shapes,
    the size and ranks of the group it names, the link those ranks share,
    and its site; :func:`collective_wire` is ``hlo._collective_wire``,
    applied to the result bytes as the reference applies it;
  * :class:`CollectiveStats` and :class:`MeshAnalysis` keep
    ``hlo.CollectiveStats``'s and ``hlo.HloAnalysis``'s field names.
    There is no ``unknown_trip_whiles``: an eager trace runs every
    iteration of every loop, so no loop is counted once;
  * :func:`roofline_terms` is ``hlo.roofline_terms`` (and the one-card
    dry-run's), at rates given as arguments, with a collective term.

A site is the module path of ``torch.distributed._tools.mod_tracker``'s
``ModTracker`` (which follows activation checkpointing's recomputation
and a second forward of the model), " (bw)" in the backward, then the
innermost function of the port that issued the collective; in the
backward, where no function of the port is on the stack, the autograd
node that did.

The mesh is a CPU ``DeviceMesh`` over the fake group, so DTensor moves a
shard from one tensor dimension to another as gloo does, by an
all-gather and a chunk, where NCCL would send an all-to-all.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map_only
from torch.utils.weak import WeakIdKeyDictionary

# NVIDIA's H100 SXM data sheet: HBM3 at 3.35 TB/s; NVLink 900 GB/s a
# GPU, 450 GB/s each way, among the 8 GPUs of a node (DGX H100)
H100_HBM_BYTES_PER_S = 3.35e12
H100_NVLINK_BYTES_PER_S = 450e9
# one 400 Gb/s InfiniBand NIC a GPU between nodes (DGX H100: eight
# ConnectX-7 at 400 Gb/s): 50 GB/s
NIC_BYTES_PER_S = 50e9
NODE_GPUS = 8
LINK_BYTES_PER_S = {"nvlink": H100_NVLINK_BYTES_PER_S,
                    "nic": NIC_BYTES_PER_S}
ALLOC_BLOCK = 512   # the CUDA caching allocator rounds a block up to this

# op name (its overload packet's) -> the reference's collective kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
    "isend": "collective-permute", "irecv": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "_dtensor")
# bookkeeping of the functional collectives: no device work
_NO_WORK = ("wait_tensor", "_wrap_tensor_autograd")
# the port's plumbing, skipped when naming the function behind a site
_PLUMBING = ("repro_torch/placement.py", "repro_torch/launch/collectives.py",
             "repro_torch/devices.py")
_PLUMBING_FUNCS = ("ShardCtx.",)


def collective_wire(kind: str, nbytes: int, p: int) -> float:
    """Bytes one device sends for a collective whose result is ``nbytes``
    over a group of ``p``, by ring formulas (``hlo._collective_wire``)."""
    frac = (p - 1) / p
    if kind == "all-gather":
        return nbytes * frac
    if kind == "all-reduce":
        return 2 * nbytes * frac
    if kind == "reduce-scatter":
        return nbytes * (p - 1)
    if kind == "all-to-all":
        return nbytes * frac
    return float(nbytes)  # collective-permute


def link_of(ranks) -> str:
    """"nvlink" when every rank lies in one node of ``NODE_GPUS``
    consecutive ranks, "nic" otherwise."""
    return ("nvlink" if len({r // NODE_GPUS for r in ranks}) == 1
            else "nic")


@dataclasses.dataclass
class CollectiveStats:
    ops: Dict[str, int]
    wire_bytes: float
    payload_bytes: float
    details: List[dict] = dataclasses.field(default_factory=list)
    # wire bytes by the link their group takes ("nvlink", "nic")
    wire_bytes_by_link: Dict[str, float] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class MeshAnalysis:
    """One device's share of a step (``hlo.HloAnalysis``'s fields where
    the meaning is the same)."""
    flops: float
    hbm_bytes: float
    collectives: CollectiveStats
    peak_bytes: int = 0
    flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_by_site: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)

    def top_collective_sites(self, k=12):
        return sorted(self.coll_by_site.items(), key=lambda kv: -kv[1])[:k]

    def top_byte_ops(self, k=12):
        return sorted(self.bytes_by_op.items(), key=lambda kv: -kv[1])[:k]


def roofline_terms(flops: float, hbm_bytes: float, model_flops: float,
                   peak_flops: float, chips: int = 1, *,
                   collectives: Optional[CollectiveStats] = None,
                   hbm_bytes_per_s: float = H100_HBM_BYTES_PER_S,
                   link_bytes_per_s: Optional[Dict[str, float]] = None
                   ) -> dict:
    """The compute, memory and collective terms in seconds (one device's
    FLOPs, bytes and wire bytes over its rates: ``peak_flops``,
    ``hbm_bytes_per_s``, and each link's rate in ``link_bytes_per_s``,
    ``LINK_BYTES_PER_S`` by default), the dominant one, and the share of
    the bound the model's useful FLOPs would take at peak
    (``hlo.roofline_terms``).  Without ``collectives`` (one card) the
    collective term is 0."""
    rates = LINK_BYTES_PER_S if link_bytes_per_s is None else link_bytes_per_s
    wire = collectives.wire_bytes if collectives else 0.0
    t_compute = flops / peak_flops
    t_memory = hbm_bytes / hbm_bytes_per_s
    t_collective = sum(b / rates[link] for link, b in
                       collectives.wire_bytes_by_link.items()
                       ) if collectives else 0.0
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_collective), key=lambda kv: kv[1])[0]
    bound = max(t_compute, t_memory, t_collective)
    ideal = model_flops / chips / peak_flops
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_collective, "dominant": dominant,
            "flops_per_device": flops, "bytes_per_device": hbm_bytes,
            "coll_wire_bytes_per_device": wire,
            "peak_flops": peak_flops, "model_flops": model_flops,
            "useful_flops_fraction": model_flops / max(flops * chips, 1.0),
            "roofline_fraction": ideal / bound if bound > 0 else 0.0,
            "collective_ops": dict(collectives.ops) if collectives else {}}


def _tensors(tree) -> List[torch.Tensor]:
    flat, _ = tree_flatten(tree)
    return [t for t in flat if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storages(t: torch.Tensor):
    """The storages behind ``t`` (a wrapper subclass's inner tensors')."""
    if hasattr(t, "__tensor_flatten__"):   # a DTensor, an async result
        names, _ = t.__tensor_flatten__()
        return [s for n in names if isinstance(getattr(t, n), torch.Tensor)
                for s in _storages(getattr(t, n))]
    return [t.untyped_storage()]


def _waited(t) -> torch.Tensor:
    """The result of an ``AsyncCollectiveTensor``: waited for on a device,
    its own tensor on ``meta`` (where the wait's kernel would copy it)."""
    return t.elem if t.elem.is_meta else t.wait()


def _group(func, args, kwargs):
    """The process group a collective names (its ``group_name``)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a.name for a in func._schema.arguments]
    i = names.index("group_name")
    name = args[i] if i < len(args) else kwargs["group_name"]
    return _resolve_process_group(name) if isinstance(name, str) else name


def _site_function() -> str:
    """The innermost function of the port (outside the sharding plumbing)
    on the stack, then the autograd node running, if any."""
    name, f = "?", sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename.replace("\\", "/")
        fn = getattr(f.f_code, "co_qualname", f.f_code.co_name)
        if "repro_torch/" in path and not path.endswith(_PLUMBING) \
                and not fn.startswith(_PLUMBING_FUNCS):
            name = fn
            break
        f = f.f_back
    node = torch._C._current_autograd_node()
    return name if node is None else f"{name}/{node.name()}"


class LocalCounter(TorchDispatchMode):
    """Counts the ops one rank runs on its local shards (see the module's
    docstring): ``flops``, ``hbm_bytes``, ``live_bytes`` and
    ``peak_bytes``, and each collective in ``details``.  Enter it around
    the step; :meth:`analysis` gives the :class:`MeshAnalysis`."""

    def __init__(self):
        super().__init__()
        from torch.distributed._tools.mod_tracker import ModTracker
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.flops_by_op: Dict[str, float] = {}
        self.bytes_by_op: Dict[str, float] = {}
        self.details: List[dict] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._held = WeakIdKeyDictionary()
        self._mods = ModTracker()
        self._fake_on_entry = None

    # ------------------------------------------------------------ memory
    def _release(self, n: int) -> None:
        self.live_bytes -= n

    def _hold(self, t: torch.Tensor) -> None:
        for st in _storages(t):
            if st in self._held:
                continue
            n = math.ceil(st.nbytes() / ALLOC_BLOCK) * ALLOC_BLOCK
            self._held[st] = n
            weakref.finalize(st, self._release, n)
            self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def track(self, *trees) -> None:
        """Hold the storages of the tensors (a DTensor's local shard) in
        ``trees`` (nests of containers, or modules), which exist before
        the step: its state."""
        for tree in trees:
            if isinstance(tree, torch.nn.Module):
                tree = [*tree.parameters(), *tree.buffers()]
            for t in _tensors(tree):
                self._hold(t)

    # -------------------------------------------------------- the mode
    def __enter__(self):
        from torch._guards import active_fake_mode
        self._fake_on_entry = active_fake_mode()
        self._mods.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._mods.__exit__(*exc)
        return out

    def _site(self) -> str:
        parents = [p for p in self._mods.parents if p != "Global"]
        path = max(parents, key=len) if parents else "Global"
        bw = " (bw)" if self._mods.is_bw else ""
        return f"{path}{bw}:{_site_function()}"

    def _collective(self, func, name: str, args, kwargs, out) -> None:
        from torch.distributed import get_process_group_ranks
        kind = _KINDS.get(name)
        if kind is None:
            raise NotImplementedError(f"no kind for collective {func}")
        pg = _group(func, args, kwargs or {})
        ranks = get_process_group_ranks(pg)
        p = len(ranks)
        nbytes = sum(_nbytes(t) for t in _tensors(out))
        wire = collective_wire(kind, nbytes, p)
        self.details.append({"kind": kind, "op": name, "bytes": nbytes,
                             "shapes": [tuple(t.shape) for t in _tensors(out)],
                             "group": pg.group_name, "group_size": p,
                             "link": link_of(ranks), "wire_bytes": wire,
                             "site": self._site()})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed._functional_collectives import (
            AsyncCollectiveTensor)
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func.namespace == "_c10d_functional" \
                and func._overloadpacket.__name__ in _NO_WORK \
                and args[0].is_meta:
            # on a device these return their input; their meta kernels a
            # new tensor, which the device never holds
            return args[0]
        if any(issubclass(t, AsyncCollectiveTensor) for t in types):
            args, kwargs = tree_map_only(AsyncCollectiveTensor, _waited,
                                         (args, kwargs or {}))
        out = func(*args, **(kwargs or {}))
        if active_fake_mode() is not self._fake_on_entry:
            return out   # DTensor's shape propagation at global shapes
        packet = func._overloadpacket
        name = packet.__name__
        namespace = func.namespace
        if namespace in _COLLECTIVE_NAMESPACES and name in _NO_WORK:
            return out
        from torch.utils.flop_counter import flop_registry
        formula = flop_registry.get(packet)
        if formula is not None:
            f = float(formula(*args, **(kwargs or {}), out_val=out))
            self.flops += f
            self.flops_by_op[name] = self.flops_by_op.get(name, 0.0) + f
        if not func.is_view:
            b = sum(_nbytes(t) for t in _tensors((args, kwargs or {}, out)))
            self.hbm_bytes += b
            self.bytes_by_op[name] = self.bytes_by_op.get(name, 0.0) + b
        if namespace in _COLLECTIVE_NAMESPACES:
            self._collective(func, name, args, kwargs, out)
        for t in _tensors(out):
            self._hold(t)
        return out

    # --------------------------------------------------------- results
    def collective_stats(self) -> CollectiveStats:
        stats = CollectiveStats({}, 0.0, 0.0, list(self.details))
        for d in self.details:
            stats.ops[d["kind"]] = stats.ops.get(d["kind"], 0) + 1
            stats.wire_bytes += d["wire_bytes"]
            stats.payload_bytes += d["bytes"]
            stats.wire_bytes_by_link[d["link"]] = (
                stats.wire_bytes_by_link.get(d["link"], 0.0)
                + d["wire_bytes"])
        return stats

    def analysis(self, extra_flops: float = 0.0) -> MeshAnalysis:
        """The :class:`MeshAnalysis`, ``extra_flops`` (the hand-written
        kernels') added to the counted FLOPs."""
        coll_by_site: Dict[str, float] = {}
        for d in self.details:
            site = f"{d['kind']}:{d['site']}"
            coll_by_site[site] = coll_by_site.get(site, 0.0) + d["wire_bytes"]
        return MeshAnalysis(self.flops + extra_flops, self.hbm_bytes,
                            self.collective_stats(), self.peak_bytes,
                            dict(self.flops_by_op), coll_by_site,
                            dict(self.bytes_by_op))


def _filled(name: str, args, rank: int):
    """The output a collective ``name`` would write if every rank of its
    group held this rank's input (``rank`` its index in the group)."""
    x = args[0]
    if name in ("all_gather_into_tensor", "all_gather_into_tensor_out"):
        return torch.cat([x] * args[1])
    if name in ("all_reduce", "broadcast"):
        return x.clone()
    if name in ("all_reduce_", "broadcast_"):
        return x
    if name == "reduce_scatter_tensor":
        return x.chunk(args[2])[rank].clone()
    if name == "all_to_all_single":
        out = x.new_zeros((sum(args[1]),) + tuple(x.shape[1:])) \
            if args[1] else torch.empty_like(x)
        n = min(out.shape[0], x.shape[0])
        out[:n] = x[:n]
        return out
    if name == "shard_dim_alltoall":
        p = args[-1]
        return torch.cat([x] * p, args[1]).chunk(p, args[2])[rank].clone()
    if name == "all_gather_into_tensor_coalesced":
        return [torch.cat([t] * args[1]) for t in x]
    if name == "reduce_scatter_tensor_coalesced":
        return [t.chunk(args[2])[rank].clone() for t in x]
    if name == "all_reduce_coalesced":
        return [t.clone() for t in x]
    if name == "all_reduce_coalesced_":
        return x
    raise NotImplementedError(f"no filled output for collective {name}")


class FilledCollectives(TorchDispatchMode):
    """Runs a rank of a group whose collectives move no data (the "fake"
    backend) on real tensors: each functional collective writes the
    output it would give if every rank of its group held this rank's data
    (an all-gather repeats the input, an all-reduce keeps it, a
    reduce-scatter keeps this rank's block, an all-to-all keeps what
    stays), so no op reads memory that nothing wrote.  The group is never
    called; a collective without such a rule raises."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func.namespace not in _COLLECTIVE_NAMESPACES:
            return func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__
        if name == "wait_tensor":
            return args[0]
        if name in _NO_WORK:
            return func(*args, **(kwargs or {}))
        pg = _group(func, args, kwargs or {})
        if name == "shard_dim_alltoall":
            args = (*args[:3], pg.size())
        return _filled(name, args, pg.rank())
