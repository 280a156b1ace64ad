"""Dry-run of every (arch x shape) cell on the ``meta`` device: no card, no
storage.  The counterpart of the JAX package's ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k [--mesh one|single|multi|both] \\
        [--overrides '{"n_layers": 2}']
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --out dryrun.jsonl [--jobs 4] [--mesh both]

``--mesh one`` (the default): the step of ``specs.build_cell`` runs once
on ``meta``, the whole cell on one card, recording:
  * parameter, gradient and optimizer bytes, and each tensor rounded up to
    the CUDA caching allocator's 512-byte blocks (``state_alloc_bytes``,
    what ``torch.cuda.memory_allocated`` shows once the model and the
    optimizer state are built);
  * the peak of live bytes over the step
    (``torch.distributed._tools.mem_tracker.MemTracker``) and whether it
    fits one H100's 80 GB;
  * FLOPs: ``FlopCounterMode``'s count of the matmuls it sees, plus each
    hand-written kernel's by formula (their ``meta_flops``: the counter
    sees no custom kernel), plus the chunked attention's, whose loop the
    ``meta`` branch skips;
  * the bytes every op reads and writes (views excluded);
  * ``model_flops`` (the reference's formulas);
  * the arguments' bytes on one device under the 16x16 and 2x16x16
    placements of ``launch/sharding.py``;
  * a roofline at the H100's published peaks: 989e12 bf16 FLOP/s (the
    LMs) or 67e12 f32 FLOP/s (the GNNs, SASRec), 3.35e12 B/s.

``--mesh single`` (16x16, 256 chips), ``multi`` (2x16x16, 512) or
``both``: the cell as ONE DEVICE of that mesh, the reference's records.
The cell is built on a ``DeviceMesh`` over a process group of 256 or 512
ranks whose collectives move no data (the "fake" backend), this process
rank 0; the state is placed once (an LM's by ``steps.place_lm``, a decode
cell's cache by its placements; a GNN's replicated by
``steps.place_gnn``, its batch's node and edge arrays over every axis by
``steps.place_graph_batch``; SASRec's by ``steps.place_rec``, its batch
over the data axes) and the step runs under
``ShardCtx(mesh, data_axes(mesh))`` inside ``collectives.LocalCounter``,
which records rank 0's own work: its state bytes, its peak live bytes and
whether they fit 80 GB, its FLOPs (plus the kernels' ``meta_flops`` on
its local shards), its HBM bytes, its collectives (ops by kind, wire and
payload bytes, the top sites, the link and rate each group took) and a
roofline with a collective term.  The placements divide evenly or fall
back to replicated, so every rank runs the same program.  A fake group is
process-wide: each (cell, mesh) runs in a process of its own under
``--jobs``, and :func:`run_cell` starts and ends the group around one
record.  A decode record's state bytes include the rank's shards of the
KV cache (``cache_bytes``).  A GNN or SASRec record has the LM records'
fields, its roofline at the f32 peak: the kernels' regions
(``segment_matmul`` on the rank's node rows, ``dht_gather`` on its slice
of the item table) count their work on the local shards.

A cell that fails writes an ``error`` record; the command exits 1 if any
cell that is not skipped errs.  The reference's HLO parser
(``hlo.parse_hlo``) has no counterpart: there is no HLO.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from .collectives import (ALLOC_BLOCK, LINK_BYTES_PER_S, LocalCounter,
                          roofline_terms)

# NVIDIA's H100 SXM data sheet: dense peaks and HBM size
H100_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
H100_HBM_BYTES = 80e9
MESHES = {"one": ("one",), "single": ("16x16",), "multi": ("2x16x16",),
          "both": ("16x16", "2x16x16")}
TRAIN_KINDS = ("train", "gnn_full", "gnn_sampled", "gnn_batched",
               "rec_train")
TOP_SITES = 12


def _leaves(tree):
    """The tensors of a nest of tuples, lists, dicts and dataclasses."""
    import dataclasses
    if isinstance(tree, torch.nn.Module):
        return [p for _, p in tree.named_parameters()]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return _leaves([getattr(tree, f.name)
                        for f in dataclasses.fields(tree)])
    flat, _ = tree_flatten(tree)
    return [t for t in flat if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _alloc_bytes(t: torch.Tensor) -> int:
    return math.ceil(_nbytes(t) / ALLOC_BLOCK) * ALLOC_BLOCK


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of every tensor each op reads and writes (views,
    which move nothing, excluded)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in
                              _leaves((args, kwargs or {}, out)))
        return out


def _kernel_counters():
    """Each hand-written kernel's (and the chunked attention's) op whose
    ``meta_flops`` counts the work it answered on ``meta`` (and, for
    ``segment_matmul`` and ``dht_gather``, ``meta_bytes`` the bytes it
    reads)."""
    from ..kernels.dht_gather.ops import dht_gather
    from ..kernels.embedding_bag.ops import embedding_bag
    from ..kernels.flash_attention.bwd import flash_bwd_dkv, flash_bwd_dq
    from ..kernels.flash_attention.ops import flash_attention
    from ..kernels.segment_matmul.ops import segment_matmul
    from ..models.layers import attention_xla_chunked
    return {"flash_attention_fwd": flash_attention,
            "flash_attention_bwd_dq": flash_bwd_dq,
            "flash_attention_bwd_dkv": flash_bwd_dkv,
            "segment_matmul": segment_matmul,
            "dht_gather": dht_gather,
            "embedding_bag": embedding_bag,
            "attention_xla_chunked": attention_xla_chunked}


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor itself."""
    return getattr(t, "_local_tensor", t)


def _state_bytes(cell) -> dict:
    """Parameter, gradient, optimizer and (a decode cell's) KV-cache bytes
    of a cell's arguments (of their local shards, where they are placed);
    ``state_alloc_bytes`` all of them, each tensor in the allocator's
    blocks."""
    params = [_local(p) for p in _leaves(cell.args[0])]
    train = cell.kind in TRAIN_KINDS
    opt = [_local(t) for t in _leaves(cell.args[1])] if train else []
    cache = ([_local(t) for t in _leaves(cell.args[1])]
             if cell.kind == "decode" else [])
    return {"params": sum(p.numel() for p in params),
            "param_bytes": sum(_nbytes(p) for p in params),
            "grad_bytes": sum(_nbytes(p) for p in params) if train else 0,
            "opt_bytes": sum(_nbytes(t) for t in opt),
            "cache_bytes": sum(_nbytes(t) for t in cache),
            "state_alloc_bytes": sum(_alloc_bytes(t)
                                     for t in params + opt + cache)}


def _device_bytes(cell, argnums=None) -> int:
    """The cell's arguments' (those of ``argnums``, all by default) bytes
    on one device under their placements."""
    total = 0
    for i, (arg, pl) in enumerate(zip(cell.args, cell.placements)):
        if argnums is not None and i not in argnums:
            continue
        if isinstance(arg, torch.nn.Module):
            arg = dict(arg.named_parameters())
        if isinstance(arg, torch.Tensor):
            arg, pl = {"x": arg}, {"x": pl}
        elif not isinstance(arg, dict):     # a GraphBatch
            arg = {k: getattr(arg, k) for k in pl}
        for key, t in arg.items():
            sh = pl[key]
            if isinstance(t, tuple):        # gin-tu's overflow
                t, sh = dict(enumerate(t)), dict(enumerate(sh))
            if isinstance(t, dict):
                total += sum(x.element_size() * math.prod(
                    sh[n].local_shape(x.shape)) for n, x in t.items())
            elif isinstance(t, torch.Tensor):
                total += t.element_size() * math.prod(sh.local_shape(t.shape))
    return total


def measure(cell) -> dict:
    """Run ``cell`` once on ``meta`` under the counters: its bytes, peak,
    FLOPs and roofline."""
    from torch.distributed._tools.mem_tracker import MemTracker
    counters = _kernel_counters()
    _zero_counts(counters)
    tracker = MemTracker()
    tracker.track_external(*[a for a in cell.args
                             if isinstance(a, torch.nn.Module)],
                           *[t for a in cell.args
                             if not isinstance(a, torch.nn.Module)
                             for t in _leaves(a)])
    flop_counter, byte_counter = FlopCounterMode(display=False), ByteCounter()
    t0 = time.perf_counter()
    with tracker, flop_counter, byte_counter:
        cell.run()
    seconds = time.perf_counter() - t0
    peak = sum(v["Total"] for v in
               tracker.get_tracker_snapshot("peak").values())
    kernels, kernel_bytes = _kernel_counts(counters)
    counted = float(flop_counter.get_total_flops())
    flops = counted + sum(kernels.values())
    peak_flops = _peak_flops(cell)
    return {"run_s": seconds, **_state_bytes(cell),
            "peak_bytes": peak, "fits_h100_80gb": peak < H100_HBM_BYTES,
            "flops_counted": counted, "flops_kernels": kernels,
            "bytes_kernels": kernel_bytes,
            "flops": flops, "model_flops": cell.model_flops,
            "roofline": roofline_terms(
                flops, byte_counter.bytes + sum(kernel_bytes.values()),
                cell.model_flops, peak_flops)}


def _zero_counts(counters) -> None:
    for op in counters.values():
        op.meta_flops = 0
        if hasattr(op, "meta_bytes"):
            op.meta_bytes = 0


def _kernel_counts(counters):
    """({kernel: FLOPs}, {kernel: bytes read}) the kernels counted on
    ``meta``, the kernels without any left out."""
    return ({name: op.meta_flops for name, op in counters.items()
             if op.meta_flops},
            {name: op.meta_bytes for name, op in counters.items()
             if getattr(op, "meta_bytes", 0)})


def _peak_flops(cell) -> float:
    dtype = next(iter(_leaves(cell.args[0]))).dtype
    return H100_FLOPS["bfloat16" if dtype == torch.bfloat16 else "float32"]


def fake_group(world: int) -> None:
    """This process as rank 0 of a ``world``-rank group whose collectives
    move no data (``torch.distributed``'s "fake" backend)."""
    import torch.distributed as dist
    # registers the "fake" backend
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    if dist.is_initialized():
        raise RuntimeError("a process group is up: a mesh record needs a "
                           "process of its own")
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=dist.HashStore())


def _place(cell, mesh):
    """``cell``'s state placed once on ``mesh`` (a ``DeviceMesh``), and
    the ``ShardCtx`` its step runs under: the parameters and AdamW's
    moments by the family's rule (``steps.place_lm``, ``place_gnn``,
    ``place_rec``), a decode cell's cache by its placements.  An LM's
    batch stays global (each data rank takes its block); a GNN's and
    SASRec's is placed here, so the device holds only its shards."""
    from ..placement import ShardCtx
    from . import steps
    from .mesh import data_axes
    from .sharding import place_tensors
    dp = data_axes(mesh)
    sctx = ShardCtx(mesh, dp if len(dp) > 1 else dp[0])
    opt = cell.args[1] if cell.kind in TRAIN_KINDS else None
    if cell.kind.startswith("gnn"):
        steps.place_gnn(cell.args[0], opt, sctx)
        cell.args = cell.args[:2] + (
            steps.place_graph_batch(cell.args[2], sctx),)
    elif cell.kind.startswith("rec"):
        steps.place_rec(cell.args[0], opt, sctx)
        first = 2 if opt is not None else 1
        cell.args = cell.args[:first] + tuple(
            sctx.batch(t) for t in cell.args[first:])
    else:
        steps.place_lm(cell.args[0], opt, sctx)
    if cell.kind == "decode":
        cache = place_tensors(cell.args[1], cell.placements[1])
        cell.args[1].update(cache)
    return sctx


def _groups(stats, mesh) -> dict:
    """{group: {size, link, bytes_per_s, ops by kind, wire_bytes}} of the
    groups rank 0's collectives named, each under its mesh dimension's
    name."""
    names = {mesh.get_group(d).group_name: d for d in mesh.mesh_dim_names}
    out = {}
    for d in stats.details:
        key = names.get(d["group"], f"{d['group_size']} ranks")
        g = out.setdefault(key, {"size": d["group_size"], "link": d["link"],
                                 "bytes_per_s": LINK_BYTES_PER_S[d["link"]],
                                 "ops": {}, "wire_bytes": 0.0})
        g["ops"][d["kind"]] = g["ops"].get(d["kind"], 0) + 1
        g["wire_bytes"] += d["wire_bytes"]
    return out


def measure_mesh(cell, mesh) -> dict:
    """Place ``cell`` on ``mesh`` and run its step once as rank 0 under
    ``LocalCounter``: one device's bytes, peak, FLOPs, collectives and
    roofline."""
    from .mesh import n_chips
    sctx = _place(cell, mesh)
    counters = _kernel_counters()
    _zero_counts(counters)
    counter = LocalCounter()
    counter.track(*cell.args)
    state = _state_bytes(cell)
    t0 = time.perf_counter()
    with counter:
        cell.step(*cell.args, sctx=sctx)
    seconds = time.perf_counter() - t0
    kernels, kernel_bytes = _kernel_counts(counters)
    a = counter.analysis(sum(kernels.values()))
    hbm = a.hbm_bytes + sum(kernel_bytes.values())
    stats = a.collectives
    chips = n_chips(mesh)
    return {"trace_s": seconds, "chips": chips, "rank": 0, **state,
            "peak_bytes": a.peak_bytes,
            "fits_h100_80gb": a.peak_bytes < H100_HBM_BYTES,
            "flops_counted": counter.flops, "flops_kernels": kernels,
            "bytes_kernels": kernel_bytes,
            "flops": a.flops, "hbm_bytes": hbm,
            "model_flops": cell.model_flops,
            "collectives": {
                "ops": stats.ops, "wire_bytes": stats.wire_bytes,
                "payload_bytes": stats.payload_bytes,
                "wire_bytes_by_link": stats.wire_bytes_by_link,
                "groups": _groups(stats, mesh),
                "top_sites": a.top_collective_sites(TOP_SITES)},
            "top_byte_ops": a.top_byte_ops(TOP_SITES),
            "roofline": roofline_terms(a.flops, hbm,
                                       cell.model_flops, _peak_flops(cell),
                                       chips, collectives=stats)}


def _mesh_record(rec: dict, arch: str, shape: str, shape_of,
                 kw: dict) -> None:
    """Fill ``rec`` with the cell's record as one device of a mesh of
    ``shape_of`` (a ``MeshShape``)."""
    import torch.distributed as dist
    from .mesh import make_mesh
    from .specs import build_cell
    fake_group(math.prod(shape_of.sizes))
    try:
        mesh = make_mesh(shape_of, "cpu")
        cell = build_cell(arch, shape, mesh, **kw)
        rec.update(status="ok", kind=cell.kind, notes=cell.notes,
                   **measure_mesh(cell, mesh))
        del cell
        # the same placements reckoned from the mesh's shape alone
        cell = build_cell(arch, shape, shape_of, **kw)
        rec["placement_bytes"] = {
            "param_bytes": _device_bytes(cell, (0,)),
            "opt_bytes": (_device_bytes(cell, (1,))
                          if cell.kind in TRAIN_KINDS else 0)}
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape: str, skip_reason: Optional[str] = None, *,
             overrides: Optional[dict] = None,
             shape_overrides: Optional[dict] = None,
             mesh="one") -> dict:
    """One cell's record on one card (``mesh`` "one") or as one device of
    the "16x16" or "2x16x16" mesh (or of any ``MeshShape`` of axes
    ("data", "model") or ("pod", "data", "model")): ``status`` "ok",
    "skipped" (with the registry's ``reason``) or "error" (with the
    exception and its traceback)."""
    from .mesh import MeshShape, production_mesh_shape
    from .specs import build_cell
    rec = {"arch": arch, "shape": shape, "device": "meta",
           "mesh": "1 (one H100)" if mesh == "one" else str(mesh)}
    if skip_reason:
        rec.update(status="skipped", reason=skip_reason)
        return rec
    t0 = time.perf_counter()
    kw = dict(overrides=overrides, shape_overrides=shape_overrides)
    try:
        if mesh == "one":
            cell = build_cell(arch, shape,
                              MeshShape((1, 1), ("data", "model")), **kw)
            rec.update(status="ok", kind=cell.kind, notes=cell.notes,
                       **measure(cell))
            del cell
            rec["device_bytes"] = {}
            for multi in (False, True):
                placed = production_mesh_shape(multi_pod=multi)
                rec["device_bytes"][str(placed)] = _device_bytes(
                    build_cell(arch, shape, placed, **kw))
        else:
            if not isinstance(mesh, MeshShape):
                mesh = production_mesh_shape(multi_pod=mesh == "2x16x16")
            _mesh_record(rec, arch, shape, mesh, kw)
    except Exception as e:  # noqa: BLE001 - record the failure verbatim
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    rec["seconds"] = time.perf_counter() - t0
    return rec


def summary(rec: dict) -> str:
    """One line a record."""
    if rec["status"] != "ok":
        return json.dumps({k: v for k, v in rec.items() if k != "traceback"})
    gb = 1e9
    if "chips" in rec:
        state = rec["param_bytes"] + rec["grad_bytes"] + rec["opt_bytes"]
        return (f"OK {rec['arch']} {rec['shape']} {rec['mesh']} "
                f"state={state / gb:.3f}GB "
                f"peak={rec['peak_bytes'] / gb:.2f}GB "
                f"fits_h100_80gb={rec['fits_h100_80gb']} "
                f"tflops={rec['flops'] / 1e12:.2f} "
                f"wire={rec['collectives']['wire_bytes'] / gb:.2f}GB "
                f"dom={rec['roofline']['dominant']} "
                f"roofline={rec['roofline']['roofline_fraction']:.3f} "
                f"{rec['seconds']:.1f}s")
    state = rec["param_bytes"] + rec["grad_bytes"] + rec["opt_bytes"]
    return (f"OK {rec['arch']} {rec['shape']} params={rec['params']} "
            f"state={state / gb:.2f}GB "
            f"peak={rec['peak_bytes'] / gb:.2f}GB "
            f"fits_h100_80gb={rec['fits_h100_80gb']} "
            f"16x16={rec['device_bytes']['16x16'] / gb:.3f}GB "
            f"2x16x16={rec['device_bytes']['2x16x16'] / gb:.3f}GB "
            f"dom={rec['roofline']['dominant']} "
            f"roofline={rec['roofline']['roofline_fraction']:.3f} "
            f"{rec['seconds']:.1f}s")


def _run_one(task) -> dict:
    arch, shape, skip, mesh, overrides = task
    return run_cell(arch, shape, skip, mesh=mesh, overrides=overrides)


def cells_of(args) -> list:
    from ..configs.registry import all_cells, get
    if args.all:
        return list(all_cells())
    entry = get(args.arch)
    shapes = [args.shape] if args.shape else list(entry.shapes)
    return [(args.arch, s, entry.skip_shapes.get(s)) for s in shapes]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="meta", choices=["meta"],
                    help="the dry-run builds every cell on meta: no card")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in its own process")
    ap.add_argument("--mesh", default="one", choices=list(MESHES),
                    help="one card (one), or one device of 16x16 (single), "
                         "2x16x16 (multi) or both")
    ap.add_argument("--overrides", type=json.loads, default=None,
                    help='an LM config\'s fields as JSON, e.g. '
                         '\'{"n_layers": 2}\'')
    args = ap.parse_args(argv)
    if not args.all and not args.arch:
        ap.error("give --all or --arch")
    meshes = MESHES[args.mesh]
    tasks = [(a, s, skip, m, args.overrides) for a, s, skip in cells_of(args)
             for m in meshes]
    if args.jobs > 1:
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        # a fake group is process-wide: one mesh record a child
        per_child = None if meshes == ("one",) else 1
        with ctx.Pool(args.jobs, maxtasksperchild=per_child) as pool:
            records = pool.map(_run_one, tasks, chunksize=1)
    else:
        records = map(_run_one, tasks)
    out_f = open(args.out, "a") if args.out else None
    failed = 0
    try:
        for rec in records:
            print(summary(rec), flush=True)
            failed += rec["status"] == "error"
            if out_f:
                out_f.write(json.dumps(rec) + "\n")
                out_f.flush()
    finally:
        if out_f:
            out_f.close()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
