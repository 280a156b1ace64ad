"""Dry-run of every (arch x shape) cell on the ``meta`` device: no card, no
storage.  The counterpart of the JAX package's ``launch/dryrun.py`` and of
``launch/hlo.py``'s ``roofline_terms``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --out dryrun.jsonl [--jobs 4]

For each cell the step of ``specs.build_cell`` runs once on ``meta``, the
whole cell on one card, recording:
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

A cell that fails writes an ``error`` record; the command exits 1 if any
cell that is not skipped errs.  The reference's HLO parser (``hlo.py``'s
``parse_hlo`` and ``analyze_hlo``, the collective schedule) has no
counterpart here: the sharded step's collectives are counted by
``torch.distributed.tensor.debug.CommDebugMode`` in the sharding tests.
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

# NVIDIA's H100 SXM data sheet: dense peaks, HBM rate and size
H100_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
H100_HBM_BYTES_PER_S = 3.35e12
H100_HBM_BYTES = 80e9
ALLOC_BLOCK = 512   # the CUDA caching allocator rounds a block up to this


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
    ``meta_flops`` counts the work it answered on ``meta``."""
    from ..kernels.embedding_bag.ops import embedding_bag
    from ..kernels.flash_attention.bwd import flash_bwd_dkv, flash_bwd_dq
    from ..kernels.flash_attention.ops import flash_attention
    from ..kernels.segment_matmul.ops import segment_matmul
    from ..models.layers import attention_xla_chunked
    return {"flash_attention_fwd": flash_attention,
            "flash_attention_bwd_dq": flash_bwd_dq,
            "flash_attention_bwd_dkv": flash_bwd_dkv,
            "segment_matmul": segment_matmul,
            "embedding_bag": embedding_bag,
            "attention_xla_chunked": attention_xla_chunked}


def roofline_terms(flops: float, hbm_bytes: float, model_flops: float,
                   peak_flops: float, chips: int = 1) -> dict:
    """The compute and memory terms in seconds at the H100's peaks (no
    collective term: one card), the dominant one, and the share of the
    bound the model's useful FLOPs would take at peak."""
    t_compute = flops / peak_flops
    t_memory = hbm_bytes / H100_HBM_BYTES_PER_S
    bound = max(t_compute, t_memory)
    ideal = model_flops / chips / peak_flops
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "dominant": "compute" if t_compute >= t_memory else "memory",
            "flops_per_device": flops, "bytes_per_device": hbm_bytes,
            "peak_flops": peak_flops, "model_flops": model_flops,
            "useful_flops_fraction": model_flops / max(flops * chips, 1.0),
            "roofline_fraction": ideal / bound if bound > 0 else 0.0}


def _state_bytes(cell) -> dict:
    """Parameter, gradient and optimizer bytes of a cell's arguments."""
    params = _leaves(cell.args[0])
    train = cell.kind in ("train", "gnn_full", "gnn_sampled", "gnn_batched",
                          "rec_train")
    opt = _leaves(cell.args[1]) if train else []
    return {"params": sum(p.numel() for p in params),
            "param_bytes": sum(_nbytes(p) for p in params),
            "grad_bytes": sum(_nbytes(p) for p in params) if train else 0,
            "opt_bytes": sum(_nbytes(t) for t in opt),
            "state_alloc_bytes": sum(_alloc_bytes(t) for t in params + opt)}


def _device_bytes(cell) -> int:
    """The cell's arguments' bytes on one device under their placements."""
    total = 0
    for arg, pl in zip(cell.args, cell.placements):
        if isinstance(arg, torch.nn.Module):
            arg = dict(arg.named_parameters())
        if isinstance(arg, torch.Tensor):
            arg, pl = {"x": arg}, {"x": pl}
        elif not isinstance(arg, dict):     # a GraphBatch
            arg = {k: getattr(arg, k) for k in pl}
        for key, t in arg.items():
            sh = pl[key]
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
    for op in counters.values():
        op.meta_flops = 0
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
    kernels = {name: op.meta_flops for name, op in counters.items()
               if op.meta_flops}
    counted = float(flop_counter.get_total_flops())
    flops = counted + sum(kernels.values())
    dtype = next(iter(_leaves(cell.args[0]))).dtype
    peak_flops = H100_FLOPS["bfloat16" if dtype == torch.bfloat16
                            else "float32"]
    return {"run_s": seconds, **_state_bytes(cell),
            "peak_bytes": peak, "fits_h100_80gb": peak < H100_HBM_BYTES,
            "flops_counted": counted, "flops_kernels": kernels,
            "flops": flops, "model_flops": cell.model_flops,
            "roofline": roofline_terms(flops, byte_counter.bytes,
                                       cell.model_flops, peak_flops)}


def run_cell(arch: str, shape: str, skip_reason: Optional[str] = None, *,
             overrides: Optional[dict] = None,
             shape_overrides: Optional[dict] = None) -> dict:
    """One cell's record: ``status`` "ok", "skipped" (with the registry's
    ``reason``) or "error" (with the exception and its traceback)."""
    from .mesh import MeshShape, production_mesh_shape
    from .specs import build_cell
    rec = {"arch": arch, "shape": shape, "device": "meta",
           "mesh": "1 (one H100)"}
    if skip_reason:
        rec.update(status="skipped", reason=skip_reason)
        return rec
    t0 = time.perf_counter()
    try:
        kw = dict(overrides=overrides, shape_overrides=shape_overrides)
        cell = build_cell(arch, shape, MeshShape((1, 1), ("data", "model")),
                          **kw)
        rec.update(status="ok", kind=cell.kind, notes=cell.notes,
                   **measure(cell))
        del cell
        rec["device_bytes"] = {}
        for multi in (False, True):
            mesh = production_mesh_shape(multi_pod=multi)
            rec["device_bytes"][str(mesh)] = _device_bytes(
                build_cell(arch, shape, mesh, **kw))
    except Exception as e:  # noqa: BLE001 - record the failure verbatim
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    rec["seconds"] = time.perf_counter() - t0
    return rec


def summary(rec: dict) -> str:
    """One line a cell."""
    if rec["status"] != "ok":
        return json.dumps({k: v for k, v in rec.items() if k != "traceback"})
    gb = 1e9
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


def _run_one(cell) -> dict:
    return run_cell(*cell)


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
    args = ap.parse_args(argv)
    if not args.all and not args.arch:
        ap.error("give --all or --arch")
    cells = cells_of(args)
    if args.jobs > 1:
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(args.jobs) as pool:
            records = pool.map(_run_one, cells, chunksize=1)
    else:
        records = map(_run_one, cells)
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
