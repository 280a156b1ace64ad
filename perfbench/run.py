"""Run one cell of the port's benchmark and print its result.

    python perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``; then ``checks``,
each number compared beside its limit, which are also the last lines of
standard error.  The run exits non-zero and prints no result where CUDA
is missing or the cell asks for more cards than there are, and where a
module of the JAX package, JAX itself or the JAX package's benchmark
harness has been loaded.
"""
import time

CLOCK0 = time.perf_counter()   # the process's start, as near as it gets

import argparse   # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import sys        # noqa: E402
from pathlib import Path   # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
# this file's directory is not a place to import from: the package is
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != ROOT / "perfbench"]


def caches():
    """Every compile cache in a fixed directory of the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(BUILD / sub)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    caches()
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from perfbench import harness
    from perfbench.tracing import breakdown, read_metrics

    cell = harness.cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    record = cell.loop().run(cell, args.seed, args.seconds, bool(args.trace),
                             device, CLOCK0)

    found = harness.forbidden_modules(ROOT)
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    if args.trace:
        metrics = read_metrics(record.trace, cell.readers())
    else:
        metrics = {"setup_s": record.setup_s, **record.metrics}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    want = [m["name"] for m in (cell.per_layer if args.trace
                                else cell.end_to_end)]
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": cell.chips,
                   "memory_peak_bytes": record.memory_peak_bytes}
    result = {"correct": harness.judge(record.checks),
              "attempted": record.attempted, "failed": record.failed,
              "metrics": {n: {"value": metrics[n], "unit": units[n]}
                          for n in want if n in metrics},
              "device": device_info}
    if args.trace:
        device_info["busy_s"] = record.trace.busy_s
        device_info["window_s"] = record.trace.window_s
        result["breakdown"] = breakdown(record.trace)
    result["checks"] = record.checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    print("\n".join(harness.checks_line(record.checks)), file=sys.stderr,
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
