"""The readings that the limits of ``correct`` are set from, on the card at
a cell's own size, several seeds in one process:

    python perfbench/calibrate.py --workload W --seeds 1,2,3 \
        --mode sound|control|unchanged|half_batch|token [--seconds S]

``sound``: the program as the benchmark runs it (the lower readings);
``control``: the reference in the program's place, computed in float8
(``reference.model``'s ``prec="fp8"``; decode: fed the program's served
tokens beside the f32 reference, the gap of its top token read); the other
modes plant ``perfbench.faults``' fault of that name.  One JSON line a
seed with every number the cell's loop can compare, those that the cell's
limits file leaves out too (beside an infinite limit); not run by the
benchmark.
"""
import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != ROOT / "perfbench"]


def readings(cell, seed, mode, seconds, device):
    import contextlib

    from perfbench import faults
    from perfbench.loops import decode, train

    loop = cell.mix["loop"]
    if loop == "train":
        cell.limits = {**{n: math.inf for n in train.NUMBERS}, **cell.limits}
    if mode == "control" and loop == "train":
        return train.control_checks(cell, seed, device)
    if mode == "control":
        return decode.control_checks(cell, seed, seconds, device)
    planted = (contextlib.nullcontext() if mode == "sound"
               else faults.plant(mode, loop))
    with planted:
        rec = cell.loop().run(cell, seed, seconds, False, device,
                              time.perf_counter())
    return {**rec.checks, "metrics": rec.metrics}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="sound")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import run as bench_run   # its cache directories
    bench_run.caches()
    import torch

    from perfbench import harness
    cell = harness.cell(args.workload, ROOT)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = readings(cell, seed, args.mode, args.seconds, device)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "s": time.perf_counter() - t0,
                          **out}), flush=True)


if __name__ == "__main__":
    main()
