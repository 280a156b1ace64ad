"""Time the port's ``segment_matmul`` kernel on the card at GIN's
minibatch_lg block shapes, for the source in the tree or for other sources
of the same kernel with the same C interface, in turns on one card.

    PYTHONPATH=src python3 scripts/time_segment_matmul.py \
        [--source OTHER.cu[@NAME=VALUE,...] ...] [--reps 20]

The block is laid out as ``data/graphs.py``'s ``NeighborSampler`` lays it
out for 1024 seeds and fanout (15, 10): M = N = 169,984 rows, K = 15; the
seeds take 15 consecutive neighbour rows each, the next 15,360 rows 10
each, the last 153,600 rows none.  x and W are a seeded normal draw.
Cases: layer 0 (D 602, F 64) in f32 and bf16, layer 1 (D 64, F 64) in
f32, each on the whole block and on its first 16,384 rows alone, the rows
with neighbours (the least a grid over the working tiles only could
take).  Each source is built into the repository's ``build/`` directory
(``--source X.cu@A=1,B=2`` builds X.cu with ``-DA=1 -DB=2``) and checked
once a case: its f32 sums bit-equal to
``ref.neighbor_sum`` and its output within ``ref.product_limit`` of the
plain version.  Sources are timed in the order given and again in reverse.
One JSON line a source and case on standard output, then the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_matmul import kernel
from repro_torch.kernels.segment_matmul.ref import (neighbor_sum,
                                                    product_limit,
                                                    segment_matmul_ref)

SEEDS, FANOUT = 1024, (15, 10)
SLEEP_CYCLES = 20_000_000   # some 10 ms of spinning on the card


def block_nbr(device):
    """The sampler's (M, K) int32 nbr of a (15, 10) block of 1024 seeds."""
    hop1 = SEEDS * FANOUT[0]
    hop2 = hop1 * FANOUT[1]
    M = SEEDS + hop1 + hop2
    nbr = np.full((M, FANOUT[0]), -1, np.int32)
    nbr[:SEEDS] = (SEEDS + np.arange(hop1)).reshape(SEEDS, FANOUT[0])
    nbr[SEEDS:SEEDS + hop1, :FANOUT[1]] = (
        SEEDS + hop1 + np.arange(hop2)).reshape(hop1, FANOUT[1])
    return torch.from_numpy(nbr).to(device)


def bind(source: Path, defines):
    """Build ``source`` with ``defines`` and bind its launcher: the tree's C
    interface (with the load width) or the one without it."""
    tag = "".join("_" + d.replace("=", "") for d in defines)
    library = _build.BUILD_DIR / f"libseg_time_{source.stem}{tag}.so"
    flags = _build.NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    log = _build.build(source, library, flags=flags, force=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"{source.name} {' '.join(defines)}: {line.strip()}",
                  file=sys.stderr)
    with_vec = re.search(r"int\s+vec\s*,", source.read_text()) is not None
    fn = ctypes.CDLL(str(library)).segment_matmul_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_int] * with_vec + [ctypes.c_void_p])

    def launch(x, nbr, w, out, agg=None):
        N, D = x.shape
        M, K = nbr.shape
        args = [x.data_ptr(), N, D, nbr.data_ptr(), M, K, w.data_ptr(),
                w.shape[1], out.data_ptr(),
                None if agg is None else agg.data_ptr(),
                int(x.dtype == torch.bfloat16)]
        if with_vec:
            args.append(kernel.load_width(
                D, x.element_size(), x.data_ptr(),
                None if agg is None else agg.data_ptr()))
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{source}: CUDA error {err}")
    return launch


def time_ms(fn, reps):
    """Mean device time of ``fn()`` over ``reps`` calls by CUDA events,
    queued behind a spin kernel so that the host's launch overhead falls
    outside the events."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    help="another source of the kernel, with nvcc -D "
                         "definitions after an @ (repeatable)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the kernel on the card")
    dev = torch.device("cuda", 0)
    builds = [("tree", kernel.SOURCE, ())]
    for spec in args.source:
        path, _, defines = spec.partition("@")
        builds.append((spec, Path(path),
                       tuple(defines.split(",")) if defines else ()))
    launchers = [(name, bind(src, defs)) for name, src, defs in builds]

    rng = np.random.default_rng(0)
    nbr_all = block_nbr(dev)
    N = nbr_all.shape[0]
    working = SEEDS + SEEDS * FANOUT[0]
    for D, dtype in ((602, torch.float32), (602, torch.bfloat16),
                     (64, torch.float32)):
        x = torch.from_numpy(rng.standard_normal((N, D)).astype(
            np.float32)).to(dev, dtype)
        w = torch.from_numpy((rng.standard_normal((D, 64)) / np.sqrt(D))
                             .astype(np.float32)).to(dev, dtype)
        for rows, nbr in (("block", nbr_all),
                          ("working_rows", nbr_all[:working].contiguous())):
            M = nbr.shape[0]
            want_agg = neighbor_sum(x, nbr)
            limit = product_limit(want_agg, w, dtype)
            want = segment_matmul_ref(x, nbr, w).float()
            out = torch.empty((M, 64), dtype=dtype, device=dev)
            agg = torch.empty((M, D), dtype=torch.float32, device=dev)
            ok = {}
            for name, launch in launchers:
                out.fill_(float("nan"))
                agg.fill_(float("nan"))
                launch(x, nbr, w, out, agg)
                torch.cuda.synchronize()
                ok[name] = (bool(torch.equal(agg, want_agg)),
                            bool(((out.float() - want).abs()
                                  <= limit).all()))
            del want, limit, want_agg
            times = {name: [] for name, _ in launchers}
            for name, launch in launchers + launchers[::-1]:
                times[name].append((
                    time_ms(lambda: launch(x, nbr, w, out), args.reps),
                    time_ms(lambda: launch(x, nbr, w, out, agg),
                            args.reps)))
            for name, _ in launchers:
                print(json.dumps({
                    "source": name, "D": D, "dtype": str(dtype)[6:],
                    "rows": rows, "M": M,
                    "sums_bit_equal": ok[name][0],
                    "out_within_limit": ok[name][1],
                    "ms": [t[0] for t in times[name]],
                    "with_agg_ms": [t[1] for t in times[name]]}),
                    flush=True)
            del out, agg
        del x, w
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
        .stdout.strip())


if __name__ == "__main__":
    main()
