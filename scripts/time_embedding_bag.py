"""Time the port's ``embedding_bag`` kernel on the card at SASRec's history
shape, for the source in the tree or for other sources of the same kernel,
in turns on one card.

    PYTHONPATH=src python3 scripts/time_embedding_bag.py \
        [--source OTHER.cu[@NAME=VALUE,...] ...] [--reps 20]

The table is a seeded standard-normal (1,000,000, 50) draw, in f32 and in
bf16.  The bags are SASRec's step-0 histories (``data/recsys.batch_at_step``,
seed 0: 65,536 bags of 50 slots, each drawn from one 64-item cluster, with
a padded prefix) and a uniform draw of ids over [1, 1,000,000) of the same
shape (seed 1).  Each source is built into the repository's ``build/``
directory (``--source X.cu@A=1,B=2`` builds X.cu with ``-DA=1 -DB=2``); a
source may take the tree's C interface (with the chunk width and lanes a
bag of ``kernel.layout``) or the one before it (table, V, D, is_bf16, ids,
B, L, out, stream), such as the kernel of an earlier commit::

    git show 5fd0a31:src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu \
        > build/embedding_bag_5fd0a31.cu

Each source runs once a case and is checked bit for bit against
``embedding_bag_ref`` (an ablation is expected to differ); then the sources
are timed in the order given and again in reverse, with
``F.embedding_bag(mode="sum", padding_idx=0)`` beside them as "library".
One JSON line a source and case, then the card's name and power limit
(``chip_smoke.py`` prints the bound of each case).
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
import torch.nn.functional as F

from repro_torch.data.recsys import RecStreamConfig, batch_at_step
from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag import kernel
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

V, D, B, L = 1_000_000, 50, 65_536, 50
SLEEP_CYCLES = 20_000_000   # some 10 ms of spinning on the card


def bind(source: Path, defines):
    """Build ``source`` with ``defines`` and bind its launcher, with the
    tree's C interface or the one before it: ``launch(table, ids, out)``."""
    tag = "".join("_" + d.replace("=", "") for d in defines)
    library = _build.BUILD_DIR / f"libembag_time_{source.stem}{tag}.so"
    flags = _build.NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    log = _build.build(source, library, flags=flags, force=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"{source.name} {' '.join(defines)}: {line.strip()}",
                  file=sys.stderr)
    with_layout = re.search(r"int\s+chunk_bytes\s*,",
                            source.read_text()) is not None
    fn = ctypes.CDLL(str(library)).embedding_bag_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_int] + [ctypes.c_int] * (2 * with_layout)
                   + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                      ctypes.c_void_p, ctypes.c_void_p])

    def launch(table, ids, out):
        args = [table.data_ptr(), V, D, int(table.dtype == torch.bfloat16)]
        if with_layout:
            args += kernel.layout(D, table.element_size(), table.data_ptr(),
                                  out.data_ptr())[:2]
        err = fn(*args, ids.data_ptr(), B, L, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
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
    launchers.append(("library", lambda t, i, o: F.embedding_bag(
        i, t, mode="sum", padding_idx=0)))

    table32 = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (V, D), dtype=np.float32)).to(dev)
    history = batch_at_step(RecStreamConfig(V, L, B), 0)[0]
    uniform = np.random.default_rng(1).integers(1, V, (B, L), dtype=np.int32)
    for bags, ids_np in (("history", history), ("uniform", uniform)):
        ids = torch.from_numpy(ids_np).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            table = table32.to(dtype)
            want = embedding_bag_ref(table, ids)
            out = torch.empty_like(want)
            equal = {}
            for name, launch in launchers:
                out.fill_(float("nan"))
                got = launch(table, ids, out)
                torch.cuda.synchronize()
                equal[name] = bool(torch.equal(
                    out if got is None else got, want))
            times = {name: [] for name, _ in launchers}
            for name, launch in launchers + launchers[::-1]:
                times[name].append(time_ms(lambda: launch(table, ids, out),
                                           args.reps))
            for name, _ in launchers:
                print(json.dumps({"source": name, "bags": bags,
                                  "dtype": str(dtype)[6:],
                                  "bit_equal": equal[name],
                                  "ms": times[name]}), flush=True)
            del table, want, out
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
        .stdout.strip())


if __name__ == "__main__":
    main()
