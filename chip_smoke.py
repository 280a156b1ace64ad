#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit.  It:

1. prints the card's name and power limit (``nvidia-smi``) and the torch /
   CUDA versions;
2. builds the kernel of the main path from ``src/`` (``nvcc`` into
   ``build/``) and prints the build time;
3. holds the kernel against its plain PyTorch version on the card at the
   shapes the main path gives it (and a few more), exactly (tolerance 0),
   and times kernel / plain version / library call with CUDA events;
4. drives ``AmpcEngine(dht_backend="local").solve`` for ``connectivity``,
   ``mis`` and ``msf`` at rmat20 (Graph500 RMAT, 2^20 vertices, average
   degree 8, seed 1; MSF weights from seed 2), twice each, with the kernel
   launch counts set to 0 just before and read just after, and checks
   every answer against an independent host computation (scipy, the port's
   greedy-MIS oracle) and the Table-3 shuffle counts.  The label maps each
   connectivity solve reads through the DHT go through the kernel and its
   plain version once more, after the counts are read, and must agree;
5. prints one ``{"kernels": [...]}`` line, whose times are those of the
   first connectivity solve's root-label read, and as its last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the exit code is nonzero and the last line is
not printed.  Without a CUDA card, or outside a checkout, it exits nonzero.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
RMAT_LOG2, RMAT_DEG, RMAT_SEED, WEIGHT_SEED = 20, 8.0, 1, 2
EXPECTED_SHUFFLES = {"connectivity": 5, "mis": 2, "msf": 5}
CC_LAUNCHES_PER_SOLVE = 2


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------
SLEEP_CYCLES = 20_000_000   # some 10 ms of spinning on the card


def time_ms(fn, reps=20, warmup=3):
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events.

    A spin kernel runs first, so every call is queued before the card
    reaches the start event: the host's launch overhead falls inside the
    spin, and the events see device time only."""
    import torch
    for _ in range(warmup):
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


# --------------------------------------------------------------------------
# phase: kernels against their plain versions
# --------------------------------------------------------------------------
def plain_dht_gather(table, keys):
    """The plain version of the whole ``dht_gather`` wrapper."""
    import torch
    from repro_torch.kernels.dht_gather.ref import dht_gather_ref
    sk, order = torch.sort(keys, stable=True)
    out_s, hits = dht_gather_ref(table, sk)
    out = torch.empty_like(out_s)
    out[order] = out_s
    return out, hits


def dht_gather_case(name, table, keys, timed):
    """Kernel vs plain version on one input; timings when ``timed``."""
    import torch
    from repro_torch.kernels.dht_gather import kernel, ops
    from repro_torch.kernels.dht_gather.ref import dht_gather_ref

    out, hits = ops.dht_gather(table, keys)
    ref_out, ref_hits = plain_dht_gather(table, keys)
    torch.cuda.synchronize()
    check(torch.equal(out, ref_out), f"dht_gather rows differ at {name}")
    check(int(hits) == int(ref_hits),
          f"dht_gather hits {int(hits)} != {int(ref_hits)} at {name}")
    err = 0.0
    if out.numel():
        err = float((out.double() - ref_out.double()).abs().max())
    Q, D = keys.shape[0], table.shape[1]
    sk = torch.sort(keys, stable=True)[0]
    n_valid = int((sk >= 0).sum())
    n_distinct = n_valid - int(ref_hits)
    es = table.element_size()
    # least bytes: keys read once, each distinct row read once, rows and
    # the hit count written once
    nbytes = 4 * Q + n_distinct * D * es + Q * D * es + 4
    row = {"shape": name, "V": int(table.shape[0]), "D": int(D),
           "dtype": str(table.dtype).replace("torch.", ""), "Q": int(Q),
           "hits": int(ref_hits), "max_abs_err": err,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    if timed:
        order = torch.sort(keys, stable=True)[1]
        flat = table.reshape(-1)
        take_idx = (sk.clamp(0, table.shape[0] - 1).long()[:, None] * D
                    + torch.arange(D, device=keys.device)).reshape(-1)
        scratch = torch.empty_like(out)
        # the bare launch into buffers made once: hits accumulates over
        # the calls, which the timing does not read
        hits_buf = torch.zeros(1, dtype=torch.int32, device=keys.device)

        def unsort():
            scratch[order] = out

        row.update(
            ms=time_ms(lambda: kernel.launch(table, sk, scratch, hits_buf)),
            plain_ms=time_ms(lambda: dht_gather_ref(table, sk)),
            library_ms=time_ms(lambda: torch.take(flat, take_idx)),
            sort_ms=time_ms(lambda: torch.sort(keys, stable=True)),
            unsort_ms=time_ms(unsort),
            wrapper_ms=time_ms(lambda: ops.dht_gather(table, keys)))
    return row


def kernel_phase(nt, n):
    """dht_gather at the connectivity shapes (table (nt, 1) int32 read by
    nt root keys, then by n first-slot keys) and at other widths."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    # root-like batch: few distinct labels, long duplicate runs that cross
    # block edges once sorted, padding keys and out-of-range keys
    roots = rng.integers(0, max(nt // 16, 1), size=nt).astype(np.int32)
    roots[rng.random(nt) < 0.01] = -1
    roots[rng.random(nt) < 0.001] = nt + 5
    first_slot = np.sort(rng.choice(nt, size=n, replace=False)).astype(
        np.int32)
    labels = torch.from_numpy(rng.integers(0, nt, size=(nt, 1)).astype(
        np.int32)).to(dev)
    cases = [
        ("cc_roots", labels, torch.from_numpy(roots).to(dev), True),
        ("cc_first_slot", labels, torch.from_numpy(first_slot).to(dev), True),
        ("f32_65536x64", torch.randn(65536, 64, device=dev),
         torch.from_numpy(rng.integers(-2, 70000, size=200_000).astype(
             np.int32)).to(dev), True),
        ("bf16_4096x128", torch.randn(4096, 128, device=dev).bfloat16(),
         torch.from_numpy(rng.integers(-2, 4200, size=50_000).astype(
             np.int32)).to(dev), True),
        ("q0", labels[:1000], torch.zeros(0, dtype=torch.int32, device=dev),
         False),
        ("q1", labels[:1000], torch.tensor([7], dtype=torch.int32,
                                           device=dev), False),
    ]
    rows = [dht_gather_case(name, t, k, timed) for name, t, k, timed in cases]
    return rows


# --------------------------------------------------------------------------
# phase: the engine at rmat20
# --------------------------------------------------------------------------
def canonical(labels):
    import numpy as np
    n = labels.shape[0]
    mins = np.full(int(labels.max()) + 1 if n else 0, n, np.int64)
    np.minimum.at(mins, labels, np.arange(n))
    return mins[labels]


def independent_answers(g, gw):
    """Host answers computed without the port's solvers."""
    import numpy as np
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components, \
        minimum_spanning_tree
    from repro_torch.core import oracle

    n = g.n
    u, v = g.edges[:, 0], g.edges[:, 1]
    adj = coo_matrix((np.ones(g.m), (u, v)), shape=(n, n)).tocsr()
    _, cc = connected_components(adj, directed=False)
    mis = oracle.greedy_mis(g, np.random.default_rng(0).permutation(n))
    wadj = coo_matrix((gw.weights.astype(np.float64), (u, v)),
                      shape=(n, n)).tocsr()
    mst = minimum_spanning_tree(wadj)
    return {"connectivity": canonical(cc.astype(np.int64)), "mis": mis,
            "msf": np.sort(mst.data)}


def engine_phase(g, gw):
    """Solve every problem twice on the card with the launch counts set to
    0 first; check each answer.  Returns the main path's kernel launches
    and the kernel's rows on the connectivity solves' own label maps."""
    import numpy as np
    import torch
    from repro_torch.ampc import AmpcEngine
    from repro_torch.core import rounds
    from repro_torch.kernels.dht_gather import ops

    t0 = time.perf_counter()
    want = independent_answers(g, gw)
    emit({"phase": "independent_answers",
          "seconds": time.perf_counter() - t0})
    eng = AmpcEngine(dht_backend="local", seed=0)
    check(eng.device.type == "cuda", f"engine on {eng.device}, not cuda")

    # keep the (values, keys) of every deduplicated DHT read (the reads
    # that reach the kernel), to hold them against the plain version later
    reads = []
    local_lookup = eng.dht.lookup

    def recorded_lookup(values, keys, *, dedup=True, **kw):
        if dedup:
            reads.append((values, keys))
        return local_lookup(values, keys, dedup=dedup, **kw)

    eng.dht.lookup = recorded_lookup
    main_launches, solve_rows = 0, []
    ops.dht_gather.launches = 0
    for problem, graph in (("connectivity", g), ("mis", g), ("msf", gw)):
        for rep in range(2):
            launches0, reads0 = ops.dht_gather.launches, rounds.HOST_READS
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.solve(graph, problem)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ops.dht_gather.launches - launches0
            main_launches += launches
            out = res.output
            if problem == "connectivity":
                check(np.array_equal(out, want[problem]),
                      "connectivity labels differ from scipy's")
            elif problem == "mis":
                check(np.array_equal(out, want[problem]),
                      "mis differs from the greedy-MIS oracle")
            else:
                check(np.array_equal(np.sort(gw.weights[out]
                                             .astype(np.float64)),
                                     want[problem]),
                      "msf weights differ from scipy's spanning forest")
            check(res.shuffles == EXPECTED_SHUFFLES[problem],
                  f"{problem}: {res.shuffles} shuffles, expected "
                  f"{EXPECTED_SHUFFLES[problem]}")
            expect = CC_LAUNCHES_PER_SOLVE if problem == "connectivity" else 0
            check(launches == expect,
                  f"{problem}: dht_gather launched {launches} times, "
                  f"expected {expect}")
            emit({"phase": "engine", "problem": problem, "rep": rep,
                  "wall_s": wall, "host_reads": rounds.HOST_READS - reads0,
                  "dht_gather_launches": launches,
                  "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                  "ledger": res.ledger, "stats": res.stats})
            check(len(reads) == expect,
                  f"{problem}: {len(reads)} deduplicated DHT reads, "
                  f"expected {expect}")
            for i, (values, keys) in enumerate(reads):
                table = values.reshape(values.shape[0], -1)
                keys = torch.where(keys < 0, -1, keys.to(torch.int32))
                row = dht_gather_case(f"{problem}_solve{rep}_read{i}",
                                      table, keys, timed=rep == 0)
                emit({"phase": "kernel", "name": "dht_gather", **row})
                solve_rows.append(row)
            reads.clear()
    eng.dht.lookup = local_lookup
    return main_launches, solve_rows


# --------------------------------------------------------------------------
def build_kernels():
    """Build the main path's kernel from its source (one ``nvcc``)."""
    from repro_torch.kernels.dht_gather import kernel as dht_gather_kernel
    t0 = time.perf_counter()
    logs = {"dht_gather": dht_gather_kernel.build(True)}
    return time.perf_counter() - t0, logs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "ampc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import numpy as np
    from repro_torch.core import rounds
    from repro_torch.graph import generators as gen

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    emit({"torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    seconds, logs = build_kernels()
    emit({"phase": "build", "seconds": seconds})
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[{name}] {line.strip()}", flush=True)

    t0 = time.perf_counter()
    g = gen.rmat(RMAT_LOG2, RMAT_DEG, seed=RMAT_SEED)
    gw = g.with_random_weights(seed=WEIGHT_SEED)
    deg = g.degrees()
    nt = int(np.where(deg > 3, deg, 1).sum())  # ternarized vertex count
    emit({"phase": "graph", "n": g.n, "m": g.m, "max_degree": int(deg.max()),
          "n_tern": nt, "seconds": time.perf_counter() - t0})

    rows = kernel_phase(nt, g.n)
    for row in rows:
        emit({"phase": "kernel", "name": "dht_gather", **row})

    launches, solve_rows = engine_phase(g, gw)
    check(launches > 0, "the main path launched no dht_gather kernel")
    rows = solve_rows + rows

    main_row = rows[0]   # the first cc solve's root-label read
    emit({"kernels": [{
        "name": "dht_gather", "route": "cuda",
        "source": "src/repro_torch/kernels/dht_gather/csrc/dht_gather.cu",
        "replaces": "src/repro/kernels/dht_gather/kernel.py:28",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": "bytes",
        "library_ms": main_row["library_ms"],
        "shapes": rows}]})
    emit({"host_reads_total": rounds.HOST_READS})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
