#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit.  It:

1. prints the card's name and power limit (``nvidia-smi``) and the torch /
   CUDA versions;
2. builds the kernels of every path from ``src/`` (one ``nvcc`` per
   source, started together, into ``build/``; the flash forward has two,
   the wgmma route's and the SIMT route's) and prints the build time and
   each kernel's register report;
3. holds ``dht_gather`` against its plain PyTorch version on the card at
   the shapes the AMPC path gives it (and a few more), exactly (tolerance
   0), and times kernel / plain version / library call with CUDA events;
4. drives ``AmpcEngine(dht_backend="local").solve`` for ``connectivity``,
   ``mis`` and ``msf`` at rmat20 (Graph500 RMAT, 2^20 vertices, average
   degree 8, seed 1; MSF weights from seed 2), twice each, with the kernel
   launch counts set to 0 just before and read just after, and checks
   every answer against an independent host computation (scipy, the port's
   greedy-MIS oracle) and the Table-3 shuffle counts.  The label maps each
   connectivity solve reads through the DHT go through the kernel and its
   plain version once more, after the counts are read, and must agree;
5. holds the flash-attention forward kernels against their plain version
   on the card, element by element (bf16 within 2^-7 of each output plus
   1e-3, f32 within 1e-5: the kernel sums in another order) at the LM
   path's shape and at D 256 with a window, K > S (bf16: the wgmma route),
   and f32 with and without a window (the SIMT route), each row naming its
   route; times kernel / plain version / SDPA, and at the path's shape the
   SIMT kernel on the same bf16 inputs (the design the wgmma route
   replaced there);
6. drives the qwen3-4b LM forward (the registry's config at full width and
   depth, ``attention_impl="pallas"``, seeded bf16 weights on the card) on
   one batch of ``LM_SHAPES["train_4k"]`` cut to B 2 (S 4096), twice, with
   the launch counts set to 0 just before and read just after: 36 flash
   launches per forward, all on the wgmma route, finite logits and loss,
   an untrained loss near ln(vocab).  The first and last layer's q, k, v
   go through the kernel and its plain version after the counts are
   read.  At S 1024 the whole forward, in f32 on the same weights with
   TF32 off (the SIMT route), is held against ``attention_impl="xla"``
   within 1e-4;
7. holds the flash-attention backward kernels (dq, dk/dv) against their
   plain version on the card, element by element (``ref.grad_limit``: one
   ulp of each bf16 element or 2^-14 of an f32 one, above a floor of
   2 n 2^-24 for a sum of n terms), the kernels fed the forward kernel's
   ``lse``, which is held against the plain one too, at the training
   path's shape, at D 256 with a window, K > S ragged, f32 with and
   without a window and on strided heads; runs each kernel twice and asks
   for equal bits; times kernels / plain version / SDPA's backward;
8. trains qwen3-4b at full width and depth (f32 parameters, bf16
   compute, ``remat="full"``, AdamW with f32 state) for three steps of
   ``LM_SHAPES["train_4k"]`` cut to a global batch of 2 in 2 microbatches
   (S 4096) through ``launch.steps.lm_train_step``, with the launch counts
   set to 0 just before each step and read just after: 144 forward (two
   microbatches, each layer's forward and its remat recompute; all on the
   wgmma route), 72 dq and 72 dk/dv launches, finite losses near
   ln(vocab) at step 0, a finite positive grad norm, every parameter
   changed, AdamW's step count 3;
   prints step time, tokens/s, peak memory, the lr and loss of each step,
   and the last step's device time by kind of kernel (``torch.profiler``;
   that step's wall time carries the profiler's cost);
9. holds every gradient of a 4-layer qwen3-4b (full widths, B 1, S 1024,
   f32, TF32 off) through the kernels against the same gradients through
   ``attention_impl="xla"`` and against ``remat="full"``;
10. trains gin-tu at full width (5 layers, d_hidden 64, f32, d_feat 602,
   AdamW of the reference's ``specs._opt_cfg()``) on ``minibatch_lg``
   blocks: ``rmat(18, 437)`` (2^18 vertices, 78,980,768 directed edges),
   seeded standard-normal features put on the card once, 1024 seeds and
   fanout (15, 10) (169,984 nodes, 168,960 edges, one seeded graph label
   a block).  One ``gnn_forward_step`` and three ``gnn_train_step``s on
   fresh blocks, the launch counts set to 0 just before each and read just
   after: 5 ``segment_matmul`` launches each and no other kernel's; the
   block's ``nbr`` with 15 valid slots on the seeds, 10 on hop 1, none on
   hop 2; the forward's logits against the same forward through the plain
   version and through the reference's edge-list layer within
   ``GNN_RTOL`` of the largest; the first step's loss against the
   edge-list layer's; finite metrics, a grad norm positive exactly when
   the loss is; every parameter changed, AdamW's count 3.  The kernel is
   held against its plain version on layer 0's and layer 1's own inputs
   (and layer 0's in bf16) within ``ref.product_limit``, its f32 sums
   equal bit for bit, twice equal bit for bit, and timed beside the plain
   version and ``embedding_bag`` + ``matmul``.  Prints the host sampling,
   feature gather and step times, seeds/s, peak memory, and the last
   step's device time by kind of kernel (``torch.profiler``);
11. drives SASRec at full size (the registry's ``sasrec``: 1,000,000
   items, d 50, 2 blocks, 1 head, seq 50; f32 parameters from seed 0) on
   the cells of ``REC_SHAPES``, every call with the launch counts set to 0
   just before and read just after: ``serve_p99`` (``rec_serve_step`` at B
   512, 1024 seeded candidates a user, five calls), ``serve_bulk`` (262,144
   users in 8 calls of 32,768), ``retrieval_cand`` (``rec_retrieval_step``
   at B 1: 1,000,000 scores, five calls) and ``train_batch`` (3
   ``rec_train_step``s at B 65,536, AdamW of ``specs._opt_cfg()``).  Every
   item read is ``dht_gather``: 2 launches a serve call, 1 a retrieval call,
   3 a training step, and no other kernel's.  One ``serve_p99`` call's
   scores must equal bit for bit the same call with the gather swapped for
   its plain version; retrieval's top 1024 scores must equal the same items
   scored as candidates within 1e-5 of the largest; every output is finite,
   the step-0 loss within 0.05 of ln 2, every parameter changed, AdamW's
   count 3.  Prints wall times, users/s, peak memory and the last step's
   device time by kind of kernel (``torch.profiler``), and holds
   ``dht_gather`` against its plain version on the training batch's
   histories (3,276,800 keys into the trained table);
12. calls ``embedding_bag`` (the op's own entry point; no model of either
   package reaches it) on the trained item table with step 0's 65,536
   histories as bags, the counts set to 0 just before and read just after:
   one launch.  The kernel is held against its plain version bit for bit
   (and twice equal) there, in bf16, at ``tests/test_kernels.py``'s shapes
   in f32 and bf16 and at edge cases (D 37, L 0 and 1, a ragged B, ids
   below 0 and past the table, L 300), and timed beside the plain version
   and ``F.embedding_bag(mode="sum", padding_idx=0)``;
13. prints one ``{"kernels": [...]}`` line (dht_gather: the first
   connectivity solve's root-label read, with its launches by phase; the
   flash forward: the first layer's own q, k, v, its kernel route and the
   SIMT kernel's time there; dq and dk/dv: the
   training path's shape; segment_matmul: GIN layer 0's own inputs in the
   forward; embedding_bag: the trained item table and step 0's histories)
   and as its last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the exit code is nonzero and the last line is
not printed.  Without a CUDA card, or outside a checkout, it exits nonzero.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
RMAT_LOG2, RMAT_DEG, RMAT_SEED, WEIGHT_SEED = 20, 8.0, 1, 2
EXPECTED_SHUFFLES = {"connectivity": 5, "mis": 2, "msf": 5}
CC_LAUNCHES_PER_SOLVE = 2
# dense peaks of the H100 SXM data sheet: bf16 tensor cores, f32 CUDA cores
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# kernel vs plain version, element by element: |out - ref| <= atol + rtol
# |ref|.  Both sum in f32 and round once to the output type, in other
# orders: f32 agrees to 1e-5; a bf16 element may land one ulp of its own
# away, at most 2^-7 of it, and the 1e-3 covers the f32 sums' difference
# near 0.  (rtol, atol) by type:
FLASH_TOL = {"bfloat16": (2 ** -7, 1e-3), "float32": (0.0, 1e-5)}
LM_ARCH, LM_SHAPE, LM_BATCH, LM_SEED, LM_DATA_SEED = \
    "qwen3-4b", "train_4k", 2, 0, 0
# the flash forward's source by route: flash_attention_fwd{suffix}.cu
FWD_SOURCE = {"wgmma": "_wgmma", "simt": ""}
XLA_SEQ = 1024          # under the chunked-attention threshold
# the pallas and xla forwards in f32 with TF32 off: every matmul outside
# attention is the same call on the same inputs, so the logits differ only
# by the two attentions' f32 summation orders, carried through 36 layers
XLA_LOGITS_ATOL, XLA_NLL_ATOL = 1e-4, 1e-4
TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 2, 2, 3
# the trained model's gradients through the kernels against the xla
# attention's (and remat "full" against "none"), per element:
# |a - b| <= GRAD_RTOL |b| + GRAD_FLOOR rms(the nonzero elements of b's
# tensor).  In f32 with TF32 off only the attentions' summation orders
# differ, some 1e-6 of a value carried through 4 layers; the floor covers
# elements near zero.  (The RMS is over nonzero elements because the
# embedding's gradient lives in the few rows the batch reads.)
GRAD_LAYERS, GRAD_SEQ, GRAD_RTOL, GRAD_FLOOR = 4, 1024, 1e-3, 1e-4
# gin-tu x minibatch_lg: an RMAT graph of 2^18 vertices (Reddit has
# 232,965) at average degree 437 (78,980,768 directed edges, 69% of
# Reddit's), f32 features of the cell's width 602 from seed 0, 1024-seed
# blocks of fanout (15, 10) from the sampler's seed 1; the seeds and
# each block's graph label from seed 2
GNN_ARCH, GNN_SHAPE = "gin-tu", "minibatch_lg"
GNN_RMAT_LOG2, GNN_RMAT_DEG, GNN_GRAPH_SEED = 18, 437.0, 0
GNN_FEAT_SEED, GNN_PARAM_SEED, GNN_SAMPLER_SEED, GNN_SEED_SEED = 0, 0, 1, 2
GNN_STEPS = 3
# the forward's logits (and the loss) through the kernel against the same
# forward through the plain version and through the reference's edge-list
# layer (gather, scatter_sum, then W1), f32 with TF32 off: the three sum
# the same terms in other orders, each layer's D-term product within
# 2 D 2^-24 of its sum of |terms|, carried through 5 layers and a sum over
# 169,984 nodes: |a - b| <= GNN_RTOL max |b|
GNN_RTOL = 1e-4
# sasrec: the registry's config at full size (1,000,000 items, d 50, 2
# blocks, 1 head, seq 50), f32 parameters from seed 0; histories from
# batch_at_step's seed 0; 1024 candidates a user from seed 0, drawn in
# [1, n_items) as the JAX package's launch/specs.py and
# tests/test_sasrec.py draw them
REC_ARCH = "sasrec"
REC_PARAM_SEED, REC_DATA_SEED, REC_CAND_SEED = 0, 0, 0
REC_CANDIDATES = 1024
REC_SERVE_REPS = 5        # serve_p99 and retrieval_cand calls
REC_BULK_CALLS = 8        # serve_bulk's 262,144 users in calls of 32,768
REC_TRAIN_STEPS = 3
# untrained, the states' dot products with the 0.02-scale item rows differ
# by some 0.1-0.2 between a positive and a negative item, so the BPR loss
# log1p(exp(-z)) sits within E[z^2] / 8 < 0.01 of ln 2
REC_LOSS0_TOL = 0.05
# embedding_bag: tests/test_kernels.py's (V, D, B, L), then edge cases
EMBAG_TEST_SHAPES = ((64, 16, 16, 4), (256, 32, 32, 10), (1024, 64, 8, 50))
EMBAG_EDGE_SHAPES = ((300, 37, 13, 7), (50, 8, 5, 0), (50, 8, 5, 1),
                     (20000, 50, 1001, 50), (500, 130, 3, 300))


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
# phase: the flash-attention kernel against its plain version
# --------------------------------------------------------------------------
def attention_pairs(S, K, causal, window):
    """The (query, key) pairs the mask keeps for one (batch, head): the
    work the two products need on these inputs."""
    import numpy as np
    pos = np.arange(S, dtype=np.int64) + (K - S)
    hi = np.minimum(pos, K - 1) if causal else np.full(S, K - 1)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros(S)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_case(name, q, k, v, window, timed, library):
    """Kernel vs plain version on one causal input; timings when
    ``timed``; the SDPA time when ``library`` (causal, K == S, no window:
    the same function), and there, for a wgmma-route input, the SIMT
    kernel's time on the same inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel, ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    out = ops.flash_attention(q, k, v, causal=True, window=window)
    ref = attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    dtype = str(q.dtype).replace("torch.", "")
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    rtol, atol = FLASH_TOL[dtype]
    # the largest difference as a share of its element's own limit
    worst = float((diff / (atol + rtol * ref.float().abs())).max())
    del diff
    check(bool(torch.isfinite(out).all()), f"flash output not finite at "
          f"{name}")
    check(worst <= 1.0, f"flash kernel differs from its plain version at "
          f"{name}: {worst} times its limit of {atol} + {rtol} |ref| "
          f"(largest difference {err})")
    B, S, H, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    pairs = attention_pairs(S, K, True, window)
    # multiply-adds of QK^T and PV over the kept pairs, two flops each;
    # each input read once, the output written once
    flops = 4 * D * pairs * B * H
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) \
        * q.element_size()
    op_ms = flops / PEAK_FLOPS[dtype] * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"shape": name, "kernel_route": kernel.route(q), "B": B, "S": S,
           "K": K, "H": H, "Hkv": Hkv, "D": D, "window": window,
           "dtype": dtype, "max_abs_err": err, "err_over_limit": worst,
           "flops": flops, "bytes": nbytes, "bound_ms": max(op_ms, byte_ms),
           "bound_by": "operations" if op_ms >= byte_ms else "bytes"}
    if timed:
        buf = torch.empty_like(out)
        row.update(
            ms=time_ms(lambda: kernel.launch(q, k, v, buf, True, window),
                       reps=10),
            plain_ms=time_ms(lambda: attention_ref(q, k, v, True, window),
                             reps=5, warmup=1),
            library_ms=None)
        row["tflops"] = flops / row["ms"] / 1e9
        if library:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), reps=10)
            if row["kernel_route"] == "wgmma":
                row["simt_ms"] = time_ms(
                    lambda: kernel.launch(q, k, v, buf, True, window,
                                          which="simt"), reps=5)
    return row


def flash_phase():
    """The kernel at the LM path's shape (qwen3-4b, B 2, S 4096), at D 256
    with a window (gemma3-12b's heads), with K > S and ragged S, and in
    f32 with and without a window; inputs drawn on the card from seed
    0."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def qkv(B, S, K, H, Hkv, D, dtype):
        return (torch.randn(B, S, H, D, generator=g, device=dev).to(dtype),
                torch.randn(B, K, Hkv, D, generator=g, device=dev).to(dtype),
                torch.randn(B, K, Hkv, D, generator=g, device=dev).to(dtype))

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("path_bf16", qkv(2, 4096, 4096, 32, 8, 128, bf16), 0, True),
        ("d256_window1024_bf16", qkv(1, 4096, 4096, 16, 8, 256, bf16), 1024,
         False),
        ("k_gt_s_ragged_bf16", qkv(2, 1000, 3000, 32, 8, 128, bf16), 0,
         False),
        ("f32", qkv(1, 2048, 2048, 32, 8, 128, f32), 0, True),
        ("f32_window1024", qkv(1, 4096, 4096, 32, 8, 128, f32), 1024,
         False),
    ]
    return [flash_case(name, *t, window, timed=True, library=library)
            for name, t, window, library in cases]


# --------------------------------------------------------------------------
# phase: the qwen3-4b forward
# --------------------------------------------------------------------------
def lm_phase():
    """Two forwards (logits and loss) of qwen3-4b at B 2, S 4096 through
    the kernel, the launch counts set to 0 just before each and read just
    after; then the first and last layer's inputs through kernel and plain
    version, and the whole forward against the xla attention at S 1024.
    Returns the main path's flash launches and the kernel's rows."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import LM_SHAPES
    from repro_torch.data.tokens import TokenStreamConfig, batch_at_step
    from repro_torch.kernels.dht_gather import ops as dht_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import transformer
    from repro_torch.models.transformer import (TransformerLM, init_params,
                                                lm_loss)

    dev = torch.device("cuda")
    cfg = dataclasses.replace(registry.get(LM_ARCH).config,
                              attention_impl="pallas")
    shape = LM_SHAPES[LM_SHAPE]
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        LM_SEED), dtype=cfg.dtype)
    model = TransformerLM(cfg, params)
    check(model.device.type == "cuda", f"model on {model.device}, not cuda")
    n_params = sum(p.numel() for p in model.parameters())
    # param_count() leaves out the qk-norm scales (2 x head_dim a layer)
    want = cfg.param_count() + (2 * cfg.n_layers * cfg.head_dim
                                if cfg.qk_norm else 0)
    check(n_params == want, f"{n_params} parameters, expected {want}")
    tokens, labels = batch_at_step(TokenStreamConfig(
        cfg.vocab, shape.seq_len, LM_BATCH, seed=LM_DATA_SEED), 0)
    tokens = torch.from_numpy(tokens).to(dev)
    labels = torch.from_numpy(labels).to(dev)
    torch.cuda.synchronize()
    emit({"phase": "lm_setup", "arch": LM_ARCH, "params": n_params,
          "weights_gib": torch.cuda.memory_allocated() / 2**30,
          "batch": LM_BATCH, "seq": shape.seq_len,
          "seconds": time.perf_counter() - t0})

    # keep the (q, k, v, window) of the first and last layer's attention,
    # read where the model calls the kernel's wrapper
    recorded = {}
    kernel_call = flash_ops.flash_attention
    check(transformer.flash_attention is kernel_call,
          "the model does not call ops.flash_attention")

    def recording(q, k, v, causal=True, window=0):
        n = recording.calls
        recording.calls += 1
        if n % cfg.n_layers in (0, cfg.n_layers - 1):
            recorded.setdefault(n % cfg.n_layers, (q, k, v, window))
        return kernel_call(q, k, v, causal=causal, window=window)

    recording.calls = 0
    transformer.flash_attention = recording
    main_launches = 0
    try:
        for rep in range(2):
            kernel_call.launches = 0
            kernel_call.launches_by_route = {"wgmma": 0, "simt": 0}
            dht_ops.dht_gather.launches = 0
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                logits, aux = model(tokens)
                torch.cuda.synchronize()
                fwd = time.perf_counter() - t0
                loss, metrics = lm_loss(logits, aux, labels)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernel_call.launches
            by_route = dict(kernel_call.launches_by_route)
            dht = dht_ops.dht_gather.launches
            main_launches += launches
            check(launches == cfg.n_layers,
                  f"forward launched the flash kernel {launches} times, "
                  f"expected {cfg.n_layers}")
            check(by_route == {"wgmma": cfg.n_layers, "simt": 0},
                  f"forward launched {by_route} by route, expected all "
                  f"{cfg.n_layers} on the wgmma route")
            check(dht == 0, f"the LM forward launched dht_gather {dht} "
                  f"times")
            check(tuple(logits.shape) == (LM_BATCH, shape.seq_len,
                                          cfg.vocab)
                  and logits.dtype == cfg.dtype, "logits shape or dtype")
            check(bool(torch.isfinite(logits).all()), "logits not finite")
            nll = float(metrics["nll"])
            check(math.isfinite(float(loss)), "loss not finite")
            # untrained: near ln(V), as the JAX package's LM smoke test asks
            check(abs(nll / math.log(cfg.vocab) - 1) < 0.35,
                  f"untrained nll {nll} far from ln(V) "
                  f"{math.log(cfg.vocab)}")
            emit({"phase": "lm_forward", "rep": rep, "forward_s": fwd,
                  "forward_and_loss_s": wall,
                  "tokens_per_s": LM_BATCH * shape.seq_len / fwd,
                  "flash_launches": launches,
                  "flash_launches_by_route": by_route, "loss": float(loss),
                  "nll": nll,
                  "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
            del logits, loss, metrics
    finally:
        transformer.flash_attention = kernel_call

    rows = []
    check(sorted(recorded) == [0, cfg.n_layers - 1],
          f"recorded layers {sorted(recorded)}")
    for layer in sorted(recorded):
        q, k, v, window = recorded[layer]
        check(q.is_contiguous() and tuple(q.shape) == (
            LM_BATCH, shape.seq_len, cfg.n_heads, cfg.head_dim),
            f"layer {layer} q shape {tuple(q.shape)}")
        rows.append(flash_case(f"qwen3_layer{layer}", q, k, v, window,
                               timed=layer == 0, library=layer == 0))
    recorded.clear()

    # the whole forward against the xla attention at S 1024, in f32 (the
    # bf16 weights cast at use, exactly) with TF32 off, so the difference
    # is the kernel's and not bf16 rounding's
    del model
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    pallas = TransformerLM(f32, params)
    xla = TransformerLM(dataclasses.replace(f32, attention_impl="xla"),
                        params)
    short, short_labels = tokens[:, :XLA_SEQ], labels[:, :XLA_SEQ]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            launches0 = kernel_call.launches
            a, aux = pallas(short)
            check(kernel_call.launches - launches0 == cfg.n_layers,
                  "the f32 pallas forward did not launch the kernel "
                  "once a layer")
            nll_a = float(lm_loss(a, aux, short_labels)[1]["nll"])
            b, aux = xla(short)
            nll_b = float(lm_loss(b, aux, short_labels)[1]["nll"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    check(a.dtype == b.dtype == torch.float32, "the forwards are not f32")
    diff = float((a - b).abs().max())
    top = float(b.abs().max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    emit({"phase": "lm_vs_xla", "seq": XLA_SEQ, "dtype": "float32",
          "max_abs_diff": diff, "max_abs_logit": top, "nll_pallas": nll_a,
          "nll_xla": nll_b, "argmax_agreement": agree})
    check(diff <= XLA_LOGITS_ATOL,
          f"pallas and xla f32 logits differ by {diff} (limit "
          f"{XLA_LOGITS_ATOL})")
    check(abs(nll_a - nll_b) <= XLA_NLL_ATOL,
          f"pallas nll {nll_a} vs xla nll {nll_b}")
    del pallas, xla, params, a, b
    torch.cuda.empty_cache()
    return main_launches, rows


# --------------------------------------------------------------------------
# phase: the flash-attention backward kernels against their plain version
# --------------------------------------------------------------------------
def sdpa_backward_ms(q, k, v, do):
    """The time of ``torch.autograd.grad`` through SDPA's backward (causal,
    k and v expanded to the query heads), and the backend that ran: the
    first of flash, cuDNN and memory-efficient attention that takes the
    inputs."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    G = q.shape[2] // k.shape[2]
    leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    dot = do.transpose(1, 2)
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        try:
            # a backend that refuses the inputs warns, then raises
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                out = F.scaled_dot_product_attention(
                    leaves[0], leaves[1].repeat_interleave(G, dim=1),
                    leaves[2].repeat_interleave(G, dim=1), is_causal=True)
                ms = time_ms(lambda: torch.autograd.grad(
                    out, leaves, dot, retain_graph=True), reps=10)
            return ms, backend.name
        except RuntimeError:
            continue
    raise SmokeFailure("no SDPA backend took the inputs")


def bwd_case(name, q, k, v, do, window, timed, library):
    """dq and dk/dv kernels (twice each), fed the forward kernel's lse, and
    that lse against the plain version on one causal input; timings when
    ``timed``, SDPA's backward when ``library``."""
    import torch
    from repro_torch.kernels.flash_attention import bwd, kernel
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_ref, attention_fwd_lse_ref, grad_limit)
    B, S, H, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    o, lse = attention_fwd_lse_ref(q, k, v, True, window)
    _, lse_kernel = kernel.flash_attention_cuda(q, k, v, True, window,
                                                with_lse=True)
    delta = bwd.row_delta(o, do)
    runs = [(bwd.flash_bwd_dq(q, k, v, do, lse_kernel, delta, True, window),
             *bwd.flash_bwd_dkv(q, k, v, do, lse_kernel, delta, True,
                                window))
            for _ in range(2)]
    want = attention_bwd_ref(q, k, v, o, lse, do, True, window)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          f"backward kernels differ between two runs at {name}")
    dtype = str(q.dtype).replace("torch.", "")
    row = {"shape": name, "fwd_kernel_route": kernel.route(q), "B": B,
           "S": S, "K": K, "H": H, "Hkv": Hkv, "D": D, "window": window,
           "dtype": dtype, "strided": not q.is_contiguous()}
    G = H // Hkv
    for what, got, ref, n in (("lse", lse_kernel, lse, K),
                              ("dq", runs[0][0], want[0], K),
                              ("dk", runs[0][1], want[1], G * S),
                              ("dv", runs[0][2], want[2], G * S)):
        check(bool(torch.isfinite(got).all()), f"{what} not finite at {name}")
        diff = (got.float() - ref.float()).abs()
        worst = float((diff / grad_limit(ref, n)).max())
        row[f"{what}_max_abs_err"] = float(diff.max())
        row[f"{what}_err_over_limit"] = worst
        check(worst <= 1.0, f"{what} differs from its plain version at "
              f"{name}: {worst} times its limit")
    del runs
    pairs = attention_pairs(S, K, True, window)
    product = 2 * D * pairs * B * H          # flops of one masked product
    es = q.element_size()
    reads = (q.numel() + k.numel() + v.numel() + do.numel()) * es \
        + 2 * lse.numel() * 4                # q, k, v, do, lse, delta
    peak = PEAK_FLOPS[dtype]
    for kname, flops, nbytes in (
            ("dq", 3 * product, reads + q.numel() * es),
            ("dkv", 4 * product, reads + 2 * k.numel() * es)):
        op_ms, byte_ms = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        row[f"{kname}_flops"] = flops
        row[f"{kname}_bound_ms"] = max(op_ms, byte_ms)
        row[f"{kname}_bound_by"] = ("operations" if op_ms >= byte_ms
                                    else "bytes")
    if timed:
        dq_buf = torch.empty_like(q, memory_format=torch.contiguous_format)
        dk_buf, dv_buf = torch.empty_like(k), torch.empty_like(v)
        out_buf = torch.empty_like(dq_buf)
        row.update(
            fwd_lse_ms=time_ms(lambda: kernel.launch(q, k, v, out_buf, True,
                                                     window, lse_kernel),
                               reps=10),
            dq_ms=time_ms(lambda: bwd.launch_dq(q, k, v, do, lse, delta,
                                                dq_buf, True, window),
                          reps=10),
            dkv_ms=time_ms(lambda: bwd.launch_dkv(q, k, v, do, lse, delta,
                                                  dk_buf, dv_buf, True,
                                                  window), reps=10),
            plain_ms=time_ms(lambda: attention_bwd_ref(
                q, k, v, o, lse, do, True, window), reps=3, warmup=1),
            library_ms=None, library_backend=None)
        row["dq_tflops"] = row["dq_flops"] / row["dq_ms"] / 1e9
        row["dkv_tflops"] = row["dkv_flops"] / row["dkv_ms"] / 1e9
        if library:
            row["library_ms"], row["library_backend"] = sdpa_backward_ms(
                q, k, v, do)
    return row


def flash_bwd_phase():
    """The backward kernels at the training path's shape (qwen3-4b, one
    microbatch: B 1, S 4096), at D 256 with a window, with K > S and ragged
    S and K, in f32 with and without a window, and on heads sliced out of a
    wider tensor; inputs drawn on the card from seed 1."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def qkvdo(B, S, K, H, Hkv, D, dtype):
        return [torch.randn(*shape, generator=g, device=dev).to(dtype)
                for shape in ((B, S, H, D), (B, K, Hkv, D), (B, K, Hkv, D),
                              (B, S, H, D))]

    bf16, f32 = torch.bfloat16, torch.float32
    wide = torch.randn(1, 2048, 32 + 8 + 8 + 32, 128, generator=g,
                       device=dev).to(bf16)
    strided = [wide[:, :, :32], wide[:, :, 32:40], wide[:, :, 40:48],
               wide[:, :, 48:]]
    cases = [
        ("path_bf16", qkvdo(1, 4096, 4096, 32, 8, 128, bf16), 0, True, True),
        ("d256_window1024_bf16", qkvdo(1, 4096, 4096, 16, 8, 256, bf16),
         1024, True, False),
        ("k_gt_s_ragged_bf16", qkvdo(1, 1000, 3000, 32, 8, 128, bf16), 0,
         True, False),
        ("f32", qkvdo(1, 2048, 2048, 32, 8, 128, f32), 0, True, True),
        ("f32_window1024", qkvdo(1, 4096, 4096, 32, 8, 128, f32), 1024,
         True, False),
        ("strided_heads_bf16", strided, 0, False, False),
    ]
    rows = []
    for name, t, window, timed, library in cases:
        rows.append(bwd_case(name, *t, window, timed, library))
        del t
    return rows


# --------------------------------------------------------------------------
# phase: qwen3-4b training
# --------------------------------------------------------------------------
def fingerprint(p):
    """An exact fingerprint of an f32 tensor's bits: their int64 sum."""
    import torch
    return int(p.detach().view(torch.int32).sum(dtype=torch.int64))


def launch_counts():
    from repro_torch.kernels.dht_gather import ops as dht_ops
    from repro_torch.kernels.embedding_bag import ops as embag_ops
    from repro_torch.kernels.flash_attention import bwd, ops as flash_ops
    from repro_torch.kernels.segment_matmul import ops as seg_ops
    by_route = flash_ops.flash_attention.launches_by_route
    return {"fwd": flash_ops.flash_attention.launches,
            "fwd_wgmma": by_route["wgmma"], "fwd_simt": by_route["simt"],
            "dq": bwd.flash_bwd_dq.launches,
            "dkv": bwd.flash_bwd_dkv.launches,
            "dht_gather": dht_ops.dht_gather.launches,
            "segment_matmul": seg_ops.segment_matmul.launches,
            "embedding_bag": embag_ops.embedding_bag.launches}


def zero_launch_counts():
    from repro_torch.kernels.dht_gather import ops as dht_ops
    from repro_torch.kernels.embedding_bag import ops as embag_ops
    from repro_torch.kernels.flash_attention import bwd, ops as flash_ops
    from repro_torch.kernels.segment_matmul import ops as seg_ops
    flash_ops.flash_attention.launches = 0
    flash_ops.flash_attention.launches_by_route = {"wgmma": 0, "simt": 0}
    bwd.flash_bwd_dq.launches = bwd.flash_bwd_dkv.launches = 0
    dht_ops.dht_gather.launches = 0
    seg_ops.segment_matmul.launches = 0
    embag_ops.embedding_bag.launches = 0


# kernel names of the step's parts, as the profiler reports them
KERNEL_KINDS = (("flash_fwd", ("flash_fwd_kernel",
                                "flash_fwd_wgmma_kernel")),
                ("flash_bwd_dq", ("flash_bwd_dq_kernel",)),
                ("flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
                ("matmul", ("gemm", "xmma", "nvjet", "cutlass")))


def device_time_by_kind(prof, wall_ms, kinds=KERNEL_KINDS):
    """Device time (ms) of the profiled region by kind of kernel (``kinds``:
    (kind, name patterns) pairs), the device's busy share of the host wall
    time, and the ten slowest other kernels."""
    import torch
    by_kind = {kind: 0.0 for kind, _ in kinds}
    other, count = {}, 0
    for e in prof.key_averages():
        # the device's own events only: a CPU op's self device time repeats
        # its kernels', a user annotation spans them
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.is_user_annotation):
            continue
        ms = e.self_device_time_total / 1e3
        if ms <= 0:
            continue
        count += e.count
        kind = next((kind for kind, pats in kinds
                     if any(p in e.key.lower() for p in pats)), None)
        if kind:
            by_kind[kind] += ms
        else:
            other[e.key] = other.get(e.key, 0.0) + ms
    busy = sum(by_kind.values()) + sum(other.values())
    check(busy > 0, "the profiler saw no device time")
    top = sorted(other.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ms": busy, "busy_share": busy / wall_ms,
            "device_events": count, "by_kind_ms": by_kind,
            "other_ms": sum(other.values()),
            "top_other": [{"kernel": k[:120], "ms": v} for k, v in top]}


def lm_train_phase():
    """Three AdamW steps of qwen3-4b (full width and depth, f32 parameters,
    bf16 compute, remat "full", 2 microbatches of 1 at S 4096), the launch
    counts set to 0 just before each step and read just after.  Returns
    the launches of the three steps."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import LM_SHAPES
    from repro_torch.data.tokens import TokenStreamConfig, batch_at_step
    from repro_torch.launch.steps import lm_train_step
    from repro_torch.models.transformer import TransformerLM, init_params
    from repro_torch.optim import adamw

    dev = torch.device("cuda")
    cfg = dataclasses.replace(registry.get(LM_ARCH).config,
                              attention_impl="pallas", remat="full",
                              n_microbatches=TRAIN_MICRO)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=100)
    shape = LM_SHAPES[LM_SHAPE]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = TransformerLM(cfg, init_params(
        cfg, torch.Generator(device=dev).manual_seed(LM_SEED)))
    state = adamw.init_state(model, opt_cfg)
    named = dict(model.named_parameters())
    n_params = sum(p.numel() for p in named.values())
    check(all(p.dtype == torch.float32 for p in named.values()),
          "training parameters are not f32")
    before = {n: fingerprint(p) for n, p in named.items()}
    torch.cuda.synchronize()
    emit({"phase": "lm_train_setup", "arch": LM_ARCH,
          "n_layers": cfg.n_layers, "params": n_params,
          "params_grads_m_v_gib": 16 * n_params / 2**30,
          "allocated_gib": torch.cuda.memory_allocated() / 2**30,
          "card_gib": torch.cuda.get_device_properties(0).total_memory
          / 2**30, "global_batch": TRAIN_BATCH,
          "microbatches": TRAIN_MICRO, "seq": shape.seq_len,
          "remat": cfg.remat, "seconds": time.perf_counter() - t0})
    stream = TokenStreamConfig(cfg.vocab, shape.seq_len, TRAIN_BATCH,
                               seed=LM_DATA_SEED)
    want = {"fwd": 2 * TRAIN_MICRO * cfg.n_layers,
            "fwd_wgmma": 2 * TRAIN_MICRO * cfg.n_layers, "fwd_simt": 0,
            "dq": TRAIN_MICRO * cfg.n_layers,
            "dkv": TRAIN_MICRO * cfg.n_layers, "dht_gather": 0,
            "segment_matmul": 0, "embedding_bag": 0}
    total = dict.fromkeys(want, 0)
    losses = []
    profiled = TRAIN_STEPS - 1   # the last step runs under the profiler
    for step in range(TRAIN_STEPS):
        tokens, labels = batch_at_step(stream, step)
        tokens = torch.from_numpy(tokens).to(dev)
        labels = torch.from_numpy(labels).to(dev)
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA],
                record_shapes=False) if step == profiled \
                else contextlib.nullcontext() as prof:
            t0 = time.perf_counter()
            metrics = lm_train_step(model, opt_cfg, state, tokens, labels)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = launch_counts()
        check(launches == want, f"step {step} launched {launches}, "
              f"expected {want}")
        for key in total:
            total[key] += launches[key]
        m = {k: float(v) for k, v in metrics.items()}
        losses.append(m["loss"])
        check(all(math.isfinite(x) for x in m.values()),
              f"step {step} metrics not finite: {m}")
        check(m["grad_norm"] > 0, f"step {step} grad norm {m['grad_norm']}")
        if step == 0:
            check(abs(m["nll"] / math.log(cfg.vocab) - 1) < 0.35,
                  f"untrained nll {m['nll']} far from ln(V) "
                  f"{math.log(cfg.vocab)}")
        emit({"phase": "lm_train", "step": step, "step_s": wall,
              "tokens_per_s": TRAIN_BATCH * shape.seq_len / wall,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
              "profiled": step == profiled, "launches": launches, **m})
        if step == profiled:
            emit({"phase": "lm_train_profile", "step": step, "wall_ms":
                  wall * 1e3, **device_time_by_kind(prof, wall * 1e3)})
    check(int(state["step"]) == TRAIN_STEPS,
          f"AdamW step count {int(state['step'])}")
    unchanged = [n for n, p in named.items() if fingerprint(p) == before[n]]
    check(not unchanged, f"parameters unchanged by training: {unchanged}")
    emit({"phase": "lm_train_summary", "losses": losses,
          "launches": total})
    del model, state, named, metrics
    torch.cuda.empty_cache()
    return total


def lm_train_vs_xla_phase():
    """Every gradient of a 4-layer qwen3-4b at full width (B 1, S 1024,
    f32 compute and parameters, TF32 off) through the kernels, against the
    same gradients through the xla attention and with remat "full"."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.data.tokens import TokenStreamConfig, batch_at_step
    from repro_torch.models.transformer import TransformerLM, init_params

    dev = torch.device("cuda")
    base = dataclasses.replace(registry.get(LM_ARCH).config,
                               n_layers=GRAD_LAYERS, dtype=torch.float32,
                               attention_impl="pallas")
    params = init_params(base, torch.Generator(device=dev).manual_seed(
        LM_SEED))
    tokens, labels = batch_at_step(TokenStreamConfig(
        base.vocab, GRAD_SEQ, 1, seed=LM_DATA_SEED), 0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    grads, launched = {}, {}
    try:
        for key, change in (("pallas", {}), ("xla",
                                              {"attention_impl": "xla"}),
                            ("pallas_remat_full", {"remat": "full"})):
            model = TransformerLM(dataclasses.replace(base, **change),
                                  params)
            zero_launch_counts()
            loss, _ = model.loss_fn(tokens, labels)
            loss.backward()
            torch.cuda.synchronize()
            launched[key] = launch_counts()
            grads[key] = {n: p.grad for n, p in model.named_parameters()}
            del model, loss
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    L = GRAD_LAYERS
    # f32: the forward takes the SIMT route
    check(launched["pallas"] == {"fwd": L, "fwd_wgmma": 0, "fwd_simt": L,
                                 "dq": L, "dkv": L, "dht_gather": 0,
                                 "segment_matmul": 0, "embedding_bag": 0},
          f"pallas gradients launched {launched['pallas']}")
    check(launched["xla"] == dict.fromkeys(launched["xla"], 0),
          f"xla gradients launched {launched['xla']}")
    check(launched["pallas_remat_full"]["fwd"] == 2 * L,
          f"remat gradients launched {launched['pallas_remat_full']}")
    out = {}
    for other in ("xla", "pallas_remat_full"):
        worst, worst_name, max_diff = 0.0, "", 0.0
        for name, ref in grads[other].items():
            got = grads["pallas"][name]
            diff = (got - ref).abs()
            live = ref[ref != 0]
            rms = float(live.double().pow(2).mean().sqrt()) if live.numel() \
                else 0.0
            share = float((diff / (GRAD_RTOL * ref.abs()
                                   + GRAD_FLOOR * rms)).max())
            max_diff = max(max_diff, float(diff.max()))
            if share > worst:
                worst, worst_name = share, name
        out[other] = {"max_abs_diff": max_diff, "err_over_limit": worst,
                      "worst_tensor": worst_name}
        check(worst <= 1.0, f"pallas gradients differ from {other}'s at "
              f"{worst_name}: {worst} times the limit")
    emit({"phase": "lm_train_vs_xla", "n_layers": L, "seq": GRAD_SEQ,
          "dtype": "float32", "rtol": GRAD_RTOL, "floor_of_rms": GRAD_FLOOR,
          "launches": launched, **out})
    del grads, params
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase: gin-tu training on Reddit-scale sampled blocks
# --------------------------------------------------------------------------
GNN_KERNEL_KINDS = (("segment_matmul", ("segment_matmul_kernel",)),
                    ("matmul", ("gemm", "xmma", "nvjet", "cutlass")),
                    ("index_add", ("indexfunc",)),
                    ("gather", ("gather_kernel", "indexselect")))


def seg_case(name, x, nbr, w, timed):
    """``segment_matmul`` kernel (twice, and once with the f32 sum) against
    its plain version on one input, per element within
    ``ref.product_limit``; timings when ``timed``, with the library
    yardstick (``F.embedding_bag`` then ``torch.matmul``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.segment_matmul import kernel
    from repro_torch.kernels.segment_matmul.ref import (
        neighbor_sum, product_limit, segment_matmul_ref)
    out = kernel.segment_matmul_cuda(x, nbr, w)
    again = kernel.segment_matmul_cuda(x, nbr, w)
    out_agg, agg = kernel.segment_matmul_cuda(x, nbr, w, with_agg=True)
    want_agg = neighbor_sum(x, nbr)
    want = segment_matmul_ref(x, nbr, w)
    torch.cuda.synchronize()
    check(torch.equal(out, again) and torch.equal(out, out_agg),
          f"segment_matmul differs between runs at {name}")
    check(torch.equal(agg, want_agg),
          f"segment_matmul's f32 sum differs from the plain one at {name}")
    check(bool(torch.isfinite(out).all()), f"segment_matmul not finite at "
          f"{name}")
    diff = (out.float() - want.float()).abs()
    limit = product_limit(want_agg, w, x.dtype)
    over = diff > limit
    check(not bool(over.any()), f"segment_matmul differs from its plain "
          f"version at {name} in {int(over.sum())} elements")
    worst = float((diff / limit.clamp(min=1e-30)).max())
    (M, K), (N, D), F_ = nbr.shape, x.shape, w.shape[1]
    valid = nbr >= 0
    rows_read = int(torch.unique(nbr[valid]).numel())
    rows_with = int(valid.any(1).sum())
    es = x.element_size()
    # least bytes: each row that a valid slot names read once, nbr and W
    # read once, out written once (and the f32 sum, when asked for);
    # operations: the valid slots' adds and the product of the rows that
    # have a neighbour, in f32 on the CUDA cores
    nbytes = rows_read * D * es + M * K * 4 + D * F_ * es + M * F_ * es
    agg_bytes = M * D * 4
    flops = int(valid.sum()) * D + 2 * rows_with * D * F_
    op_ms = flops / PEAK_FLOPS["float32"] * 1e3
    row = {"shape": name, "M": M, "N": N, "K": K, "D": D, "F": F_,
           "dtype": str(x.dtype).replace("torch.", ""),
           "valid_slots": int(valid.sum()), "rows_read": rows_read,
           "rows_with_neighbours": rows_with,
           "max_abs_err": float(diff.max()), "err_over_limit": worst,
           "bytes": nbytes, "flops": flops,
           "bound_ms": max(nbytes / HBM_BYTES_PER_S * 1e3, op_ms),
           "bound_by": "operations" if op_ms > nbytes / HBM_BYTES_PER_S
           * 1e3 else "bytes",
           "bound_with_agg_ms": max((nbytes + agg_bytes) / HBM_BYTES_PER_S
                                    * 1e3, op_ms)}
    del diff, limit, over, want, want_agg, agg, out_agg, again
    if timed:
        buf = torch.empty_like(out)
        agg_buf = torch.empty((M, D), dtype=torch.float32, device=x.device)
        idx = nbr.clamp(0, N - 1)
        weights = valid.to(x.dtype)
        row.update(
            ms=time_ms(lambda: kernel.launch(x, nbr, w, buf)),
            with_agg_ms=time_ms(lambda: kernel.launch(x, nbr, w, buf,
                                                      agg_buf)),
            plain_ms=time_ms(lambda: segment_matmul_ref(x, nbr, w), reps=5,
                             warmup=1),
            library_ms=time_ms(lambda: torch.matmul(F.embedding_bag(
                idx, x, mode="sum", per_sample_weights=weights), w)),
            library="F.embedding_bag(mode='sum', per_sample_weights=valid) "
                    "then torch.matmul")
    return row


def coo_logits(model, batch):
    """GIN's logits through the reference's edge-list layer: gather the
    senders' rows, ``scatter_sum`` them into the receivers, then
    ``mlp2((1 + eps) x + agg)``, as ``models/gnn/gin.py`` of the JAX
    package computes it; no kernel."""
    import torch
    from repro_torch.models.gnn.common import (gather, graph_readout,
                                               linear, mlp2, scatter_sum)
    with torch.no_grad():
        x = batch.node_feat.to(model.cfg.dtype)
        for layer in model.layers:
            agg = scatter_sum(gather(x, batch.senders), batch.receivers,
                              batch.n_nodes, batch.edge_mask)
            x = mlp2(layer.mlp, (1.0 + layer.eps) * x + agg, act=torch.relu)
        pooled = graph_readout(x, batch.graph_ids, batch.n_graphs,
                               batch.node_mask, op="sum")
        return linear(model.readout, pooled)


def check_close(name, got, want):
    """|got - want| <= GNN_RTOL max |want|; returns the difference's share
    of that limit."""
    got, want = got.double(), want.double()
    limit = GNN_RTOL * float(want.abs().max())
    share = float((got - want).abs().max()) / limit
    check(share <= 1.0, f"{name}: {share} times the limit {limit}")
    return share


def gnn_phase():
    """gin-tu at full width (5 layers, d_hidden 64, d_feat 602, f32) on
    1024-seed (15, 10) blocks of a Reddit-scale RMAT graph: one
    ``gnn_forward_step``, then ``GNN_STEPS`` ``gnn_train_step``s on fresh
    blocks, the launch counts set to 0 just before each and read just
    after.  Returns the launches of the four runs and the kernel's rows
    on layer 0's and layer 1's own inputs."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import GNN_SHAPES, sampled_block_sizes
    from repro_torch.data.graphs import NeighborSampler
    from repro_torch.graph import generators as gen
    from repro_torch.kernels.segment_matmul import ops as seg_ops
    from repro_torch.kernels.segment_matmul.ref import segment_matmul_ref
    from repro_torch.launch.steps import gnn_forward_step, gnn_train_step
    from repro_torch.models.gnn import gin
    from repro_torch.optim import adamw

    dev = torch.device("cuda")
    shape = GNN_SHAPES[GNN_SHAPE]
    n_seeds, fanout = shape.batch_nodes, shape.fanout
    n_block, e_block = sampled_block_sizes(shape)
    t0 = time.perf_counter()
    g = gen.rmat(GNN_RMAT_LOG2, GNN_RMAT_DEG, seed=GNN_GRAPH_SEED)
    graph_s = time.perf_counter() - t0
    deg = g.degrees()
    t0 = time.perf_counter()
    sampler = NeighborSampler(g, fanout, seed=GNN_SAMPLER_SEED, device=dev)
    csr_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    feat = np.random.default_rng(GNN_FEAT_SEED).standard_normal(
        (g.n, shape.d_feat)).astype(np.float32)
    feat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    table = torch.from_numpy(feat).to(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    del feat
    cfg = dataclasses.replace(registry.get(GNN_ARCH).config,
                              d_feat=shape.d_feat)
    model = gin.GIN(cfg, seed=GNN_PARAM_SEED, device=dev)
    check(model.device.type == "cuda", f"model on {model.device}, not cuda")
    opt_cfg = adamw.AdamWConfig()   # the reference's specs._opt_cfg()
    state = adamw.init_state(model, opt_cfg)
    named = dict(model.named_parameters())
    before = {n: fingerprint(p) for n, p in named.items()}
    emit({"phase": "gnn_setup", "arch": GNN_ARCH, "shape": GNN_SHAPE,
          "n": g.n, "m": g.m, "directed_edges": 2 * g.m,
          "max_degree": int(deg.max()), "rmat_s": graph_s, "csr_s": csr_s,
          "features_s": feat_s, "upload_s": upload_s,
          "table_gib": table.numel() * 4 / 2**30,
          "params": sum(p.numel() for p in named.values()),
          "block_nodes": n_block, "block_edges": e_block})
    del deg
    seed_rng = np.random.default_rng(GNN_SEED_SEED)

    def next_block():
        seeds = seed_rng.integers(0, g.n, n_seeds)
        label = int(seed_rng.integers(0, cfg.n_classes))
        t0 = time.perf_counter()
        sample = sampler.sample(seeds)
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block = sampler.to_block(sample, table, None)
        torch.cuda.synchronize()
        gather_s = time.perf_counter() - t0
        block = dataclasses.replace(block, labels=torch.tensor(
            [label], device=dev))
        check(block.n_nodes == n_block and block.senders.shape[0]
              == e_block, f"block of {block.n_nodes} nodes and "
              f"{block.senders.shape[0]} edges")
        hop1 = n_seeds * fanout[0]
        valid = (block.nbr >= 0).sum(1)
        check(tuple(block.nbr.shape) == (n_block, max(fanout))
              and bool((valid[:n_seeds] == fanout[0]).all())
              and bool((valid[n_seeds:n_seeds + hop1] == fanout[1]).all())
              and bool((valid[n_seeds + hop1:] == 0).all()),
              "nbr is not 15 slots on the seeds, 10 on hop 1, 0 on hop 2")
        return block, {"label": label, "sample_s": host_s,
                       "gather_s": gather_s}

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernel_call = seg_ops.segment_matmul
    check(gin.segment_matmul is kernel_call,
          "GIN does not call ops.segment_matmul")
    recorded = []

    def recording(x, nbr, w):
        if len(recorded) < 2:
            recorded.append((x.detach(), nbr, w.detach()))
        return kernel_call(x, nbr, w)

    total = dict.fromkeys(launch_counts(), 0)
    want = dict(total, segment_matmul=cfg.n_layers)
    try:
        # one forward, through the kernel, then through the plain version
        # and the reference's edge-list layer on the same block
        block, times = next_block()
        gin.segment_matmul = recording
        zero_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = gnn_forward_step(model, block)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        gin.segment_matmul = kernel_call
        check(launches == want, f"the forward launched {launches}, expected "
              f"{want}")
        total = {k: total[k] + launches[k] for k in total}
        check(tuple(logits.shape) == (1, cfg.n_classes)
              and bool(torch.isfinite(logits).all()), "logits")
        gin.segment_matmul = segment_matmul_ref
        plain = gnn_forward_step(model, block)
        gin.segment_matmul = kernel_call
        coo = coo_logits(model, block)
        share_plain = check_close("logits against the plain version", logits,
                                  plain)
        share_coo = check_close("logits against the edge-list layer", logits,
                                coo)
        emit({"phase": "gnn_forward", "forward_s": wall, **times,
              "seeds_per_s": n_seeds / (wall + times["sample_s"]
                                        + times["gather_s"]),
              "launches": launches, "logits": logits.tolist(),
              "plain_logits": plain.tolist(), "coo_logits": coo.tolist(),
              "err_over_limit_plain": share_plain,
              "err_over_limit_coo": share_coo, "rtol_of_max": GNN_RTOL,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
        check(len(recorded) == 2, f"recorded {len(recorded)} layers")
        rows = [seg_case("gin_layer0", *recorded[0], timed=True),
                seg_case("gin_layer1", *recorded[1], timed=True)]
        x0, nbr0, w0 = recorded[0]
        rows.append(seg_case("gin_layer0_bf16", x0.bfloat16(), nbr0,
                             w0.bfloat16(), timed=True))
        del recorded[:], x0, w0, nbr0, block, logits, plain, coo

        losses = []
        profiled = GNN_STEPS - 1   # the last step runs under the profiler
        for step in range(GNN_STEPS):
            block, times = next_block()
            ref_loss = None
            if step == 0:
                logits = coo_logits(model, block).float()
                ref_loss = float(torch.logsumexp(logits, -1)[0]
                                 - logits[0, times["label"]])
            zero_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU,
                                torch.profiler.ProfilerActivity.CUDA],
                    record_shapes=False) if step == profiled \
                    else contextlib.nullcontext() as prof:
                t0 = time.perf_counter()
                metrics = gnn_train_step(model, opt_cfg, state, block)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = launch_counts()
            check(launches == want, f"step {step} launched {launches}, "
                  f"expected {want}")
            total = {k: total[k] + launches[k] for k in total}
            m = {k: float(v) for k, v in metrics.items()}
            losses.append(m["loss"])
            check(all(math.isfinite(x) for x in m.values()),
                  f"step {step} metrics not finite: {m}")
            # at initialization the sum readout saturates the softmax: a
            # block whose label is the larger logit has loss 0 and a zero
            # gradient, any other a loss and gradient of that gap's size
            check(m["grad_norm"] > 0 if m["loss"] > 0
                  else m["grad_norm"] == 0,
                  f"step {step} grad norm {m['grad_norm']} at loss "
                  f"{m['loss']}")
            if ref_loss is not None:
                # the sum readout over 169,984 nodes gives logits of some
                # 1e4-1e5 at initialization, so the loss is the gap between
                # two of them, not ln 2: it is held against the edge-list
                # layer's loss on the same block and parameters instead,
                # within the logits' limit twice (logsumexp and the gold
                # logit each move by at most the largest logit's error)
                limit = 2 * GNN_RTOL * float(logits.abs().max())
                check(abs(m["loss"] - ref_loss) <= limit,
                      f"step 0 loss {m['loss']} vs the edge-list layer's "
                      f"{ref_loss} (limit {limit})")
            emit({"phase": "gnn_train", "step": step, "step_s": wall,
                  **times, "seeds_per_s": n_seeds / (
                      wall + times["sample_s"] + times["gather_s"]),
                  "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                  "profiled": step == profiled, "launches": launches,
                  "edge_list_loss": ref_loss, **m})
            if step == profiled:
                emit({"phase": "gnn_train_profile", "step": step,
                      "wall_ms": wall * 1e3,
                      **device_time_by_kind(prof, wall * 1e3,
                                            GNN_KERNEL_KINDS)})
            del block
    finally:
        gin.segment_matmul = kernel_call
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    check(int(state["step"]) == GNN_STEPS,
          f"AdamW step count {int(state['step'])}")
    # with a gradient in some step every parameter moves; without one only
    # weight decay moves them, and it leaves the zeros (eps, biases) alone
    unchanged = [n for n, p in named.items() if fingerprint(p) == before[n]
                 and (max(losses) > 0 or bool(p.any()))]
    check(not unchanged, f"parameters unchanged by training: {unchanged}")
    emit({"phase": "gnn_train_summary", "losses": losses, "launches": total})
    del model, state, named, table, sampler, g
    torch.cuda.empty_cache()
    return total, rows


# --------------------------------------------------------------------------
# phase: SASRec serving and training on the 1M-item table
# --------------------------------------------------------------------------
REC_KERNEL_KINDS = (("dht_gather", ("dht_gather_kernel",)),
                    ("matmul", ("gemm", "xmma", "nvjet", "cutlass")),
                    ("index_add", ("indexfunc",)),
                    ("sort", ("sort",)),
                    ("softmax", ("softmax",)))


@contextlib.contextmanager
def plain_item_reads():
    """Every SASRec item read (``core.dht.DedupGather``) takes
    ``dht_gather``'s plain version on the card inside this context."""
    from repro_torch.kernels.dht_gather import ops as dht_ops
    kernel_call = dht_ops.dht_gather
    dht_ops.dht_gather = plain_dht_gather
    try:
        yield
    finally:
        dht_ops.dht_gather = kernel_call


def rec_phase():
    """SASRec at full size on the card, cell by cell of ``REC_SHAPES``:
    ``serve_p99``, ``serve_bulk``, ``retrieval_cand`` and ``train_batch``,
    every call with the launch counts set to 0 just before and read just
    after.  Returns the ``dht_gather`` launches by cell, the kernel's row
    on the training batch's history read, the trained item table and step
    0's histories (the ``embedding_bag`` phase's table and bags)."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.data.recsys import RecStreamConfig, batch_at_step
    from repro_torch.launch.steps import (rec_retrieval_step, rec_serve_step,
                                          rec_train_step)
    from repro_torch.models.sasrec import SASRec
    from repro_torch.optim import adamw

    dev = torch.device("cuda")
    entry = registry.get(REC_ARCH)
    cfg, shapes = entry.config, entry.shapes
    t0 = time.perf_counter()
    model = SASRec(cfg, seed=REC_PARAM_SEED, device=dev)
    torch.cuda.synchronize()
    check(model.device.type == "cuda", f"model on {model.device}, not cuda")
    named = dict(model.named_parameters())
    emit({"phase": "rec_setup", "arch": REC_ARCH, "n_items": cfg.n_items,
          "embed_dim": cfg.embed_dim, "n_blocks": cfg.n_blocks,
          "n_heads": cfg.n_heads, "seq_len": cfg.seq_len,
          "params": sum(p.numel() for p in named.values()),
          "init_s": time.perf_counter() - t0})
    cand_rng = np.random.default_rng(REC_CAND_SEED)
    none = dict.fromkeys(launch_counts(), 0)

    def batch(B, step):
        """(item_seq, pos, neg) of the stream at batch B, on the card."""
        arrays = batch_at_step(RecStreamConfig(
            cfg.n_items, cfg.seq_len, B, seed=REC_DATA_SEED), step)
        return [torch.from_numpy(a).to(dev) for a in arrays]

    def candidates(B):
        return torch.from_numpy(cand_rng.integers(
            1, cfg.n_items, (B, REC_CANDIDATES)).astype(np.int32)).to(dev)

    def counted(name, fn, want):
        """One call of ``fn`` between the counts' reset and their reading:
        (its result, its wall seconds ending in a synchronize)."""
        zero_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        check(launches == want, f"{name} launched {launches}, expected "
              f"{want}")
        check(bool(torch.isfinite(out if torch.is_tensor(out)
                                  else out["loss"]).all()),
              f"{name}: output not finite")
        return out, wall

    serve = dict(none, dht_gather=2)      # the history's and candidates'
    by_cell = {}

    # serve_p99: one batch of 512 users, 1024 candidates each
    B = shapes["serve_p99"].global_batch
    seq, _, _ = batch(B, 0)
    cands = candidates(B)
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for rep in range(REC_SERVE_REPS):
        scores, wall = counted("serve_p99", lambda: rec_serve_step(
            model, seq, cands), serve)
        walls.append(wall)
    check(tuple(scores.shape) == (B, REC_CANDIDATES), "serve_p99 shape")
    with plain_item_reads():
        plain = rec_serve_step(model, seq, cands)
    torch.cuda.synchronize()
    check(torch.equal(scores, plain), "serve_p99 scores through the kernel "
          "differ from the plain gather's")
    by_cell["rec_serve_p99"] = serve["dht_gather"] * REC_SERVE_REPS
    emit({"phase": "rec_serve_p99", "batch": B, "candidates": REC_CANDIDATES,
          "walls_s": walls, "users_per_s": B / sorted(walls)[len(walls) // 2],
          "equal_to_plain_gather": True,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    del scores, plain, seq, cands

    # serve_bulk: 262,144 users in calls of 32,768
    shape = shapes["serve_bulk"]
    B = shape.global_batch // REC_BULK_CALLS
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for call in range(REC_BULK_CALLS):
        seq, _, _ = batch(B, call)
        cands = candidates(B)
        scores, wall = counted("serve_bulk", lambda: rec_serve_step(
            model, seq, cands), serve)
        check(tuple(scores.shape) == (B, REC_CANDIDATES), "serve_bulk shape")
        walls.append(wall)
        del scores, seq, cands
    by_cell["rec_serve_bulk"] = serve["dht_gather"] * REC_BULK_CALLS
    emit({"phase": "rec_serve_bulk", "users": shape.global_batch,
          "calls": REC_BULK_CALLS, "batch": B, "walls_s": walls,
          "wall_s": sum(walls), "users_per_s": shape.global_batch
          / sum(walls),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})

    # retrieval_cand: one user against every item
    shape = shapes["retrieval_cand"]
    seq, _, _ = batch(shape.global_batch, 0)
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for rep in range(REC_SERVE_REPS):
        ret, wall = counted("retrieval_cand", lambda: rec_retrieval_step(
            model, seq), dict(none, dht_gather=1))
        walls.append(wall)
    check(tuple(ret.shape) == (shape.global_batch, shape.n_candidates),
          f"retrieval scores of shape {tuple(ret.shape)}")
    # the top 1024 items scored as candidates: the same dot products, by
    # another product (bmm against mm), within 1e-5 of the largest
    top = ret.topk(REC_CANDIDATES, dim=-1)
    again = rec_serve_step(model, seq, top.indices.to(torch.int32))
    share = float((again - top.values).abs().max()) / (
        1e-5 * float(top.values.abs().max()))
    check(share <= 1.0, f"retrieval's top scores against candidate "
          f"scoring: {share} of the limit")
    by_cell["rec_retrieval_cand"] = REC_SERVE_REPS
    emit({"phase": "rec_retrieval_cand", "batch": shape.global_batch,
          "scores": shape.n_candidates, "walls_s": walls,
          "users_per_s": shape.global_batch
          / sorted(walls)[len(walls) // 2],
          "top_vs_candidates_err_over_limit": share,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    del ret, top, again, seq

    # train_batch: AdamW steps at 65,536 users
    B = shapes["train_batch"].global_batch
    opt_cfg = adamw.AdamWConfig()   # the reference's specs._opt_cfg()
    state = adamw.init_state(model, opt_cfg)
    before = {n: fingerprint(p) for n, p in named.items()}
    step_want = dict(none, dht_gather=3)   # history, positives, negatives
    losses, bags = [], None
    profiled = REC_TRAIN_STEPS - 1   # the last step runs under the profiler
    for step in range(REC_TRAIN_STEPS):
        seq, pos, neg = batch(B, step)
        if step == 0:
            bags = seq
        torch.cuda.reset_peak_memory_stats()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA],
                record_shapes=False) if step == profiled \
                else contextlib.nullcontext() as prof:
            metrics, wall = counted("train_batch", lambda: rec_train_step(
                model, opt_cfg, state, seq, pos, neg), step_want)
        m = {k: float(v) for k, v in metrics.items()}
        losses.append(m["loss"])
        check(all(math.isfinite(x) for x in m.values()),
              f"step {step} metrics not finite: {m}")
        check(m["grad_norm"] > 0, f"step {step} grad norm {m['grad_norm']}")
        if step == 0:
            check(abs(m["loss"] - math.log(2)) <= REC_LOSS0_TOL,
                  f"step 0 loss {m['loss']}, not within {REC_LOSS0_TOL} "
                  f"of ln 2")
        emit({"phase": "rec_train", "step": step, "batch": B, "step_s": wall,
              "users_per_s": B / wall, "tokens_per_s": B * cfg.seq_len / wall,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
              "profiled": step == profiled, **m})
        if step == profiled:
            emit({"phase": "rec_train_profile", "step": step,
                  "wall_ms": wall * 1e3,
                  **device_time_by_kind(prof, wall * 1e3,
                                        REC_KERNEL_KINDS)})
        del seq, pos, neg, metrics
    check(int(state["step"]) == REC_TRAIN_STEPS,
          f"AdamW step count {int(state['step'])}")
    unchanged = [n for n, p in named.items() if fingerprint(p) == before[n]]
    check(not unchanged, f"parameters unchanged by training: {unchanged}")
    by_cell["rec_train_batch"] = step_want["dht_gather"] * REC_TRAIN_STEPS
    emit({"phase": "rec_train_summary", "losses": losses,
          "dht_gather_launches": by_cell})
    table = model.item_embed.detach()
    row = dht_gather_case("sasrec_train_history", table, bags.reshape(-1),
                          timed=True)
    del model, state, named
    torch.cuda.empty_cache()
    return by_cell, row, table, bags


def embag_case(name, table, ids, timed):
    """The ``embedding_bag`` kernel (twice) against its plain version on
    one input, bit for bit; its bound and, when ``timed``, kernel, plain
    and library times (the library call on f32 tables of in-range ids)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag import kernel
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    out = kernel.embedding_bag_cuda(table, ids)
    again = kernel.embedding_bag_cuda(table, ids)
    want = embedding_bag_ref(table, ids)
    torch.cuda.synchronize()
    check(torch.equal(out, want), f"embedding_bag differs from its plain "
          f"version at {name}")
    check(torch.equal(out, again), f"embedding_bag differs between runs at "
          f"{name}")
    (V, D), (B, L) = table.shape, ids.shape
    valid = ids > 0
    rows_read = int(torch.unique(ids[valid].clamp(max=V - 1)).numel())
    es = table.element_size()
    # least bytes: each distinct row a valid id names read once, the ids
    # read once, the sums written once; one f32 add per valid element
    nbytes = rows_read * D * es + B * L * 4 + B * D * es
    flops = int(valid.sum()) * D
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / PEAK_FLOPS["float32"] * 1e3
    err = 0.0
    if out.numel():
        err = float((out.double() - want.double()).abs().max())
    row = {"shape": name, "V": V, "D": D, "B": B, "L": L,
           "dtype": str(table.dtype).replace("torch.", ""),
           "valid_ids": int(valid.sum()), "rows_read": rows_read,
           "max_abs_err": err, "bytes": nbytes, "flops": flops,
           "bound_ms": max(byte_ms, op_ms),
           "bound_by": "operations" if op_ms > byte_ms else "bytes"}
    if timed:
        buf = torch.empty_like(out)
        row.update(ms=time_ms(lambda: kernel.launch(table, ids, buf)),
                   plain_ms=time_ms(lambda: embedding_bag_ref(table, ids),
                                    reps=5, warmup=1),
                   library_ms=None)
        if table.dtype == torch.float32 and bool(
                ((ids >= 0) & (ids < V)).all()):
            lib = F.embedding_bag(ids, table, mode="sum", padding_idx=0)
            row.update(
                library_ms=time_ms(lambda: F.embedding_bag(
                    ids, table, mode="sum", padding_idx=0)),
                library="F.embedding_bag(mode='sum', padding_idx=0)",
                library_max_abs_diff=float((lib - out).abs().max()))
    return row


def embedding_bag_phase(table, bags):
    """``embedding_bag`` on SASRec's trained item table with step 0's
    65,536 histories as bags: one call of the op, the counts set to 0 just
    before and read just after; then the kernel against its plain version
    there, in bf16, at the JAX package's test shapes and at edge cases.
    Returns the op's launches and the rows."""
    import numpy as np
    import torch
    from repro_torch.kernels.embedding_bag import ops
    dev = torch.device("cuda")
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ops.embedding_bag(table, bags)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    want = dict.fromkeys(launches, 0)
    want["embedding_bag"] = 1
    check(launches == want, f"embedding_bag launched {launches}")
    check(tuple(out.shape) == (bags.shape[0], table.shape[1])
          and bool(torch.isfinite(out).all()), "embedding_bag output")
    emit({"phase": "embedding_bag", "bags": list(bags.shape),
          "table": list(table.shape), "wall_s": wall, "launches": launches})
    rows = [embag_case("sasrec_train_history", table, bags, timed=True),
            embag_case("sasrec_train_history_bf16", table.bfloat16(), bags,
                       timed=True)]
    # tests/test_kernels.py's shapes and draw, then D 37, L 0 and 1, a
    # ragged B, ids below 0 and past the table, L past a staging chunk
    for dtype in (torch.float32, torch.bfloat16):
        for V, D, B, L in EMBAG_TEST_SHAPES:
            rng = np.random.default_rng(3)
            t = torch.from_numpy(rng.standard_normal((V, D)).astype(
                np.float32)).to(dev).to(dtype)
            ids = rng.integers(0, V, (B, L)).astype(np.int32)
            ids[:, -1] = 0
            rows.append(embag_case(f"test_{V}x{D}_{B}x{L}", t,
                                   torch.from_numpy(ids).to(dev), False))
        for V, D, B, L in EMBAG_EDGE_SHAPES:
            rng = np.random.default_rng(4)
            t = torch.from_numpy(rng.standard_normal((V, D)).astype(
                np.float32)).to(dev).to(dtype)
            ids = rng.integers(-3, V + 5, (B, L)).astype(np.int32)
            rows.append(embag_case(f"edge_{V}x{D}_{B}x{L}", t,
                                   torch.from_numpy(ids).to(dev), False))
    return launches["embedding_bag"], rows


# --------------------------------------------------------------------------
def build_kernels():
    """Build every kernel from its source: one ``nvcc`` each, all started
    together."""
    from repro_torch.kernels.dht_gather import kernel as dht_gather_kernel
    from repro_torch.kernels.embedding_bag import kernel as embag_kernel
    from repro_torch.kernels.flash_attention import bwd as flash_bwd
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.segment_matmul import kernel as seg_kernel
    t0 = time.perf_counter()
    with ThreadPoolExecutor(6) as pool:
        futures = {"dht_gather": pool.submit(dht_gather_kernel.build, True),
                   "flash_attention_fwd_wgmma": pool.submit(
                       flash_kernel.build, "wgmma", True),
                   "flash_attention_fwd": pool.submit(flash_kernel.build,
                                                      "simt", True),
                   "flash_attention_bwd": pool.submit(flash_bwd.build,
                                                      True),
                   "segment_matmul": pool.submit(seg_kernel.build, True),
                   "embedding_bag": pool.submit(embag_kernel.build, True)}
        logs = {name: f.result() for name, f in futures.items()}
    return time.perf_counter() - t0, logs


def main() -> int:
    # fewer stranded blocks between the training step's large tensors
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
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

    flash_rows = flash_phase()
    for row in flash_rows:
        emit({"phase": "kernel", "name": "flash_attention_fwd", **row})
    flash_launches, lm_rows = lm_phase()
    for row in lm_rows:
        emit({"phase": "kernel", "name": "flash_attention_fwd", **row})
    check(flash_launches > 0, "the LM path launched no flash kernel")
    flash_rows = lm_rows + flash_rows

    bwd_rows = flash_bwd_phase()
    for row in bwd_rows:
        emit({"phase": "kernel", "name": "flash_attention_bwd", **row})
    train_launches = lm_train_phase()
    check(train_launches["dq"] > 0 and train_launches["dkv"] > 0,
          "the training path launched no backward kernel")
    lm_train_vs_xla_phase()
    bwd_row = bwd_rows[0]   # the training path's shape

    gnn_launches, seg_rows = gnn_phase()
    for row in seg_rows:
        emit({"phase": "kernel", "name": "segment_matmul", **row})
    check(gnn_launches["segment_matmul"] > 0,
          "the GNN path launched no segment_matmul kernel")
    seg_row = seg_rows[0]   # layer 0's own inputs, the forward's call

    rec_launches, rec_row, item_table, bags = rec_phase()
    emit({"phase": "kernel", "name": "dht_gather", **rec_row})
    check(all(n > 0 for n in rec_launches.values()),
          f"a SASRec cell launched no dht_gather kernel: {rec_launches}")
    embag_launches, embag_rows = embedding_bag_phase(item_table, bags)
    for row in embag_rows:
        emit({"phase": "kernel", "name": "embedding_bag", **row})
    check(embag_launches > 0, "the embedding_bag path launched no kernel")
    embag_row = embag_rows[0]   # the trained table, step 0's histories
    del item_table, bags

    main_row = rows[0]   # the first cc solve's root-label read
    flash_row = flash_rows[0]   # the first layer's own q, k, v
    emit({"kernels": [{
        "name": "dht_gather", "route": "cuda",
        "source": "src/repro_torch/kernels/dht_gather/csrc/dht_gather.cu",
        "replaces": "src/repro/kernels/dht_gather/kernel.py:28",
        "launches": launches + sum(rec_launches.values()),
        "launches_by_phase": {"ampc_solves": launches, **rec_launches},
        "max_abs_err": max(r["max_abs_err"] for r in rows + [rec_row]),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": "bytes",
        "library_ms": main_row["library_ms"],
        "shapes": rows + [rec_row]}, {
        "name": "flash_attention_fwd", "route": "cuda",
        "kernel_route": flash_row["kernel_route"],
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  f"flash_attention_fwd{FWD_SOURCE[flash_row['kernel_route']]}"
                  ".cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:25",
        "launches": flash_launches + train_launches["fwd"],
        "launches_by_phase": {"lm_forward": flash_launches,
                              "lm_train": train_launches["fwd"]},
        "launches_by_route": {"wgmma": flash_launches
                              + train_launches["fwd_wgmma"],
                              "simt": train_launches["fwd_simt"]},
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
        "max_err_over_limit": max(
            [r["err_over_limit"] for r in flash_rows]
            + [r["lse_err_over_limit"] for r in bwd_rows]),
        "ms": flash_row["ms"], "plain_ms": flash_row["plain_ms"],
        "earlier_ms": flash_row.get("simt_ms"),
        "earlier": "the SIMT kernel (flash_attention_fwd.cu) on the same "
                   "inputs, this run",
        "bound_ms": flash_row["bound_ms"],
        "bound_by": flash_row["bound_by"],
        "library_ms": flash_row["library_ms"],
        "shapes": flash_rows}] + [{
        "name": f"flash_attention_bwd_{kname}", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_bwd.cu",
        "replaces": f"src/repro/kernels/flash_attention/bwd.py:{line}",
        "launches": train_launches[kname],
        "max_abs_err": max(r[f"{g}_max_abs_err"] for r in bwd_rows
                           for g in grads),
        "max_err_over_limit": max(r[f"{g}_err_over_limit"]
                                  for r in bwd_rows for g in grads),
        "ms": bwd_row[f"{kname}_ms"], "plain_ms": bwd_row["plain_ms"],
        "plain_computes": "dq, dk and dv together",
        "bound_ms": bwd_row[f"{kname}_bound_ms"],
        "bound_by": bwd_row[f"{kname}_bound_by"],
        "library_ms": bwd_row["library_ms"],
        "library": f"SDPA backward ({bwd_row['library_backend']}), dq, dk "
                   f"and dv together",
        "shapes": bwd_rows}
        for kname, line, grads in (("dq", 34, ("dq",)),
                                   ("dkv", 80, ("dk", "dv")))] + [{
        "name": "segment_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/segment_matmul/csrc/"
                  "segment_matmul.cu",
        "replaces": "src/repro/kernels/segment_matmul/kernel.py:22",
        "launches": gnn_launches["segment_matmul"],
        "max_abs_err": max(r["max_abs_err"] for r in seg_rows),
        "max_err_over_limit": max(r["err_over_limit"] for r in seg_rows),
        "ms": seg_row["ms"], "plain_ms": seg_row["plain_ms"],
        "bound_ms": seg_row["bound_ms"], "bound_by": seg_row["bound_by"],
        "library_ms": seg_row["library_ms"], "library": seg_row["library"],
        "shapes": seg_rows}, {
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/kernels/embedding_bag/csrc/"
                  "embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/kernel.py:16",
        "launches": embag_launches,
        "max_abs_err": max(r["max_abs_err"] for r in embag_rows),
        "ms": embag_row["ms"], "plain_ms": embag_row["plain_ms"],
        "bound_ms": embag_row["bound_ms"], "bound_by": embag_row["bound_by"],
        "library_ms": embag_row["library_ms"],
        "library": embag_row["library"], "shapes": embag_rows}]})
    emit({"host_reads_total": rounds.HOST_READS})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
