#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit.  It:

1. prints the card's name and power limit (``nvidia-smi``) and the torch /
   CUDA versions;
2. builds the kernels of both main paths from ``src/`` (one ``nvcc`` per
   source, started together, into ``build/``) and prints the build time
   and each kernel's register report;
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
5. holds the flash-attention forward kernel against its plain version on
   the card, element by element (bf16 within 2^-7 of each output plus
   1e-3, f32 within 1e-5: the kernel sums in another order) at the LM
   path's shape and at D 256 with a window, K > S, and f32 with and
   without a window, and times kernel / plain version / SDPA;
6. drives the qwen3-4b LM forward (the registry's config at full width and
   depth, ``attention_impl="pallas"``, seeded bf16 weights on the card) on
   one batch of ``LM_SHAPES["train_4k"]`` cut to B 2 (S 4096), twice, with
   the launch counts set to 0 just before and read just after: 36 flash
   launches per forward, finite logits and loss, an untrained loss near
   ln(vocab).  The first and last layer's q, k, v go through the kernel and
   its plain version after the counts are read.  At S 1024 the whole
   forward, in f32 on the same weights with TF32 off, is held against
   ``attention_impl="xla"`` within 1e-4;
7. prints one ``{"kernels": [...]}`` line (dht_gather: the first
   connectivity solve's root-label read; flash attention: the first
   layer's own q, k, v) and as its last line ``{"ok": true, "device":
   {...}}``.

Any failed check raises, so the exit code is nonzero and the last line is
not printed.  Without a CUDA card, or outside a checkout, it exits nonzero.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
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
XLA_SEQ = 1024          # under the chunked-attention threshold
# the pallas and xla forwards in f32 with TF32 off: every matmul outside
# attention is the same call on the same inputs, so the logits differ only
# by the two attentions' f32 summation orders, carried through 36 layers
XLA_LOGITS_ATOL, XLA_NLL_ATOL = 1e-4, 1e-4


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
    ``timed``, the SDPA time when ``library`` (causal, K == S, no window:
    the same function)."""
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
    row = {"shape": name, "B": B, "S": S, "K": K, "H": H, "Hkv": Hkv,
           "D": D, "window": window, "dtype": dtype, "max_abs_err": err,
           "err_over_limit": worst,
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
            dht = dht_ops.dht_gather.launches
            main_launches += launches
            check(launches == cfg.n_layers,
                  f"forward launched the flash kernel {launches} times, "
                  f"expected {cfg.n_layers}")
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
                  "flash_launches": launches, "loss": float(loss),
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
def build_kernels():
    """Build every kernel from its source: one ``nvcc`` each, all started
    together."""
    from repro_torch.kernels.dht_gather import kernel as dht_gather_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        futures = {"dht_gather": pool.submit(dht_gather_kernel.build, True),
                   "flash_attention_fwd": pool.submit(flash_kernel.build,
                                                      True)}
        logs = {name: f.result() for name, f in futures.items()}
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

    flash_rows = flash_phase()
    for row in flash_rows:
        emit({"phase": "kernel", "name": "flash_attention_fwd", **row})
    flash_launches, lm_rows = lm_phase()
    for row in lm_rows:
        emit({"phase": "kernel", "name": "flash_attention_fwd", **row})
    check(flash_launches > 0, "the LM path launched no flash kernel")
    flash_rows = lm_rows + flash_rows

    main_row = rows[0]   # the first cc solve's root-label read
    flash_row = flash_rows[0]   # the first layer's own q, k, v
    emit({"kernels": [{
        "name": "dht_gather", "route": "cuda",
        "source": "src/repro_torch/kernels/dht_gather/csrc/dht_gather.cu",
        "replaces": "src/repro/kernels/dht_gather/kernel.py:28",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": "bytes",
        "library_ms": main_row["library_ms"],
        "shapes": rows}, {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:25",
        "launches": flash_launches,
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
        "ms": flash_row["ms"], "plain_ms": flash_row["plain_ms"],
        "bound_ms": flash_row["bound_ms"],
        "bound_by": flash_row["bound_by"],
        "library_ms": flash_row["library_ms"],
        "shapes": flash_rows}]})
    emit({"host_reads_total": rounds.HOST_READS})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
