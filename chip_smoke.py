#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit.  It:

1. prints the card's name and power limit (``nvidia-smi``) and the torch /
   CUDA versions;
2. builds the kernels of every path from ``src/`` (one ``nvcc`` per
   source, started together, into ``build/``; the flash forward and the
   flash backward have two each, the wgmma route's and the SIMT route's)
   and prints the build time and each kernel's register report (the
   backward wgmma kernels must spill nothing);
3. holds ``dht_gather`` against its plain PyTorch version on the card at
   the shapes the AMPC path gives it (and a few more), exactly (tolerance
   0), checks with ``torch.profiler`` that the wrapper launches its sort
   and one kernel that writes the rows in the caller's order (no separate
   scatter), and times kernel / plain version / ``index_select`` in the
   caller's order / sort / wrapper with CUDA events;
4. drives ``AmpcEngine(dht_backend="local").solve`` for every problem of
   the registry.  At rmat20 (Graph500 RMAT, 2^20 vertices, average degree
   8, seed 1; weights from seed 2 where a problem needs them):
   ``connectivity``, ``mis``, ``msf``, ``matching``,
   ``weighted-matching``, ``vertex-cover`` and ``msf-kkt`` twice each,
   ``matching-levels``, ``matching-vertex-process`` and the MPC baselines
   ``mis-mpc``, ``matching-mpc``, ``msf-mpc`` and ``connectivity-mpc``
   once each.  On ``two_cycles(2**23)`` and ``one_cycle(2**24)`` (n =
   2^24, the largest at which float32 ranks are exact): ``one-vs-two``
   (p = 1/64) twice and ``one-vs-two-mpc`` once.  Each solve runs with
   the kernel launch counts set to 0 just before and read just after: 2
   ``dht_gather`` launches a connectivity solve, none for any other
   problem.  Every answer is held against a host computation that uses
   none of the port's solvers (scipy's connected components and minimum
   spanning tree; the port's greedy-MIS and greedy-matching oracles on
   ranks drawn here, one pass serving every matching problem and the
   vertex cover, the weight ranks built as the reference builds them for
   ``weighted-matching``; 2 and 1 cycles), the Table-3 shuffle counts are
   checked (connectivity and msf 5; mis, matching, weighted-matching and
   one-vs-two 2), and every MPC baseline must take more shuffles than its
   AMPC problem.  Each solve prints its wall time, host reads, peak
   memory, ledger and stats (the walk's steps for one-vs-two).  The label
   maps each connectivity solve reads through the DHT go through the
   kernel and its plain version once more, after the counts are read, and
   must agree.  Then the serving layers, each phase with the counts set
   to 0 just before it and read just after:
   * ``sessions``: each snapshot problem (connectivity, mis, msf,
     matching, weighted-matching, vertex-cover at rmat20; one-vs-two on
     both cycle graphs) solved cold, then warm, in a ``GraphSession`` of
     its own: each output equal to the engine phase's, ``snapshot.hit``
     False then True, 2 shuffles then 1, 2 ``dht_gather`` launches a
     connectivity solve (cold and warm) and 0 for the others; each solve's
     wall, host reads and peak memory, and ``cache_info("snapshot")``;
   * ``solve_many``: fleets at card scale (16 ``erdos_renyi(n, 4.0)`` at
     the reference benchmark's sizes × 1024 for mis, matching,
     vertex-cover and connectivity; the same sizes at degree 2 / 10 plus
     4 dense lanes of degree 128 for weighted-matching and msf; the
     reference test's cycle fleet × 1024 for one-vs-two, p 1/64): the
     sequential ``solve`` loop, a cold and a warm ``solve_many`` on a fresh
     engine, every output equal to its sequential one, the cold call one
     cache miss a bucket (msf: a bucket and path), the warm call a hit a
     graph and no miss, one harvest a bucket, no ``dht_gather`` launch;
     the three walls, the per-graph wall and the host reads;
   * ``async``: ``AmpcEngine(max_workers=4)`` runs ``submit_many`` on 8
     fleet graphs for mis and connectivity, each result equal to
     ``solve``'s; one connectivity submit under an injected ``preempted``
     transient is retried exactly once (``retry_transients_total``) and
     still equal; a ``GraphSession.submit`` warm hit at rmat16; 2 launches
     a connectivity solve; ``engine_async_inflight`` back to 0 after
     shutdown;
   * ``routed``: the routed DHT backend.  ``ShardedDHT(mesh=make_mesh(P))``
     at 1 and 8 shards on the first connectivity solve's root-label read
     (8,629,672 keys) and on SASRec's history read (65,536 step-0
     histories of 50 into a seeded 1M x 50 f32 table), and at 8 shards
     with a quarter of the exact capacity on that solve's first-slot read:
     answered rows bit-equal to the local lookup's, the rest 0, the
     distinct keys and overflows equal to a host count from the keys (the
     starved read must overflow), each timed beside the local lookup.  Then,
     with the launch counts set to 0 just before and read just after,
     ``AmpcEngine(dht_backend=RoutedDht(make_mesh(8)))`` on mis, matching,
     weighted-matching, vertex-cover, msf and connectivity at rmat20 and
     one-vs-two on both cycle graphs (each output equal to the engine
     phase's, the same shuffles, no overflow, at least its queries), the
     default mesh (one shard a card) on connectivity (every counter equal
     to the local solve's), a routed ``solve_many`` of the plain fleet, a
     routed session's cold and warm connectivity solve and a routed
     ``submit``, each equal to its local counterpart: no ``dht_gather``
     launch, since the router answers by indexing.  Each solve's wall and
     peak memory;
   * ``eager``: ``deferred_accounting=False`` for mis (in turns with
     deferred solves) and connectivity at rmat20: outputs and every counter
     equal to the deferred solves', 2 launches a connectivity solve (an
     eager local lookup still takes the kernel first); each solve's wall,
     host reads, transfers (``rounds.TRANSFERS``) and harvests beside the
     deferred ones;
   * ``dht_group``: the DHT on a process group, one NCCL rank (made here,
     kept for the mixtral phase's ``compressed_psum`` and the ``launch``
     phase) and a 1-D ``("dht",)`` cuda ``DeviceMesh``.  The first
     connectivity solve's root-label read and SASRec's history read
     through the group router, the one-process router at one shard and
     the local lookup: bit-equal rows, equal distinct keys and
     overflows, CUDA-event ms of each, and under the profiler two
     ``all_to_all`` collectives a group lookup and no ``dht_gather``.
     ``AmpcEngine(mesh=that mesh, dht_backend="routed")`` on the routed
     phase's problems beside the one-process routed engine at one shard
     (outputs equal to the engine phase's, every counter but the walls
     and the host reads equal, no overflow), a group ``solve_many`` of the
     plain fleet, a session's cold and warm connectivity solve and 8
     ``submit``s on 2 workers, each equal to the local answer; no
     ``dht_gather`` launch; the phase's seconds.  Nothing falls back: a
     failed NCCL start or collective fails the run;
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
   without a window and on strided heads, each case on the route
   ``bwd.route`` gives it (bf16 at D 64/128: wgmma; the rest: SIMT) and
   counted there; runs each kernel twice and asks for equal bits; on the
   wgmma route counts the elements of each gradient that are not the
   correctly rounded f32 gradient and holds that count to
   ``ref.rounding_miss_limit`` of the split mirror's and a bf16-only P and
   dS mirror's (P and dS kept at f32 accuracy); times kernels / plain
   version / SDPA's backward, and for a wgmma-route input the SIMT kernels
   on the same inputs, and prints the split's tensor work beside the
   bound;
8. trains qwen3-4b at full width and depth (f32 parameters, bf16
   compute, ``remat="full"``, AdamW with f32 state) for three steps of
   ``LM_SHAPES["train_4k"]`` cut to a global batch of 2 in 2 microbatches
   (S 4096) through ``launch.steps.lm_train_step``, with the launch counts
   set to 0 just before each step and read just after: 144 forward (two
   microbatches, each layer's forward and its remat recompute; all on the
   wgmma route), 72 dq and 72 dk/dv launches (all on the wgmma route),
   finite losses near
   ln(vocab) at step 0, a finite positive grad norm, every parameter
   changed, AdamW's step count 3;
   prints step time, tokens/s, peak memory, the lr and loss of each step,
   and the last step's device time by kind of kernel (``torch.profiler``;
   that step's wall time carries the profiler's cost);
9. holds every gradient of a 4-layer qwen3-4b (full widths, B 1, S 1024,
   f32, TF32 off) through the kernels against the same gradients through
   ``attention_impl="xla"`` and against ``remat="full"``;
10. serves qwen3-4b at full width and depth with seeded bf16 weights
   (``launch.serve.serve`` and ``launch.steps.lm_decode_step``, the
   launch counts set to 0 just before each run and read just after: no
   kernel, the reference's xla branches): ``LM_SHAPES["prefill_32k"]`` cut
   to B 1 (a 32,768-token prompt, the chunked attention; 16 generated
   tokens), then ``decode_32k`` cut to B 8 (that prompt's cache copied
   into 8 rows of a zero-filled 32,768 + 16 slot cache, 36 GiB; 16 decode
   steps, row 0 fed serve's first token and held to serve's logits within
   ``SERVE_ROW_DRIFT``); in f32 with TF32 off on the same weights,
   ``decode_step`` after ``prefill`` against the forward's last logits at
   S 1024 within 1e-3 of the largest, and ``attention_xla_chunked`` with
   and without static skipping against ``attention_xla`` on layer 0's own
   q, k, v at S 4096 within 1e-5; then gemma3-12b (bf16) ``serve`` at a
   4,096-token prompt (its local layers' window of 1024 in prefill and
   decode).  Prints the prefill wall and tokens/s, decode ms a step and
   tokens/s, and peak memory of each run (long_500k is cut: gemma3's
   global layers need a 206 GB cache at B 1);
11. runs the MoE LMs, llama4-scout then mixtral, at full width cut to 8
   layers (215.5 and 281.3 GB of bf16 weights at full depth; 39.4 and
   40.9 GB cut), seeded bf16 weights on the card, one model at a time:
   two forwards on ``LM_SHAPES["train_4k"]`` cut to B 2 (S 4096), the
   launch counts set to 0 just before each and read just after: 8 flash
   launches a forward, all on the wgmma route (40 and 48 query heads over
   8 kv heads: groups of 5 and 6), finite logits, a loss near ln(vocab),
   every layer's load-balancing loss in (0, E] and summing to the
   forward's aux, each layer's dropped share of its T·K slots printed.
   Layer 0's MoE on its own input (T 8,192) in f32 with TF32 off is held
   against a float64 host computation written with numpy alone (softmax
   routes with ties to the lower expert, the stable capacity order, the
   drops, SwiGLU per expert on 64 seeded tokens, llama4's shared expert):
   routes equal but at near ties (host margin under 1e-5), drops equal,
   outputs within 1e-3 of the largest.  ``launch.serve.serve`` on
   prefill_32k cut to B 1 (a 32,768-token prompt, the reference's chunked
   xla prefill; 16 tokens), then decode_32k cut to B 8 (that prompt's
   cache in 8 rows, 16 steps): no kernel launch; row 0 within
   ``SERVE_ROW_DRIFT`` of serve's B 1 logits unless one of its routes
   differs at a bf16 near tie, its routes printed beside B 1's.  Then the
   flash forward on layers 0 and 7's own q, k, v and the backward kernels
   on layer 0's (B 1), against their plain versions and timed.  Then
   mixtral at full width and 1 layer trains for three ``lm_train_step``s
   (f32 parameters, remat "full", B 2 in 2 microbatches at S 4096): 4
   forward, 2 dq and 2 dk/dv launches a step, all wgmma, finite losses
   near ln(vocab) at step 0, every parameter changed, AdamW's count 3,
   the last step profiled by kind (the dispatch's sorts and index kernels
   apart); ``compress_tree`` on that step's gradients on the card equals
   the same call on their CPU copies bit for bit, and decompress plus
   feedback gives the corrected gradient within 1e-6; ``compressed_psum``
   of those gradients over the one NCCL rank (a ``dht_group`` line) gives
   ``decompress`` of ``compress`` and its feedback bit for bit, timed.
   Last,
   ``TrainRunner`` on llama4's smoke config on the card stops at a
   simulated preemption before step 4 of 8 and resumes from its
   checkpoint (under ``build/``, removed after): its parameters equal an
   uninterrupted run's within 1e-6 of each leaf's largest (bit-equality
   printed);
12. trains gin-tu at full width (5 layers, d_hidden 64, f32, d_feat 602,
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
   equal bit for bit, twice equal bit for bit, and timed beside the
   plain version and ``embedding_bag`` + ``matmul``.  Prints the host sampling,
   feature gather and step times, seeds/s, peak memory, and the last
   step's device time by kind of kernel (``torch.profiler``);
13. trains the other GNN cells of the registry (arch x ``GNN_SHAPES``) at
   full width, f32, TF32 off: gcn-cora on molecule (``molecules(128,
   30)``, 64 features), full_graph_sm (``cora_like()``), minibatch_lg (the
   gin phase's 1024-seed blocks) and ogb_products (``products_like`` at
   ogbn-products' counts: 2^22 vertices, 118,565,366 directed edges);
   gin-tu on molecule, full_graph_sm and ogb_products; schnet and mace on
   molecule, full_graph_sm and minibatch_lg (seeded positions in a 3-unit
   cube and species where the builder has none; seeded labels as
   ``specs._gnn_batch_struct`` shapes them).  Each: one
   ``gnn_forward_step`` and 3 ``gnn_train_step``s, the launch counts set
   to 0 just before each and read just after (5 ``segment_matmul``
   launches for GIN, none for the others), finite outputs, losses and
   parameters, every parameter changed, the step walls and peak memory;
   the small cells held against the port's CPU model (forward, loss, every
   gradient within 1e-4 of the largest element) and MACE's molecule
   energies against a seeded rotation plus translation (2e-4).  Where the
   f32 sum of the gradient's squares overflows (gin-tu on ogb_products)
   the grad norm is inf, as in the reference, and the step only decays.
   schnet and mace on ogb_products are cut (their edge tensors need 148
   and 570 GB);
14. drives SASRec at full size (the registry's ``sasrec``: 1,000,000
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
   ``dht_gather`` against its plain version, bit for bit, on the training
   batch's histories (3,276,800 keys into the trained table; its wrapper
   one kernel beyond the sort) and on one ``serve_bulk`` call's candidates
   (33,554,432 keys, 6.7 GB of rows), each timed alone;
15. calls ``embedding_bag`` (the op's own entry point; no model of either
   package reaches it) on the trained item table with step 0's 65,536
   histories as bags, the counts set to 0 just before and read just after:
   one launch.  The kernel is held against its plain version bit for bit
   (and twice equal) there, in bf16, on uniform ids over the table of the
   same shape (f32, bf16), at ``tests/test_kernels.py``'s shapes in f32 and
   bf16 and at edge cases (D 37, L 0 and 1, a ragged B, ids below 0 and
   past the table, L 300, D 4, 8 and 1: each chunk width and packed warp),
   and timed, at the histories and the uniform ids, beside the plain
   version and ``F.embedding_bag(mode="sum", padding_idx=0)``; each
   case's ``kernel`` line (not the kernels line, whose numbers are
   measured) prints the kernel's layout and, beside the bound, the
   32-byte sectors of the distinct rows plus ids and output
   (``sector_bytes``) and the same counted bag by bag
   (``bag_sector_bytes``: what HBM serves when no row stays in L2 from
   one bag to the next);
16. the ``launch`` phase: (a) ``python -m repro_torch.launch.dryrun --all``
   on the host (8 worker processes, no card) while the card works: every
   cell of the registry built and run once on ``meta``, one line a cell,
   37 ok and the registry's 3 skipped with its reasons, each LM's
   parameters ``param_count()`` plus the qk-norm scales and QKV biases,
   llama4's and mixtral's bf16 weights at full depth 215.5 and 281.3 GB;
   qwen3-4b cut to 4 layers at B 2: the dry-run's parameter and AdamW
   bytes equal to ``memory_allocated`` after the real build, its peak
   beside the real step's; (b) one NCCL rank, a (1, 1) ("data", "model")
   mesh: qwen3-4b at full width, 4 layers, f32 parameters, B 2, S 4096,
   remat "full": the loss and one ``lm_train_step`` with a ``ShardCtx``
   bit-equal to the plain port's (metrics, parameters, moments), the
   flash launches (counted from 0 around the step) equal to the plain
   step's and all wgmma; one mixtral layer at full width with
   ``moe_local_dispatch`` under the context bit-equal to ``moe_apply``,
   and ``moe_apply_local`` at 2 and 4 shards on that layer's input
   against a float64 host computation of the per-shard dispatch;
   (c) the plain state checkpointed and restored with ``shardings=``
   onto the mesh, bit-equal, and ``TrainRunner(shardings=)`` over the
   sharded step preempted and resumed, bit-equal to an uninterrupted run;
   (d) the four ``examples/torch_*.py`` on the card; (e) SDPA's backward
   at G 5 and 6 (40/8 and 48/8 heads, (1, 4096, H, 128) bf16, causal);
17. prints one ``{"kernels": [...]}`` line (dht_gather: the first
   connectivity solve's root-label read, with its launches by phase
   (the engine's solves, the serving phases, the routed phase's 0, the
   eager phase's 2, the SASRec cells); the
   flash forward: the first layer's own q, k, v, its kernel route and the
   SIMT kernel's time there, with its launches by phase (the qwen3-4b
   forward and step, the MoE forwards and mixtral's steps, the sharded
   step); dq and dk/dv:
   the training path's shape, their route and the SIMT kernels' time
   there, with their launches by phase;
   segment_matmul: GIN layer 0's own inputs in the
   forward, with its launches by phase (the gin phase's and the
   ``gnn_models`` GIN cells'); embedding_bag: the trained item table and step 0's histories)
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
# the engine phase's solves at rmat20: (problem, weighted, reps)
RMAT_SOLVES = (("connectivity", False, 2), ("mis", False, 2),
               ("msf", True, 2), ("matching", False, 2),
               ("weighted-matching", True, 2), ("vertex-cover", False, 2),
               ("msf-kkt", True, 2), ("matching-levels", False, 1),
               ("matching-vertex-process", False, 1), ("mis-mpc", False, 1),
               ("matching-mpc", False, 1), ("msf-mpc", True, 1),
               ("connectivity-mpc", False, 1))
# cycles of 2^24 vertices in all: the largest n at which every rank
# rng.permutation(n).astype(np.float32) is exact (above 2^24 ranks tie and
# CC-LocalContraction never contracts a 2-cycle of tied ranks)
CYCLE_LOG2 = 24
CYCLE_SOLVES = (("one-vs-two", 2), ("one-vs-two-mpc", 1))
EXPECTED_SHUFFLES = {"connectivity": 5, "mis": 2, "msf": 5, "matching": 2,
                     "weighted-matching": 2, "one-vs-two": 2}
CC_LAUNCHES_PER_SOLVE = 2
# the sessions phase: each snapshot problem but one-vs-two at rmat20 (on
# the weighted graph: the others ignore weights), one-vs-two on the cycles
SESSION_RMAT = ("connectivity", "mis", "msf", "matching",
                "weighted-matching", "vertex-cover")
# the solve_many phase: the reference benchmark's fleet sizes
# (benchmarks/solve_many.py:29-30) and the reference test's cycle sizes
# (tests/test_solve_many.py::_cycle_fleet), times 1024; 4 dense lanes of
# average degree 128 so msf's dense sub-launch runs
FLEET_SIZES = (50, 60, 100, 120, 70, 50, 90, 110, 55, 65, 95, 115, 75, 85,
               105, 125)
FLEET_CYCLE_KS = (30, 40, 60, 30, 45, 50, 35, 55, 40, 30, 60, 45, 50, 35, 55,
                  30)
FLEET_SCALE = 1024
FLEET_DENSE_LANES = (4096, 4608, 5120, 5632)
MANY_SOLVES = (("mis", "plain", {}), ("matching", "plain", {}),
               ("vertex-cover", "plain", {}), ("connectivity", "plain", {}),
               ("weighted-matching", "weighted", {}),
               ("msf", "weighted", {}), ("one-vs-two", "cycles", {}))
ASYNC_GRAPHS = 8
# the routed phase: the Table-3 problems at rmat20 (one-vs-two on the
# cycles) over 8 shards, the reference test's virtual device count
ROUTED_SHARDS = 8
ROUTED_RMAT = ("mis", "matching", "weighted-matching", "vertex-cover", "msf",
               "connectivity")
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
FLASH_CSRC = "src/repro_torch/kernels/flash_attention/csrc"
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
# gnn_models: every GNN cell of the registry (arch x GNN_SHAPES) but gin-tu x
# minibatch_lg (the gnn phase's), at full width; the two no card can hold
# are cut
GNN_MODEL_CELLS = (("gcn-cora", "molecule"), ("gin-tu", "molecule"),
                   ("schnet", "molecule"), ("mace", "molecule"),
                   ("gcn-cora", "full_graph_sm"), ("gin-tu", "full_graph_sm"),
                   ("schnet", "full_graph_sm"), ("mace", "full_graph_sm"),
                   ("gcn-cora", "minibatch_lg"), ("schnet", "minibatch_lg"),
                   ("mace", "minibatch_lg"), ("gcn-cora", "ogb_products"),
                   ("gin-tu", "ogb_products"))
GNN_MODEL_CUTS = {
    ("schnet", "ogb_products"): "123.7M directed edges: the (E, 300) f32 RBF "
    "alone is 148 GB",
    ("mace", "ogb_products"): "123.7M directed edges: each (E, 128, 3, 3) "
    "f32 edge tensor is 570 GB"}
# ogbn-products' counts; products_like rounds the vertices up to 2^22
GNN_PRODUCTS = dict(n_nodes=2_449_029, avg_deg=29.5, d_feat=100,
                    n_classes=47)
GNN_MOLECULE_FEAT = 64          # specs._gnn_lowerable's molecule width
GNN_POSITION_BOX = 3.0          # positions uniform in a cube of this side
GNN_MODEL_SEED = 3              # labels, positions, species, rotations
# the small cells (molecule, full_graph_sm) on the card against the port's
# own CPU model, f32 with TF32 off: index_add_ adds in atomic order on the
# card, so forward, loss and gradients agree to |a - b| <= GNN_RTOL max |b|;
# MACE's energies under a rotation plus translation within the reference
# test's 2e-4 (1 + |e|)
MACE_INVARIANCE_TOL = 2e-4
# lm_serve: qwen3-4b's prefill_32k cut to B 1 (32 x 4.5 GiB of cache would
# not fit) and decode_32k cut to B 8 (36 GiB of cache), 16 tokens each;
# gemma3-12b at a 4,096-token prompt
SERVE_PROMPT, SERVE_GEN, SERVE_DECODE_BATCH = 32768, 16, 8
SERVE_TOKEN_SEED = 1
SERVE_GEMMA, SERVE_GEMMA_PROMPT = "gemma3-12b", 4096
# decode_32k's row 0 decodes serve's first token on the same prompt: bf16
# at B 8 against B 1, within this share of the largest logit
SERVE_ROW_DRIFT = 0.1
# f32, TF32 off: decode_step after prefill against the forward's last
# logits at S 1024 (|a - b| <= 1e-3 max |logit|: one attention's summation
# order carried through 36 layers), and the chunked attention against
# attention_xla at S 4096 on layer 0's q, k, v (1e-5 of the largest output)
SERVE_DECODE_RTOL, SERVE_CHUNK_SEQ, SERVE_CHUNK_RTOL = 1e-3, 4096, 1e-5
# moe_lm: llama4-scout and mixtral at full width, cut to MOE_LAYERS layers
# (at full depth 215.5 and 281.3 GB of bf16 weights), one after the other;
# train_4k cut to B 2, prefill_32k to B 1, decode_32k to B 8 (16 tokens)
MOE_ARCHS = ("llama4-scout-17b-a16e", "mixtral-8x22b")
MOE_LAYERS, MOE_BATCH = 8, 2
# layer 0's MoE in f32 (TF32 off) on the card against a float64 host
# computation on its own input: a route may differ only where the host's
# probabilities of the two experts lie within MOE_ROUTE_MARGIN; the
# experts' outputs on MOE_HOST_SAMPLE seeded tokens within MOE_OUT_RTOL of
# the largest element (f32 products over d 5120-6144 and f 8192-16384)
MOE_ROUTE_MARGIN, MOE_HOST_SAMPLE, MOE_OUT_RTOL, MOE_SAMPLE_SEED = \
    1e-5, 64, 1e-3, 4
# decode_32k's row 0 against serve's B 1 step: a route of row 0 that
# differs between the two batches must be a bf16 near tie (the B 1 run's
# probabilities of the two experts within this much); only then may the
# row move past SERVE_ROW_DRIFT
MOE_NEAR_TIE = 2e-2
# mixtral training at 1 layer: 2.91B f32 parameters with gradients and
# AdamW's m and v are 46.5 GB (2 layers: 86 GB; llama4's 202,048-row
# embedding and head take even its 1 layer to 68 GB)
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS = "mixtral-8x22b", 1
# compress_tree's feedback identity: decompress(q, s) + feedback equals
# the corrected gradient within this (absolute; two f32 roundings)
MOE_COMPRESS_ATOL = 1e-6
# TrainRunner on llama4's smoke config: a crash before step 4 of 8, a
# resume, and an uninterrupted run, each leaf within 1e-6 of its largest
MOE_RUNNER_ARCH, MOE_RUNNER_STEPS, MOE_RUNNER_CRASH, MOE_RUNNER_RTOL = \
    "llama4-scout-17b-a16e", 8, 4, 1e-6
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
                     (20000, 50, 1001, 50), (500, 130, 3, 300),
                     (100, 4, 301, 9), (90, 8, 1000, 13), (60, 1, 333, 27))
EMBAG_UNIFORM_SEED = 1
# what an embedding_bag row counts from its inputs rather than measures:
# printed in its "kernel" phase line, kept out of the kernels line
EMBAG_COUNTED = ("layout", "sector_bytes", "bag_sector_bytes")
EMBAG_DESIGN = ("rows in 16/8/4/2-byte chunks, narrow rows packed into a "
                "warp (kernel.layout); each window's valid ids ranked by "
                "ballot into shared memory, up to 24 row loads in flight a "
                "lane; persistent grid, the next window's ids loaded while "
                "the rows fly")


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
    from repro_torch.kernels.dht_gather.ref import dht_gather_fused_ref
    sk, order = torch.sort(keys, stable=True)
    return dht_gather_fused_ref(table, sk, order)


# what ops.dht_gather may launch besides its kernel: torch.sort's radix
# sort (its kernels, index fill, memsets and copies) and the fill of the
# hit counter
SORT_AND_FILL = ("Sort", "sort", "fill_reverse_indices", "Memset", "Memcpy",
                 "FillFunctor")


def one_pass(table, keys):
    """Checks with ``torch.profiler`` that one ``ops.dht_gather`` call
    launches one ``dht_gather`` kernel and, besides it, only its sort and
    the fill of its hit counter: no separate scatter of the rows.  Returns
    the kernels (name: count)."""
    import collections
    import torch
    from repro_torch.kernels.dht_gather import ops

    # a profile taken after another session may miss device events, so a
    # profile without the kernel is taken again
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            ops.dht_gather(table, keys)
            torch.cuda.synchronize()
        seen = collections.Counter(
            e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
        if any("dht_gather_kernel" in k for k in seen):
            break
    gathers = [n for k, n in seen.items() if "dht_gather_kernel" in k]
    others = [k for k in seen if "dht_gather_kernel" not in k
              and not any(a in k for a in SORT_AND_FILL)]
    check(gathers == [1] and not others,
          f"dht_gather's wrapper launched {dict(seen)}")
    return dict(seen)


def dht_gather_case(name, table, keys, timed):
    """Kernel vs plain version on one input; timings when ``timed``."""
    import torch
    from repro_torch.kernels.dht_gather import kernel, ops
    from repro_torch.kernels.dht_gather.ref import dht_gather_fused_ref

    out, hits = ops.dht_gather(table, keys)
    ref_out, ref_hits = plain_dht_gather(table, keys)
    torch.cuda.synchronize()
    check(torch.equal(out, ref_out), f"dht_gather rows differ at {name}")
    check(int(hits) == int(ref_hits),
          f"dht_gather hits {int(hits)} != {int(ref_hits)} at {name}")
    err = 0.0
    if out.numel():
        err = float((out.double() - ref_out.double()).abs().max())
    del ref_out
    Q, (V, D) = keys.shape[0], table.shape
    sk, order = torch.sort(keys, stable=True)
    n_valid = int((sk >= 0).sum())
    n_distinct = n_valid - int(ref_hits)
    es = table.element_size()
    # least bytes: keys and their order read once, each distinct row read
    # once, rows and the hit count written once
    nbytes = 4 * Q + 8 * Q + n_distinct * D * es + Q * D * es + 4
    row = {"shape": name, "V": int(V), "D": int(D),
           "dtype": str(table.dtype).replace("torch.", ""), "Q": int(Q),
           "hits": int(ref_hits), "max_abs_err": err,
           "chunk_bytes": kernel.chunk_bytes(D * es, table.data_ptr(),
                                             out.data_ptr()),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    if timed:
        # the bare launch into buffers made once: hits accumulates over
        # the calls, which the timing does not read
        hits_buf = torch.zeros(1, dtype=torch.int32, device=keys.device)
        row["ms"] = time_ms(lambda: kernel.launch(table, sk, order, out,
                                                  hits_buf))
        row["plain_ms"] = time_ms(lambda: dht_gather_fused_ref(table, sk,
                                                               order))
        # the same rows in the caller's order by one library call, its
        # index made once
        idx = keys.clamp(0, V - 1).long()
        row["library_ms"] = time_ms(lambda: table.index_select(0, idx))
        del idx
        row["library"] = "table.index_select(0, keys.clamp(0, V - 1))"
        row["sort_ms"] = time_ms(lambda: torch.sort(keys, stable=True))
        del sk, order
        row["wrapper_ms"] = time_ms(lambda: ops.dht_gather(table, keys))
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
    rows[0]["wrapper_kernels"] = one_pass(cases[0][1], cases[0][2])
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
    """Host answers computed without the port's solvers, by problem."""
    import numpy as np
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components, \
        minimum_spanning_tree
    from repro_torch.core import oracle

    n, m = g.n, g.m
    u, v = g.edges[:, 0], g.edges[:, 1]
    adj = coo_matrix((np.ones(m), (u, v)), shape=(n, n)).tocsr()
    _, cc = connected_components(adj, directed=False)
    cc = canonical(cc.astype(np.int64))
    mis = oracle.greedy_mis(g, np.random.default_rng(0).permutation(n))
    wadj = coo_matrix((gw.weights.astype(np.float64), (u, v)),
                      shape=(n, n)).tocsr()
    msf = np.sort(minimum_spanning_tree(wadj).data)
    # every matching problem and the vertex cover draw the engine seed's
    # edge permutation; weighted matching ranks by decreasing weight, ties
    # by that permutation over m
    mm = oracle.greedy_mm(g, np.random.default_rng(0).permutation(m))
    cover = np.zeros(n, bool)
    cover[u[mm]] = cover[v[mm]] = True
    tie = np.random.default_rng(0).permutation(m).astype(np.float64) / m
    wrank = np.argsort(np.lexsort((tie, -gw.weights.astype(np.float64))))
    mwm = oracle.greedy_mm(gw, wrank)
    return {"connectivity": cc, "connectivity-mpc": cc,
            "mis": mis, "mis-mpc": mis,
            "msf": msf, "msf-kkt": msf, "msf-mpc": msf,
            "matching": mm, "matching-levels": mm,
            "matching-vertex-process": mm, "matching-mpc": mm,
            "weighted-matching": mwm, "vertex-cover": cover}


def jsonable(stats):
    """A solve's stats for a JSON line: arrays (the matching problems'
    ranks) as their shape and type."""
    import numpy as np
    if isinstance(stats, np.ndarray):
        return {"array": list(stats.shape), "dtype": str(stats.dtype)}
    if isinstance(stats, dict):
        return {str(k): jsonable(x) for k, x in stats.items()}
    if isinstance(stats, (list, tuple)):
        return [jsonable(x) for x in stats]
    if isinstance(stats, np.generic):
        return stats.item()
    return stats


def engine_phase(g, gw, cycles):
    """Solve every problem on the card with the launch counts set to 0
    first; check each answer, the Table-3 counts and that each MPC
    baseline takes more shuffles than its AMPC problem.  Returns the main
    path's kernel launches, the kernel's rows on the connectivity solves'
    own label maps, each (graph, problem)'s first output, each solve's
    ledger, wall, host reads and transfers by (graph, problem), and the
    first connectivity solve's two reads (values and keys of its
    root-label read, then of its first-slot read)."""
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
    main_launches, solve_rows, shuffles, outputs = 0, [], {}, {}
    solves, cc_reads = {}, []
    ops.dht_gather.launches = 0

    def solve(graph_name, graph, problem, rep, **opts):
        nonlocal main_launches
        launches0, reads0 = ops.dht_gather.launches, rounds.HOST_READS
        transfers0 = rounds.TRANSFERS
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.solve(graph, problem, **opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.dht_gather.launches - launches0
        main_launches += launches
        shuffles[(graph_name, problem)] = res.shuffles
        if problem in EXPECTED_SHUFFLES:
            check(res.shuffles == EXPECTED_SHUFFLES[problem],
                  f"{problem}: {res.shuffles} shuffles, expected "
                  f"{EXPECTED_SHUFFLES[problem]}")
        expect = CC_LAUNCHES_PER_SOLVE if problem == "connectivity" else 0
        check(launches == expect,
              f"{problem}: dht_gather launched {launches} times, "
              f"expected {expect}")
        solves.setdefault((graph_name, problem), []).append({
            "ledger": res.ledger, "wall_s": wall,
            "host_reads": rounds.HOST_READS - reads0,
            "transfers": rounds.TRANSFERS - transfers0})
        emit({"phase": "engine", "graph": graph_name, "problem": problem,
              "rep": rep, "wall_s": wall,
              "host_reads": rounds.HOST_READS - reads0,
              "transfers": rounds.TRANSFERS - transfers0,
              "dht_gather_launches": launches,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
              "ledger": res.ledger, "stats": jsonable(res.stats)})
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
        if problem == "connectivity" and not cc_reads:
            cc_reads.extend(reads)
        reads.clear()
        outputs.setdefault((graph_name, problem), res.output)
        return res.output

    for problem, weighted, reps in RMAT_SOLVES:
        graph = gw if weighted else g
        for rep in range(reps):
            out = solve("rmat20", graph, problem, rep)
            if problem.startswith("msf"):
                check(np.array_equal(np.sort(gw.weights[out]
                                             .astype(np.float64)),
                                     want[problem]),
                      f"{problem} weights differ from scipy's spanning "
                      "forest")
            else:
                check(np.array_equal(out, want[problem]),
                      f"{problem} differs from its host answer")
    del want

    for graph_name, graph, answer in cycles:
        for problem, reps in CYCLE_SOLVES:
            for rep in range(reps):
                out = solve(graph_name, graph, problem, rep)
                check(out == answer,
                      f"{problem} counts {out} cycles on {graph_name}, "
                      f"not {answer}")

    # every MPC baseline takes more shuffles than its AMPC problem
    more = {}
    for (graph_name, problem), n_shuffles in shuffles.items():
        base = eng.baseline_for(problem)
        if base is None or (graph_name, base) not in shuffles:
            continue
        pair = (n_shuffles, shuffles[(graph_name, base)])
        more[f"{graph_name}:{problem}"] = {"ampc": pair[0], "mpc": pair[1]}
        check(pair[1] > pair[0],
              f"{base} took {pair[1]} shuffles, {problem} {pair[0]}")
    check(len(more) == 6, f"AMPC/MPC shuffle pairs: {sorted(more)}")
    emit({"phase": "engine_shuffles", "pairs": more})
    eng.dht.lookup = local_lookup
    return main_launches, solve_rows, outputs, solves, cc_reads


# --------------------------------------------------------------------------
# phase: snapshot sessions at rmat20 and on the cycles
# --------------------------------------------------------------------------
def timed_call(fn):
    """``fn()`` on the card: (result, wall s, host reads, dht_gather
    launches, peak GiB), the wall ending in a synchronize."""
    import torch
    from repro_torch.core import rounds
    from repro_torch.kernels.dht_gather import ops
    launches0, reads0 = ops.dht_gather.launches, rounds.HOST_READS
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, rounds.HOST_READS - reads0,
            ops.dht_gather.launches - launches0,
            torch.cuda.max_memory_allocated() / 2**30)


def sessions_phase(gw, cycles, outputs):
    """Each snapshot problem solved cold, then warm, in a session of its
    own, on the engine phase's graphs: outputs equal to the engine
    phase's, ``snapshot.hit`` False then True, shuffles 2 then 1, and 2
    ``dht_gather`` launches a connectivity solve (its two label-map reads),
    0 for the others.  Returns the phase's launches."""
    import numpy as np
    from repro_torch.ampc import AmpcEngine
    from repro_torch.kernels.dht_gather import ops

    eng = AmpcEngine(dht_backend="local", seed=0)
    runs = [("rmat20", gw, p) for p in SESSION_RMAT] + [
        (name, graph, "one-vs-two") for name, graph, _ in cycles]
    ops.dht_gather.launches = 0
    for graph_name, graph, problem in runs:
        sess = eng.session(graph)
        want = outputs[(graph_name, problem)]
        for call, hit, n_shuffles in (("cold", False, 2), ("warm", True, 1)):
            res, wall, reads, launches, peak = timed_call(
                lambda: sess.solve(problem))
            emit({"phase": "sessions", "graph": graph_name,
                  "problem": problem, "call": call, "wall_s": wall,
                  "host_reads": reads, "dht_gather_launches": launches,
                  "peak_mem_gib": peak, "ledger": res.ledger,
                  "stats": jsonable(res.stats)})
            check(np.array_equal(res.output, want),
                  f"session {problem} ({call}) on {graph_name} differs "
                  "from the engine phase's output")
            check(res.stats["snapshot"]["hit"] is hit,
                  f"session {problem} ({call}): snapshot hit "
                  f"{res.stats['snapshot']['hit']}")
            check(res.shuffles == n_shuffles,
                  f"session {problem} ({call}): {res.shuffles} shuffles, "
                  f"expected {n_shuffles}")
            expect = CC_LAUNCHES_PER_SOLVE if problem == "connectivity" \
                else 0
            check(launches == expect,
                  f"session {problem} ({call}): dht_gather launched "
                  f"{launches} times, expected {expect}")
        sess.invalidate()
    launches = ops.dht_gather.launches
    info = eng.cache_info("snapshot")
    emit({"phase": "sessions_cache", "hits": info.hits,
          "misses": info.misses, "size": info.size})
    check((info.hits, info.misses, info.size) == (len(runs), len(runs), 0),
          f"snapshot cache {info}")
    return launches


# --------------------------------------------------------------------------
# phase: solve_many on fleets at card scale
# --------------------------------------------------------------------------
def serving_fleets():
    """The solve_many fleets: plain, weighted (with its dense lanes) and
    cycles, as ``benchmarks/solve_many.py`` and ``tests/test_solve_many.py``
    size them, times ``FLEET_SCALE``."""
    from repro_torch.graph import generators as gen
    plain = [gen.erdos_renyi(n * FLEET_SCALE, 4.0, seed=i)
             for i, n in enumerate(FLEET_SIZES)]
    weighted = [gen.erdos_renyi(n * FLEET_SCALE, 2.0 if i % 2 == 0 else 10.0,
                                seed=i).with_random_weights(seed=i)
                for i, n in enumerate(FLEET_SIZES)]
    weighted += [gen.erdos_renyi(n, 128.0, seed=100 + i).with_random_weights(
        seed=100 + i) for i, n in enumerate(FLEET_DENSE_LANES)]
    cycles = [gen.two_cycles(k * FLEET_SCALE) if i % 2 == 0
              else gen.one_cycle(2 * k * FLEET_SCALE)
              for i, k in enumerate(FLEET_CYCLE_KS)]
    return {"plain": plain, "weighted": weighted, "cycles": cycles}


def solve_many_phase(fleets):
    """For each batched problem: the sequential ``solve`` loop, then a cold
    and a warm ``solve_many`` on a fresh engine.  Every output equals its
    sequential one; the cold call misses once a bucket (msf: once a bucket
    and path) and hits for the rest, the warm call adds a hit a graph and
    no miss; one harvest a bucket; no ``dht_gather`` launch in either
    call.  Returns the phase's launches (the sequential connectivity
    solves')."""
    import numpy as np
    from repro_torch.ampc import AmpcEngine
    from repro_torch.core import rounds
    from repro_torch.graph import batching
    from repro_torch.kernels.dht_gather import ops

    ops.dht_gather.launches = 0
    for problem, fleet_name, opts in MANY_SOLVES:
        fleet = fleets[fleet_name]
        buckets = batching.bucketize(fleet)
        eps = 0.5
        sub_launches = len(buckets) if problem != "msf" else sum(
            len({g.m >= g.n ** (1.0 + eps / 2.0) for g in b.graphs})
            for b in buckets.values())
        eng = AmpcEngine(dht_backend="local", seed=0, epsilon=eps)
        seq, seq_wall, seq_reads, _, _ = timed_call(
            lambda: [eng.solve(g, problem, **opts).output for g in fleet])
        row = {"phase": "solve_many", "problem": problem,
               "fleet": fleet_name, "graphs": len(fleet),
               "buckets": len(buckets), "sequential_s": seq_wall,
               "sequential_host_reads": seq_reads}
        for call in ("cold", "warm"):
            before = eng.cache_info()
            harvests = []
            rounds.HARVEST_HOOK = harvests.append
            try:
                res, wall, reads, launches, peak = timed_call(
                    lambda: eng.solve_many(fleet, problem, **opts))
            finally:
                rounds.HARVEST_HOOK = None
            after = eng.cache_info()
            row.update({f"{call}_s": wall, f"{call}_host_reads": reads,
                        f"{call}_peak_mem_gib": peak,
                        f"{call}_cache": [after.hits, after.misses]})
            for i, (r, want) in enumerate(zip(res, seq)):
                check(np.array_equal(r.output, want),
                      f"solve_many {problem} ({call}) graph {i} differs "
                      "from its sequential solve")
            check(len(harvests) == len(buckets),
                  f"solve_many {problem} ({call}): {len(harvests)} "
                  f"harvests for {len(buckets)} buckets")
            check(launches == 0,
                  f"solve_many {problem} ({call}): dht_gather launched "
                  f"{launches} times")
            hits, misses = (after.hits - before.hits,
                            after.misses - before.misses)
            want_hm = ((len(fleet) - sub_launches, sub_launches)
                       if call == "cold" else (len(fleet), 0))
            check((hits, misses) == want_hm,
                  f"solve_many {problem} ({call}): {hits} hits and "
                  f"{misses} misses, expected {want_hm}")
        row["per_graph_warm_s"] = row["warm_s"] / len(fleet)
        row["per_graph_sequential_s"] = seq_wall / len(fleet)
        emit(row)
    return ops.dht_gather.launches


# --------------------------------------------------------------------------
# phase: async submits, a retried transient, a session submit
# --------------------------------------------------------------------------
def async_phase(fleet, g16):
    """``submit_many`` on 8 fleet graphs for mis and connectivity on an
    engine of 4 workers, each result equal to ``solve``'s; one submit
    under an injected ``preempted`` transient, retried exactly once; a
    ``GraphSession.submit`` warm hit at rmat16; ``engine_async_inflight``
    back to 0 after shutdown.  Returns the phase's launches: 2 a
    connectivity solve, whatever thread ran it."""
    import numpy as np
    from repro_torch.ampc import AmpcEngine
    from repro_torch.kernels.dht_gather import ops
    from repro_torch.obs.metrics import MetricsRegistry, default_registry
    from repro_torch.runtime.retry import inject_transients

    graphs = fleet[:ASYNC_GRAPHS]
    reg = MetricsRegistry()
    retried = default_registry().counter("retry_transients_total",
                                         labelnames=("marker",))
    retried0 = retried.value(marker="preempted")
    cc_solves = 0
    ops.dht_gather.launches = 0
    with AmpcEngine(dht_backend="local", seed=0, max_workers=4,
                    metrics=reg) as eng:
        for problem in ("mis", "connectivity"):
            want, seq_wall, _, _, _ = timed_call(
                lambda: [eng.solve(g, problem).output for g in graphs])
            res, wall, reads, launches, peak = timed_call(
                lambda: [f.result(timeout=600)
                         for f in eng.submit_many(graphs, problem)])
            cc_solves += 2 * len(graphs) * (problem == "connectivity")
            for i, (r, w) in enumerate(zip(res, want)):
                check(np.array_equal(r.output, w),
                      f"async {problem} graph {i} differs from solve")
            emit({"phase": "async", "problem": problem,
                  "graphs": len(graphs), "sequential_s": seq_wall,
                  "submit_many_s": wall, "host_reads": reads,
                  "dht_gather_launches": launches, "peak_mem_gib": peak,
                  "queue_wait_s": [r.stats["async"]["queue_wait_s"]
                                   for r in res]})
        with inject_transients(marker="preempted", times=1):
            res, wall, _, launches, _ = timed_call(
                lambda: eng.submit(graphs[0], "connectivity").result(
                    timeout=600))
        cc_solves += 1
        n_retried = retried.value(marker="preempted") - retried0
        check(n_retried == 1,
              f"the injected transient was retried {n_retried} times")
        check(np.array_equal(res.output, eng.solve(graphs[0],
                                                   "connectivity").output),
              "the retried connectivity solve differs from solve")
        cc_solves += 1
        sess = eng.session(g16)
        cold = sess.solve("connectivity")
        warm, wall_warm, _, launches_warm, _ = timed_call(
            lambda: sess.submit("connectivity").result(timeout=600))
        cc_solves += 2
        check(warm.stats["snapshot"]["hit"] is True and warm.shuffles == 1,
              f"session submit: snapshot {warm.stats['snapshot']}, "
              f"{warm.shuffles} shuffles")
        check(np.array_equal(warm.output, cold.output),
              "session submit differs from the cold session solve")
        check(launches_warm == CC_LAUNCHES_PER_SOLVE,
              f"session submit launched dht_gather {launches_warm} times")
        emit({"phase": "async_retry_and_session", "retried": n_retried,
              "retried_wall_s": wall, "retried_launches": launches,
              "session_submit_wall_s": wall_warm,
              "session_submit_launches": launches_warm})
    inflight = reg.gauge("engine_async_inflight").value()
    check(inflight == 0, f"engine_async_inflight {inflight} after shutdown")
    launches = ops.dht_gather.launches
    check(launches == CC_LAUNCHES_PER_SOLVE * cc_solves,
          f"async phase: {launches} dht_gather launches for {cc_solves} "
          "connectivity solves")
    return launches


# --------------------------------------------------------------------------
# phase: the routed DHT backend (the all-to-all router over shards)
# --------------------------------------------------------------------------
def host_router(keys, n_rows, P, cap):
    """What the router must give for ``keys`` (a host array) into
    ``n_rows`` rows over ``P`` shards with ``cap`` slots an owner, counted
    on the host: the rows and keys padded to the shard grid, each shard's
    distinct keys, each key's slot in its owner's bucket.  Returns (the
    shards' distinct keys summed, the overflows, which keys are answered)."""
    import numpy as np
    q = keys.shape[0]
    q_local = -(-q // P)
    size = -(-n_rows // P)
    padded = np.full(q_local * P, -1, np.int64)
    padded[:q] = keys
    cap = cap or q_local
    distinct = overflow = 0
    answered = np.zeros(q_local * P, bool)
    for p in range(P):
        row = padded[p * q_local:(p + 1) * q_local]
        uniq = np.unique(row[row >= 0])
        own = uniq // size
        slot = np.arange(uniq.shape[0]) - np.searchsorted(own, own)
        distinct += uniq.shape[0]
        overflow += int((slot >= cap).sum())
        mine = answered[p * q_local:(p + 1) * q_local]
        mine[:] = (np.isin(row, uniq[slot < cap]) if (slot >= cap).any()
                   else row >= 0)
    return distinct, overflow, answered[:q]


def routed_case(name, values, keys, P, cap, local_out):
    """``ShardedDHT(mesh=make_mesh(P), capacity=cap)`` on one read: its
    answered rows bit-equal to the local lookup's, the rest 0; its
    distinct count and overflows equal to the host's; timed."""
    import torch
    from repro_torch.core.dht import ShardedDHT, make_mesh
    from repro_torch.core.rounds import RoundLedger

    keys_h = keys.cpu().numpy()
    distinct, overflow, answered = host_router(keys_h, values.shape[0], P,
                                               cap)
    led = RoundLedger(name, deferred=True)
    torch.cuda.reset_peak_memory_stats()
    out = ShardedDHT(values, ledger=led, mesh=make_mesh(P),
                     capacity=cap).lookup(keys)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    led.harvest()
    check(led.dht_queries == distinct,
          f"{name} P {P}: {led.dht_queries} distinct keys, the host counts "
          f"{distinct}")
    check(led.dht_overflows == overflow,
          f"{name} P {P}: {led.dht_overflows} overflows, the host counts "
          f"{overflow}")
    check(cap is not None or overflow == 0, f"{name} P {P} overflowed")
    ans = torch.from_numpy(answered & (keys_h >= 0)).to(keys.device)
    check(torch.equal(out[ans], local_out[ans]),
          f"{name} P {P}: answered rows differ from the local lookup's")
    check(not bool(out[~ans].any()),
          f"{name} P {P}: an unanswered row is not 0")
    del out, ans
    timed = ShardedDHT(values, mesh=make_mesh(P), capacity=cap)
    return {"read": name, "P": P, "capacity": cap, "Q": int(keys.shape[0]),
            "rows": int(values.shape[0]),
            "row_bytes": values[0].numel() * values.element_size(),
            "n_unique": distinct, "overflow": overflow,
            "answered": int(answered.sum()), "peak_mem_gib": peak,
            "ms": time_ms(lambda: timed.lookup(keys), reps=5, warmup=1)}


def sasrec_history_read():
    """SASRec's history read: a seeded 1M x 50 f32 item table on the card
    and the 65,536 step-0 histories of 50 as one (3,276,800,) key batch."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.data.recsys import RecStreamConfig, batch_at_step

    dev = torch.device("cuda")
    cfg = registry.get(REC_ARCH).config
    gen = torch.Generator(dev).manual_seed(REC_PARAM_SEED)
    table = torch.randn(cfg.n_items, cfg.embed_dim, device=dev,
                        generator=gen) * 0.02
    B = registry.get(REC_ARCH).shapes["train_batch"].global_batch
    hist = torch.from_numpy(batch_at_step(RecStreamConfig(
        cfg.n_items, cfg.seq_len, B, seed=REC_DATA_SEED),
        0)[0].reshape(-1)).to(dev)
    return table, hist


def routed_dht_level(cc_reads):
    """``routed_lookup`` (through ``ShardedDHT``) at 1 and 8 shards on the
    first cc solve's root-label read and on SASRec's history read (65,536
    step-0 histories of 50 into a seeded 1M x 50 f32 table), and at 8
    shards with a quarter of the exact capacity on the cc solve's
    first-slot read (each shard's keys ascend, so most go to one owner and
    overflow there); each beside the local lookup's time, on a
    ``routed_dht`` line."""
    import torch
    from repro_torch.core.dht import ShardedDHT

    table, hist = sasrec_history_read()
    starved = -(-cc_reads[1][1].shape[0] // ROUTED_SHARDS) // 4
    for name, (values, keys), caps in (
            ("cc_roots", cc_reads[0], ((1, None), (ROUTED_SHARDS, None))),
            ("cc_first_slot", cc_reads[1], ((ROUTED_SHARDS, starved),)),
            ("sasrec_history", (table, hist),
             ((1, None), (ROUTED_SHARDS, None)))):
        keys = keys.to(torch.int32)
        local = ShardedDHT(values)
        local_out = local.lookup(keys)
        local_ms = time_ms(lambda: local.lookup(keys), reps=5, warmup=1)
        for P, cap in caps:
            row = routed_case(name, values, keys, P, cap, local_out)
            check(cap is None or row["overflow"] > 0,
                  f"{name}: capacity {cap} starved no owner")
            row["local_ms"] = local_ms
            emit({"phase": "routed_dht", **row})
        del local_out
    del table, hist
    torch.cuda.empty_cache()


def routed_phase(g, gw, cycles, outputs, solves, fleet):
    """The routed backend on the card.  ``AmpcEngine(dht_backend=
    RoutedDht(make_mesh(8)))`` on the seven Table-3 problems (rmat20, the
    2^24 cycles): each output equal to the engine phase's, the same
    shuffles, no overflow, at least the local solve's queries.  The default
    mesh (one shard a card) on connectivity: every counter equal to the
    local solve's.  A routed ``solve_many`` of the plain fleet, a routed
    session's cold and warm connectivity solve and a routed ``submit``, each
    equal to its local counterpart.  The launch counts are set to 0 before
    the routed solves and read after them: the router launches no
    ``dht_gather``.  Returns that count and the local ``solve_many``
    outputs of the fleet's connectivity."""
    import numpy as np
    import torch
    from repro_torch.ampc import AmpcEngine, RoutedDht
    from repro_torch.core.dht import make_mesh
    from repro_torch.kernels.dht_gather import ops

    def counts(ledger):
        return {k: v for k, v in ledger.items()
                if k not in ("wall_time_s", "phase_times")}

    # the local counterparts of the serving checks, before the counts
    local = AmpcEngine(dht_backend="local", seed=0)
    many_want = [r.output for r in local.solve_many(fleet, "connectivity")]
    submit_want = local.solve(fleet[0], "connectivity").output

    eng = AmpcEngine(dht_backend=RoutedDht(make_mesh(ROUTED_SHARDS)), seed=0)
    runs = [("rmat20", gw if p in ("msf", "weighted-matching") else g, p)
            for p in ROUTED_RMAT] + [(name, graph, "one-vs-two")
                                     for name, graph, _ in cycles]
    ops.dht_gather.launches = 0
    for graph_name, graph, problem in runs:
        res, wall, reads, launches, peak = timed_call(
            lambda: eng.solve(graph, problem))
        want = solves[(graph_name, problem)][0]["ledger"]
        emit({"phase": "routed", "graph": graph_name, "problem": problem,
              "shards": ROUTED_SHARDS, "wall_s": wall,
              "local_wall_s": [r["wall_s"]
                               for r in solves[(graph_name, problem)]],
              "host_reads": reads, "dht_gather_launches": launches,
              "peak_mem_gib": peak, "ledger": res.ledger})
        check(np.array_equal(res.output, outputs[(graph_name, problem)]),
              f"routed {problem} on {graph_name} differs from the local "
              "solve")
        check(res.shuffles == want["shuffles"],
              f"routed {problem}: {res.shuffles} shuffles, local "
              f"{want['shuffles']}")
        check(res.ledger["dht_overflows"] == 0,
              f"routed {problem}: {res.ledger['dht_overflows']} overflows")
        check(res.ledger["dht_queries"] >= want["dht_queries"],
              f"routed {problem}: {res.ledger['dht_queries']} queries, "
              f"fewer than the local solve's {want['dht_queries']}")

    default = AmpcEngine(dht_backend="routed", seed=0)
    res, wall, reads, launches, peak = timed_call(
        lambda: default.solve(g, "connectivity"))
    want = solves[("rmat20", "connectivity")][0]["ledger"]
    emit({"phase": "routed", "graph": "rmat20", "problem": "connectivity",
          "shards": torch.cuda.device_count(), "backend": repr(default.dht),
          "wall_s": wall, "host_reads": reads,
          "dht_gather_launches": launches, "peak_mem_gib": peak,
          "ledger": res.ledger})
    check(np.array_equal(res.output, outputs[("rmat20", "connectivity")]),
          "routed connectivity on the default mesh differs")
    check(counts(res.ledger) == counts(want),
          f"routed connectivity on the default mesh: ledger {res.ledger}, "
          f"local {want}")

    many, wall, reads, launches, peak = timed_call(
        lambda: eng.solve_many(fleet, "connectivity"))
    check(all(np.array_equal(r.output, w) for r, w in zip(many, many_want)),
          "routed solve_many differs from the local solve_many")
    check(all(r.ledger["dht_overflows"] == 0 for r in many),
          "routed solve_many overflowed")
    row = {"phase": "routed_serving", "solve_many_graphs": len(fleet),
           "solve_many_s": wall, "solve_many_peak_mem_gib": peak}
    sess = eng.session(g)
    for call, hit, n_shuffles in (("cold", False, 2), ("warm", True, 1)):
        res, wall, reads, launches, peak = timed_call(
            lambda: sess.solve("connectivity"))
        check(np.array_equal(res.output,
                             outputs[("rmat20", "connectivity")]),
              f"routed session connectivity ({call}) differs")
        check(res.stats["snapshot"]["hit"] is hit
              and res.shuffles == n_shuffles,
              f"routed session ({call}): snapshot {res.stats['snapshot']}, "
              f"{res.shuffles} shuffles")
        row.update({f"session_{call}_s": wall,
                    f"session_{call}_peak_mem_gib": peak})
    sess.invalidate()
    with AmpcEngine(dht_backend=RoutedDht(make_mesh(ROUTED_SHARDS)), seed=0,
                    max_workers=1) as pool:
        res, wall, _, _, _ = timed_call(
            lambda: pool.submit(fleet[0], "connectivity").result(
                timeout=600))
    check(np.array_equal(res.output, submit_want),
          "the routed submit differs from the local solve")
    row["submit_s"] = wall
    launches = ops.dht_gather.launches
    row["dht_gather_launches"] = launches
    emit(row)
    check(launches == 0,
          f"the routed phase launched dht_gather {launches} times")
    return launches, many_want


# --------------------------------------------------------------------------
# phase: eager accounting (the deferred ledger's baseline)
# --------------------------------------------------------------------------
def eager_phase(g, outputs, solves):
    """``deferred_accounting=False`` for mis and connectivity at rmat20:
    outputs and every counter equal to the deferred solves'.  mis runs
    deferred, eager, eager, deferred; connectivity once eager, beside the
    engine phase's second (warm) deferred solve.  Each line has the wall,
    the host reads, the transfers (``rounds.TRANSFERS``) and the harvests.
    Returns the phase's ``dht_gather`` launches: 2 a connectivity solve,
    since an eager local lookup still takes the kernel first."""
    import numpy as np
    from repro_torch.ampc import AmpcEngine
    from repro_torch.core import rounds
    from repro_torch.kernels.dht_gather import ops

    engines = {"deferred": AmpcEngine(seed=0),
               "eager": AmpcEngine(seed=0, deferred_accounting=False)}
    ops.dht_gather.launches = 0
    for problem, modes in (("mis", ("deferred", "eager", "eager",
                                    "deferred")),
                           ("connectivity", ("eager",))):
        want = solves[("rmat20", problem)][-1]
        rows = [{"mode": "deferred (engine phase)", "wall_s": want["wall_s"],
                 "host_reads": want["host_reads"],
                 "transfers": want["transfers"]}]
        for mode in modes:
            harvests = []
            transfers0 = rounds.TRANSFERS
            rounds.HARVEST_HOOK = harvests.append
            try:
                res, wall, reads, launches, peak = timed_call(
                    lambda: engines[mode].solve(g, problem))
            finally:
                rounds.HARVEST_HOOK = None
            check(np.array_equal(res.output, outputs[("rmat20", problem)]),
                  f"{mode} {problem} differs from the engine phase's")
            ledger = {k: v for k, v in res.ledger.items()
                      if k not in ("wall_time_s", "phase_times")}
            check(ledger == {k: want["ledger"][k] for k in ledger},
                  f"{mode} {problem}: ledger {res.ledger}, deferred "
                  f"{want['ledger']}")
            expect = CC_LAUNCHES_PER_SOLVE if problem == "connectivity" \
                else 0
            check(launches == expect,
                  f"{mode} {problem}: dht_gather launched {launches} times")
            rows.append({"mode": mode, "wall_s": wall, "host_reads": reads,
                         "transfers": rounds.TRANSFERS - transfers0,
                         "harvests": len(harvests), "peak_mem_gib": peak})
        emit({"phase": "eager", "graph": "rmat20", "problem": problem,
              "solves": rows})
    return ops.dht_gather.launches


# --------------------------------------------------------------------------
# phase: the DHT over a process group (one NCCL rank a card)
# --------------------------------------------------------------------------
# each collective's op names in a profile, the dispatcher's first
COLLECTIVE_OPS = {
    "all_to_all": ("c10d::alltoall_base_", "nccl:all_to_all"),
    "all_gather": ("c10d::_allgather_base_", "nccl:_all_gather_base",
                   "nccl:all_gather"),
    "all_reduce": ("c10d::allreduce_", "nccl:all_reduce")}


def nccl_rank():
    """One NCCL rank on this card (its address on this host), made once a
    run: the ``dht_group`` and ``launch`` phases share it."""
    import socket
    import torch.distributed as dist
    if not dist.is_initialized():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                rank=0, world_size=1)


def group_mesh():
    """A 1-D ``("dht",)`` cuda ``DeviceMesh`` over the one NCCL rank."""
    from torch.distributed.device_mesh import init_device_mesh
    nccl_rank()
    return init_device_mesh("cuda", (1,), mesh_dim_names=("dht",))


def collective_calls(prof):
    """Calls of each collective in a profile, counted by the first of its
    op names that appears."""
    counts = {}
    for e in prof.key_averages():
        counts[e.key] = counts.get(e.key, 0) + e.count
    return {kind: next((counts[n] for n in names if n in counts), 0)
            for kind, names in COLLECTIVE_OPS.items()}


def group_lookup_case(name, values, keys, mesh):
    """One read through ``ShardedDHT`` three ways: the local lookup, the
    one-process router at one shard and the router on the process group
    at one rank.  The group's output bit-equal to both others', its
    counters (queries, bytes, dedup savings, overflows) equal to both;
    CUDA-event ms of each; one group lookup under the profiler: two
    ``all_to_all`` collectives and no ``dht_gather`` launch."""
    import torch
    from repro_torch.core.dht import ShardedDHT, make_mesh
    from repro_torch.core.rounds import RoundLedger
    from repro_torch.kernels.dht_gather import ops

    kinds = {"local": {}, "one_process": {"mesh": make_mesh(1)},
             "group": {"mesh": mesh}}
    outs, counters = {}, {}
    for kind, kw in kinds.items():
        led = RoundLedger(name, deferred=True)
        outs[kind] = ShardedDHT(values, ledger=led, **kw).lookup(keys)
        led.harvest()
        counters[kind] = {k: v for k, v in led.summary().items()
                          if k not in ("wall_time_s", "phase_times")}
    for kind in ("local", "one_process"):
        check(torch.equal(outs["group"], outs[kind]),
              f"dht_group {name}: the group router's rows differ from the "
              f"{kind} lookup's")
        check(counters["group"] == counters[kind],
              f"dht_group {name}: counters {counters['group']}, {kind} "
              f"{counters[kind]}")
    check(counters["group"]["dht_overflows"] == 0,
          f"dht_group {name} overflowed")
    del outs
    row = {"read": name, "Q": int(keys.shape[0]),
           "rows": int(values.shape[0]),
           "row_bytes": values[0].numel() * values.element_size(),
           "counters": counters["group"]}
    for kind, kw in kinds.items():
        dht = ShardedDHT(values, **kw)
        row[f"{kind}_ms"] = time_ms(lambda: dht.lookup(keys), reps=5,
                                    warmup=1)
    dht = ShardedDHT(values, mesh=mesh)
    launches0 = ops.dht_gather.launches
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        dht.lookup(keys)
        torch.cuda.synchronize()
    row["collectives"] = collective_calls(prof)
    row["dht_gather_launches"] = ops.dht_gather.launches - launches0
    row["dht_gather_events"] = sum(
        e.count for e in prof.key_averages() if "dht_gather" in e.key)
    check(row["collectives"]["all_to_all"] == 2,
          f"dht_group {name}: a group lookup made "
          f"{row['collectives']} collectives, not two all_to_all")
    check(row["dht_gather_launches"] == 0 and not row["dht_gather_events"],
          f"dht_group {name}: the group router launched dht_gather")
    return row


def dht_group_phase(cc_reads, g, gw, cycles, outputs, fleet, many_want):
    """The DHT on a process group: one NCCL rank, a 1-D ``("dht",)``
    cuda ``DeviceMesh``.  (a) The first cc solve's root-label read and
    SASRec's history read through the group router, the one-process
    router at one shard and the local lookup (``group_lookup_case``).
    (b) ``AmpcEngine(mesh=that mesh, dht_backend="routed")`` on every
    problem the routed phase solves (rmat20, the 2^24 cycles) beside the
    one-process routed engine at one shard: outputs equal to the engine
    phase's, every counter but the walls and the host reads equal to that
    engine's, no overflow.  (c) A group-backed ``solve_many`` of the plain
    fleet, a session's cold and warm connectivity solve at rmat20 and
    ASYNC_GRAPHS ``submit``s on 2 workers, each equal to the local answer.
    The launch counts are set to 0 before (b) and read after (c): the
    router launches no ``dht_gather``.  A failed NCCL start or collective
    raises.  Returns that count."""
    import numpy as np
    import torch
    from repro_torch.ampc import AmpcEngine, RoutedDht
    from repro_torch.core.dht import make_mesh
    from repro_torch.kernels.dht_gather import ops

    t0 = time.perf_counter()
    mesh = group_mesh()
    table, hist = sasrec_history_read()
    for name, (values, keys) in (("cc_roots", cc_reads[0]),
                                 ("sasrec_history", (table, hist))):
        emit({"phase": "dht_group", **group_lookup_case(
            name, values, keys.to(torch.int32), mesh)})
    del table, hist
    torch.cuda.empty_cache()

    def counts(res):
        led = {k: v for k, v in res.ledger.items() if k != "wall_time_s"}
        led["phase_times"] = list(led["phase_times"])
        return led

    group = AmpcEngine(mesh=mesh, dht_backend="routed", seed=0)
    one = AmpcEngine(dht_backend=RoutedDht(make_mesh(1)), seed=0)
    runs = [("rmat20", gw if p in ("msf", "weighted-matching") else g, p)
            for p in ROUTED_RMAT] + [(name, graph, "one-vs-two")
                                     for name, graph, _ in cycles]
    ops.dht_gather.launches = 0
    for graph_name, graph, problem in runs:
        want, want_wall, want_reads, _, _ = timed_call(
            lambda: one.solve(graph, problem))
        res, wall, reads, _, peak = timed_call(
            lambda: group.solve(graph, problem))
        emit({"phase": "dht_group", "graph": graph_name, "problem": problem,
              "backend": repr(group.dht), "wall_s": wall,
              "one_process_wall_s": want_wall, "host_reads": reads,
              "one_process_host_reads": want_reads, "peak_mem_gib": peak,
              "ledger": res.ledger})
        check(np.array_equal(res.output, outputs[(graph_name, problem)]),
              f"group {problem} on {graph_name} differs from the local "
              "solve")
        check(counts(res) == counts(want),
              f"group {problem} on {graph_name}: ledger {res.ledger}, one "
              f"shard {want.ledger}")
        check(res.ledger["dht_overflows"] == 0,
              f"group {problem}: {res.ledger['dht_overflows']} overflows")
        check(reads == want_reads,
              f"group {problem}: {reads} host reads, one shard "
              f"{want_reads}")

    many, wall, _, _, peak = timed_call(
        lambda: group.solve_many(fleet, "connectivity"))
    check(all(np.array_equal(r.output, w) for r, w in zip(many, many_want))
          and all(r.ledger["dht_overflows"] == 0 for r in many),
          "the group solve_many differs from the local solve_many")
    row = {"phase": "dht_group_serving", "solve_many_graphs": len(fleet),
           "solve_many_s": wall, "solve_many_peak_mem_gib": peak}
    sess = group.session(g)
    for call, hit, n_shuffles in (("cold", False, 2), ("warm", True, 1)):
        res, wall, _, _, peak = timed_call(
            lambda: sess.solve("connectivity"))
        check(np.array_equal(res.output,
                             outputs[("rmat20", "connectivity")])
              and res.stats["snapshot"]["hit"] is hit
              and res.shuffles == n_shuffles,
              f"the group session's {call} connectivity solve: snapshot "
              f"{res.stats['snapshot']}, {res.shuffles} shuffles")
        row[f"session_{call}_s"] = wall
    sess.invalidate()
    with AmpcEngine(mesh=mesh, dht_backend="routed", seed=0,
                    max_workers=2) as pool:
        results, wall, _, _, _ = timed_call(lambda: [
            f.result(timeout=600) for f in [
                pool.submit(f, "connectivity")
                for f in fleet[:ASYNC_GRAPHS]]])
    check(all(np.array_equal(r.output, w)
              for r, w in zip(results, many_want)),
          "a group submit differs from the local answer")
    row.update(submits=len(results), submit_s=wall,
               dht_gather_launches=ops.dht_gather.launches)
    emit(row)
    check(ops.dht_gather.launches == 0,
          f"the dht_group phase launched dht_gather "
          f"{ops.dht_gather.launches} times")
    emit({"phase": "dht_group_seconds", "seconds": time.perf_counter() - t0})
    return ops.dht_gather.launches


def group_psum_case(grads):
    """``compressed_psum`` of a gradient tree over the one NCCL rank: the
    average bit-equal to ``decompress`` of ``compress`` and the feedback
    bit-equal to ``compress``'s, leaf by leaf; its wall."""
    import torch
    from repro_torch.optim import grad_compression

    mesh = group_mesh()
    fb = grad_compression.init_feedback(grads)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    avg, new_fb = grad_compression.compressed_psum(grads, fb, "dht",
                                                   mesh=mesh)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    mismatched = []
    for name in grads:
        q, s, want_fb = grad_compression.compress(grads[name], fb[name])
        if not (torch.equal(avg[name], grad_compression.decompress(q, s))
                and torch.equal(new_fb[name], want_fb)):
            mismatched.append(name)
        del q, s, want_fb
    check(not mismatched, f"compressed_psum at one rank differs from "
          f"compress at {mismatched}")
    emit({"phase": "dht_group", "case": "compressed_psum", "ranks": 1,
          "leaves": len(grads), "elements": sum(x.numel()
                                                for x in grads.values()),
          "ms": ms, "bit_equal_to_compress": True})


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


def flash_source(kind, route):
    """The repository path of the flash ``kind`` ("fwd" or "bwd") source of
    ``route`` ("wgmma" or "simt")."""
    suffix = "_wgmma" if route == "wgmma" else ""
    return f"{FLASH_CSRC}/flash_attention_{kind}{suffix}.cu"


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
        attention_bwd_ref, attention_bwd_split_ref, attention_fwd_lse_ref,
        grad_limit, rounding_miss_limit)
    B, S, H, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    o, lse = attention_fwd_lse_ref(q, k, v, True, window)
    _, lse_kernel = kernel.flash_attention_cuda(q, k, v, True, window,
                                                with_lse=True)
    delta = bwd.row_delta(o, do)
    route = bwd.route(q)
    fns = (bwd.flash_bwd_dq, bwd.flash_bwd_dkv)
    before = [dict(fn.launches_by_route) for fn in fns]
    runs = [(bwd.flash_bwd_dq(q, k, v, do, lse_kernel, delta, True, window),
             *bwd.flash_bwd_dkv(q, k, v, do, lse_kernel, delta, True,
                                window))
            for _ in range(2)]
    want = attention_bwd_ref(q, k, v, o, lse, do, True, window)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          f"backward kernels differ between two runs at {name}")
    for fn, was in zip(fns, before):
        check(fn.launches_by_route == dict(was, **{route: was[route] + 2}),
              f"{fn.__name__} at {name} launched {fn.launches_by_route} "
              f"by route from {was}, not twice on {route}")
    dtype = str(q.dtype).replace("torch.", "")
    row = {"shape": name, "kernel_route": route,
           "fwd_kernel_route": kernel.route(q), "B": B, "S": S, "K": K,
           "H": H, "Hkv": Hkv, "D": D, "window": window, "dtype": dtype,
           "strided": not q.is_contiguous()}
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
    if route == "wgmma":
        # P and dS at f32 accuracy: count the elements that are not the
        # correctly rounded f32 gradient, against the split mirror's count
        # and a bf16-only P and dS mirror's on the kernels' own lse
        args = (q, k, v, o, lse_kernel, do, True, window)
        target = attention_bwd_ref(*args)
        mirrors = (attention_bwd_split_ref(*args),
                   attention_bwd_split_ref(*args, lo=False))
        for what, got, want_rn, split, one in zip(
                ("dq", "dk", "dv"), runs[0], target, *mirrors):
            misses = [int((x != want_rn).sum()) for x in (got, split, one)]
            limit = rounding_miss_limit(*misses[1:])
            row.update({f"{what}_rounding_misses": misses[0],
                        f"{what}_split_mirror_misses": misses[1],
                        f"{what}_bf16_mirror_misses": misses[2],
                        f"{what}_miss_limit": limit})
            check(misses[0] <= limit, f"{what} at {name}: {misses[0]} "
                  f"elements not the rounded f32 gradient, past {limit} "
                  f"(split mirror {misses[1]}, bf16-only {misses[2]})")
        del target, mirrors
    del runs
    pairs = attention_pairs(S, K, True, window)
    product = 2 * D * pairs * B * H          # flops of one masked product
    es = q.element_size()
    reads = (q.numel() + k.numel() + v.numel() + do.numel()) * es \
        + 2 * lse.numel() * 4                # q, k, v, do, lse, delta
    peak = PEAK_FLOPS[dtype]
    # the wgmma route takes P and dS in two bf16 parts, so the products
    # that read them run twice on the tensor cores: 4 products in dq (S,
    # dP, dQ hi and lo), 6 in dk/dv (S, dP, dV and dK hi and lo)
    split = route == "wgmma"
    row["tensor_work"] = {}
    for kname, n_products, n_split, nbytes in (
            ("dq", 3, 4, reads + q.numel() * es),
            ("dkv", 4, 6, reads + 2 * k.numel() * es)):
        flops = n_products * product
        op_ms, byte_ms = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        row[f"{kname}_flops"] = flops
        row[f"{kname}_bound_ms"] = max(op_ms, byte_ms)
        row[f"{kname}_bound_by"] = ("operations" if op_ms >= byte_ms
                                    else "bytes")
        tensor_flops = (n_split if split else n_products) * product
        row["tensor_work"].update({
            f"{kname}_tensor_flops": tensor_flops,
            f"{kname}_tensor_ms_at_peak": tensor_flops / peak * 1e3})
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
        if route == "wgmma":
            row.update(
                dq_simt_ms=time_ms(lambda: bwd.launch_dq(
                    q, k, v, do, lse, delta, dq_buf, True, window,
                    which="simt"), reps=5),
                dkv_simt_ms=time_ms(lambda: bwd.launch_dkv(
                    q, k, v, do, lse, delta, dk_buf, dv_buf, True, window,
                    which="simt"), reps=5))
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
    dq_route = bwd.flash_bwd_dq.launches_by_route
    dkv_route = bwd.flash_bwd_dkv.launches_by_route
    return {"fwd": flash_ops.flash_attention.launches,
            "fwd_wgmma": by_route["wgmma"], "fwd_simt": by_route["simt"],
            "dq": bwd.flash_bwd_dq.launches,
            "dq_wgmma": dq_route["wgmma"], "dq_simt": dq_route["simt"],
            "dkv": bwd.flash_bwd_dkv.launches,
            "dkv_wgmma": dkv_route["wgmma"], "dkv_simt": dkv_route["simt"],
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
    bwd.flash_bwd_dq.launches_by_route = {"wgmma": 0, "simt": 0}
    bwd.flash_bwd_dkv.launches_by_route = {"wgmma": 0, "simt": 0}
    dht_ops.dht_gather.launches = 0
    seg_ops.segment_matmul.launches = 0
    embag_ops.embedding_bag.launches = 0


# kernel names of the step's parts, as the profiler reports them
KERNEL_KINDS = (("flash_fwd", ("flash_fwd_kernel",
                                "flash_fwd_wgmma_kernel")),
                ("flash_bwd_dq", ("flash_bwd_dq_kernel",
                                  "flash_bwd_dq_wgmma_kernel")),
                ("flash_bwd_dkv", ("flash_bwd_dkv_kernel",
                                   "flash_bwd_dkv_wgmma_kernel")),
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
            "dq_wgmma": TRAIN_MICRO * cfg.n_layers, "dq_simt": 0,
            "dkv": TRAIN_MICRO * cfg.n_layers,
            "dkv_wgmma": TRAIN_MICRO * cfg.n_layers, "dkv_simt": 0,
            "dht_gather": 0,
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
    # f32: the forward and the backward take the SIMT route
    check(launched["pallas"] == {"fwd": L, "fwd_wgmma": 0, "fwd_simt": L,
                                 "dq": L, "dq_wgmma": 0, "dq_simt": L,
                                 "dkv": L, "dkv_wgmma": 0, "dkv_simt": L,
                                 "dht_gather": 0, "segment_matmul": 0,
                                 "embedding_bag": 0},
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
            load_width=kernel.load_width(D, es, x.data_ptr(),
                                         agg_buf.data_ptr()),
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
    """|got - want| <= GNN_RTOL max |want| (on the host); returns the
    difference's share of that limit."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    # a loss of 0 (a saturated GIN readout) must be met exactly
    limit = GNN_RTOL * max(float(want.abs().max()), 1e-30)
    share = float((got - want).abs().max()) / limit
    check(share <= 1.0, f"{name}: {share} times the limit {limit}")
    return share


def gnn_phase():
    """gin-tu at full width (5 layers, d_hidden 64, d_feat 602, f32) on
    1024-seed (15, 10) blocks of a Reddit-scale RMAT graph: one
    ``gnn_forward_step``, then ``GNN_STEPS`` ``gnn_train_step``s on fresh
    blocks, the launch counts set to 0 just before each and read just
    after.  Returns the launches of the four runs, the kernel's rows on
    layer 0's and layer 1's own inputs, and the graph, sampler and
    feature table (for the ``gnn_models`` phase)."""
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
    del model, state, named
    torch.cuda.empty_cache()
    # the graph, its sampler and feature table serve the gnn_models phase's
    # minibatch_lg cells
    return total, rows, {"graph": g, "sampler": sampler, "table": table}


# --------------------------------------------------------------------------
# phase: the other GNN models (GCN, SchNet, MACE) on every GNN shape
# --------------------------------------------------------------------------
def gnn_cell_config(arch, shape):
    """The registry's full-width config of ``arch`` for ``shape``: GCN's
    and GIN's input width is the cell's dataset's, 64 for molecules
    (``launch/specs.py::_gnn_lowerable``)."""
    from repro_torch.configs import registry
    cfg = registry.get(arch).config
    if arch in ("gcn-cora", "gin-tu"):
        d_feat = (shape.d_feat if shape.kind in ("gnn_full", "gnn_sampled")
                  else GNN_MOLECULE_FEAT)
        cfg = dataclasses.replace(cfg, d_feat=d_feat)
    return cfg


def with_targets(arch, cfg, batch, rng):
    """``batch`` with the inputs and labels ``specs._gnn_batch_struct``
    gives ``arch``: GCN (N,) class labels, GIN (n_graphs,) class labels,
    SchNet and MACE (n_graphs,) f32 energies with positions (N, 3) and
    species below ``n_species`` (drawn from ``rng`` where the builder has
    none: positions uniform in a 3-unit cube, energies standard normal)."""
    import torch
    dev, n = batch.senders.device, batch.n_nodes

    def ints(high, count):
        return torch.from_numpy(rng.integers(0, high, count).astype(
            "int32")).to(dev)

    if arch == "gcn-cora":
        return dataclasses.replace(batch, labels=ints(cfg.n_classes, n))
    if arch == "gin-tu":
        return dataclasses.replace(batch, labels=ints(cfg.n_classes,
                                                      batch.n_graphs))
    if batch.positions is not None:
        return batch
    return dataclasses.replace(
        batch, node_feat=None,
        positions=torch.from_numpy((GNN_POSITION_BOX * rng.random(
            (n, 3))).astype("float32")).to(dev),
        species=ints(cfg.n_species, n),
        labels=torch.from_numpy(rng.standard_normal(batch.n_graphs).astype(
            "float32")).to(dev))


def to_cpu(batch):
    import torch
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name).cpu()
        for f in dataclasses.fields(batch)
        if isinstance(getattr(batch, f.name), torch.Tensor)})


def hold_against_cpu(model, batch):
    """The card's forward, loss and every gradient against the port's own
    CPU model on the same parameters and batch (f32, TF32 off), each
    within ``GNN_RTOL`` of the largest |element| of the CPU's tensor.
    Returns the largest share of its limit."""
    import copy
    from repro_torch.launch.steps import gnn_forward_step
    cpu_model = copy.deepcopy(model).cpu()
    cpu_batch = to_cpu(batch)
    shares = {"forward": check_close("forward on the card against the CPU",
                                     gnn_forward_step(model, batch),
                                     gnn_forward_step(cpu_model, cpu_batch))}
    loss, _ = model.loss_fn(batch)
    cpu_loss, _ = cpu_model.loss_fn(cpu_batch)
    shares["loss"] = check_close("loss on the card against the CPU", loss,
                                 cpu_loss)
    loss.backward()
    cpu_loss.backward()
    worst = 0.0
    cpu_params = dict(cpu_model.named_parameters())
    for name, p in model.named_parameters():
        q = cpu_params[name]
        check((p.grad is None) == (q.grad is None),
              f"{name}: a gradient on one device only")
        if p.grad is not None and bool(q.grad.any()):
            worst = max(worst, check_close(f"{name}'s gradient on the card "
                                           f"against the CPU", p.grad,
                                           q.grad))
        elif p.grad is not None:
            check(not bool(p.grad.any()), f"{name}: a gradient on the card "
                  f"where the CPU's is zero")
        p.grad = None
    shares["gradients"] = worst
    return shares


def mace_invariance(model, batch, rng):
    """The largest |e1 - e2| / (2e-4 (1 + |e1|)) of MACE's energies under a
    seeded rotation plus translation of every position, on the card."""
    import numpy as np
    import torch
    from repro_torch.launch.steps import gnn_forward_step
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    R = torch.from_numpy(q.astype(np.float32)).to(batch.positions.device)
    shift = torch.from_numpy(rng.standard_normal(3).astype(np.float32)).to(
        R.device)
    e1 = gnn_forward_step(model, batch).double()
    e2 = gnn_forward_step(model, dataclasses.replace(
        batch, positions=batch.positions @ R.T + shift)).double()
    share = float(((e1 - e2).abs() / (MACE_INVARIANCE_TOL
                                       * (1 + e1.abs()))).max())
    check(share <= 1.0, f"MACE energies move {share} times the reference "
          f"test's bound under a rotation and translation")
    return share


def gradient_extent(model, batch):
    """The largest |gradient element| of one backward of the loss, whether
    every element is finite, and whether the f32 sum of their squares (the
    global norm's, as both packages compute it) overflows; the gradients
    are cleared after."""
    import torch
    from repro_torch.optim.adamw import global_norm
    loss, _ = model.loss_fn(batch)
    loss.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    largest = max(float(g.abs().max()) for g in grads)
    norm = float(global_norm(grads))
    model.zero_grad(set_to_none=True)
    return {"grad_abs_max": largest, "grads_finite": finite,
            "norm_overflows": not math.isfinite(norm)}


def gnn_model_cell(arch, shape_name, cfg, next_batch, small, rng):
    """One cell: one ``gnn_forward_step``, then ``GNN_STEPS``
    ``gnn_train_step``s (``next_batch(i)`` gives forward 0 and step i + 1
    its batch), the launch counts set to 0 just before each and read just
    after: ``cfg.n_layers`` ``segment_matmul`` launches each for GIN,
    none for the others, no other kernel's.  Finite outputs, losses and
    parameters; a grad norm positive exactly when the loss is, or, where
    the f32 sum of the gradient's squares overflows (GIN's sum readout on
    ogb_products), inf with every gradient element finite: the clip then
    zeroes the step, as the reference's AdamW does, and only weight decay
    moves the parameters.  Every parameter changed but the zeros of a run
    without a usable gradient; a small cell held against the CPU first
    (MACE's molecules also for invariance).  Returns its line."""
    import torch
    from repro_torch.launch.steps import (GNN_MODELS, gnn_forward_step,
                                          gnn_train_step)
    from repro_torch.optim import adamw
    model = GNN_MODELS[arch](cfg, seed=GNN_PARAM_SEED)
    check(model.device.type == "cuda", f"{arch} on {model.device}")
    opt_cfg = adamw.AdamWConfig()   # the reference's specs._opt_cfg()
    state = adamw.init_state(model, opt_cfg)
    named = dict(model.named_parameters())
    before = {n: fingerprint(p) for n, p in named.items()}
    zero = dict.fromkeys(launch_counts(), 0)
    want = dict(zero, segment_matmul=cfg.n_layers if arch == "gin-tu" else 0)
    total = dict(zero)

    def counted(fn):
        zero_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        check(launches == want, f"{arch} x {shape_name} launched {launches}, "
              f"expected {want}")
        for k in total:
            total[k] += launches[k]
        return out, wall

    batch, host_s = next_batch(0)
    line = {"phase": "gnn_models", "arch": arch, "shape": shape_name,
            "nodes": batch.n_nodes, "edges": int(batch.edge_mask.sum()),
            "graphs": batch.n_graphs, "d_feat": getattr(cfg, "d_feat", None),
            "params": sum(p.numel() for p in named.values())}
    torch.cuda.reset_peak_memory_stats()
    out, line["forward_s"] = counted(lambda: gnn_forward_step(model, batch))
    want_shape = ((batch.n_nodes, cfg.n_classes) if arch == "gcn-cora"
                  else (batch.n_graphs, cfg.n_classes) if arch == "gin-tu"
                  else (batch.n_graphs,))
    check(tuple(out.shape) == want_shape and bool(torch.isfinite(out).all()),
          f"{arch} x {shape_name}: output {tuple(out.shape)}, finite "
          f"{bool(torch.isfinite(out).all())}")
    line["forward_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del out
    if small:
        line["cpu_err_over_limit"] = hold_against_cpu(model, batch)
        if arch == "mace":
            line["invariance_err_over_limit"] = mace_invariance(model, batch,
                                                                rng)
    extent = gradient_extent(model, batch)
    check(extent["grads_finite"], f"{arch} x {shape_name}: a gradient "
          f"element is not finite ({extent})")
    line.update(extent)
    losses, walls, sample_s = [], [], [host_s]
    moved = False   # some step had a usable (nonzero, clipped) gradient
    torch.cuda.reset_peak_memory_stats()
    for step in range(GNN_STEPS):
        if step:
            batch, host_s = next_batch(step)
            sample_s.append(host_s)
        metrics, wall = counted(lambda: gnn_train_step(model, opt_cfg,
                                                       state, batch))
        m = {k: float(v) for k, v in metrics.items()}
        where = f"{arch} x {shape_name} step {step}"
        check(all(math.isfinite(m[k]) for k in m if k != "grad_norm"),
              f"{where} metrics {m}")
        if math.isfinite(m["grad_norm"]):
            check(m["grad_norm"] > 0 if m["loss"] > 0
                  else m["grad_norm"] == 0, f"{where}: grad norm "
                  f"{m['grad_norm']} at loss {m['loss']}")
            moved = moved or m["grad_norm"] > 0
        else:
            check(m["grad_norm"] == math.inf, f"{where} metrics {m}")
        check(all(bool(torch.isfinite(p).all()) for p in named.values()),
              f"{where}: a parameter is not finite")
        losses.append(m["loss"])
        walls.append(wall)
        line.setdefault("grad_norms", []).append(m["grad_norm"])
    check(int(state["step"]) == GNN_STEPS, f"AdamW step count "
          f"{int(state['step'])}")
    # as in the gnn phase: without a usable gradient only weight decay
    # moves a parameter, and it leaves the zeros alone
    unchanged = [n for n, p in named.items() if fingerprint(p) == before[n]
                 and (moved or bool(p.any()))]
    check(not unchanged, f"{arch} x {shape_name}: parameters unchanged by "
          f"training: {unchanged}")
    line.update(losses=losses, step_s=walls, host_batch_s=sample_s,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                launches={k: v for k, v in total.items() if v})
    del model, state, named, batch
    torch.cuda.empty_cache()
    return line, total["segment_matmul"]


def gnn_models_phase(blocks):
    """Every GNN cell of the registry (arch x ``GNN_SHAPES``) but gin-tu x
    minibatch_lg (the gnn phase's) and the cut ones, at full width, f32,
    TF32 off.  ``blocks``: the gnn phase's graph, sampler and feature
    table, whose 1024-seed blocks the minibatch_lg cells take.  Returns
    the ``segment_matmul`` launches (the GIN cells')."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.data import graphs

    cells = set(GNN_MODEL_CELLS) | set(GNN_MODEL_CUTS) | {(GNN_ARCH,
                                                           GNN_SHAPE)}
    want = {(a, s) for a, e in registry.REGISTRY.items() if e.family == "gnn"
            for s in e.shapes}
    check(cells == want and len(GNN_MODEL_CELLS) == 13,
          f"the GNN cells do not cover the registry's: {sorted(want ^ cells)}")
    emit({"phase": "gnn_models_cut", "cells": [
        {"arch": a, "shape": s, "why": why}
        for (a, s), why in GNN_MODEL_CUTS.items()]})
    dev = torch.device("cuda")
    rng = np.random.default_rng(GNN_MODEL_SEED)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches, walls = 0, {}
    g, sampler, table = blocks["graph"], blocks["sampler"], blocks["table"]
    # per-vertex targets of the sampled graph, gathered by each block
    node_labels = rng.integers(0, 7, g.n).astype(np.int32)
    positions = torch.from_numpy((GNN_POSITION_BOX * rng.random(
        (g.n, 3))).astype(np.float32)).to(dev)
    species = torch.from_numpy(rng.integers(0, 10, g.n).astype(
        np.int32)).to(dev)
    try:
        for arch, shape_name in GNN_MODEL_CELLS:
            if shape_name == "ogb_products":
                continue
            t0 = time.perf_counter()
            shape = GNN_SHAPES[shape_name]
            cfg = gnn_cell_config(arch, shape)
            if shape_name == "minibatch_lg":
                energy = arch in ("schnet", "mace")

                def next_batch(step, cfg=cfg, arch=arch, energy=energy):
                    seeds = rng.integers(0, g.n, shape.batch_nodes)
                    t1 = time.perf_counter()
                    sample = sampler.sample(seeds)
                    host_s = time.perf_counter() - t1
                    block = sampler.to_block(
                        sample, None if energy else table,
                        None if energy else node_labels)
                    if energy:
                        nodes = torch.from_numpy(sample[0]).to(dev)
                        block = dataclasses.replace(
                            block, positions=positions[nodes],
                            species=species[nodes],
                            labels=torch.from_numpy(rng.standard_normal(
                                1).astype(np.float32)).to(dev))
                    return block, host_s
                small = False
            else:
                t1 = time.perf_counter()
                if shape_name == "molecule":
                    base = graphs.molecules(
                        GNN_SHAPES["molecule"].n_graphs,
                        GNN_SHAPES["molecule"].n_nodes, seed=GNN_GRAPH_SEED,
                        d_feat=GNN_MOLECULE_FEAT, device=dev)
                else:
                    base = graphs.cora_like(seed=GNN_GRAPH_SEED, device=dev)
                batch = with_targets(arch, cfg, base, rng)
                build_s = time.perf_counter() - t1

                def next_batch(step, batch=batch, build_s=build_s):
                    return batch, build_s if step == 0 else 0.0
                small = True
            line, n = gnn_model_cell(arch, shape_name, cfg, next_batch,
                                     small, rng)
            launches += n
            walls[f"{arch} x {shape_name}"] = time.perf_counter() - t0
            emit(line)
        del blocks["table"], blocks["sampler"], table, sampler, positions
        torch.cuda.empty_cache()
        # ogb_products: one products_like graph for both full-batch cells
        t0 = time.perf_counter()
        base = graphs.products_like(**GNN_PRODUCTS, seed=GNN_GRAPH_SEED,
                                    device=dev)
        torch.cuda.synchronize()
        emit({"phase": "gnn_products_setup", "nodes": base.n_nodes,
              "directed_edges": base.senders.shape[0],
              "seconds": time.perf_counter() - t0})
        walls["products_setup"] = time.perf_counter() - t0
        for arch, shape_name in GNN_MODEL_CELLS:
            if shape_name != "ogb_products":
                continue
            t0 = time.perf_counter()
            cfg = gnn_cell_config(arch, GNN_SHAPES[shape_name])
            batch = with_targets(arch, cfg, base, rng)

            def next_batch(step, batch=batch):
                return batch, 0.0
            line, n = gnn_model_cell(arch, shape_name, cfg, next_batch,
                                     False, rng)
            launches += n
            del batch, next_batch
            walls[f"{arch} x {shape_name}"] = time.perf_counter() - t0
            emit(line)
        del base
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    emit({"phase": "gnn_models_seconds", **walls})
    return launches


# --------------------------------------------------------------------------
# phase: LM serving (prefill, ring-buffer decode, the serve launcher)
# --------------------------------------------------------------------------
def float_params(model):
    """An f32 copy of a ``TransformerLM``'s parameters in ``init_params``'
    layout, on its device."""
    return {"embed": model.embed.detach().float(),
            "layers": [{"attn": {k: v.detach().float()
                                 for k, v in b.attn.items()},
                        "mlp": {k: v.detach().float()
                                for k, v in b.mlp.items()},
                        "ln1": b.ln1.detach().float(),
                        "ln2": b.ln2.detach().float()}
                       for b in model.layers],
            "final_norm": model.final_norm.detach().float(),
            **({} if model.cfg.tie_embeddings
               else {"lm_head": model.lm_head.detach().float()})}


def serve_line(name, r, batch, prompt_len, gen, launches):
    import torch
    logits = r["logits"]
    check(bool(torch.isfinite(logits).all()), f"{name}: logits not finite")
    check(r["generated"].shape == (batch, gen), f"{name}: generated "
          f"{r['generated'].shape}")
    return {"phase": "lm_serve", "cell": name, "batch": batch,
            "prompt_len": prompt_len, "gen": gen,
            "prefill_s": r["prefill_s"], "prefill_tok_s": r["prefill_tok_s"],
            "decode_ms_per_step": r["decode_s"] / gen * 1e3,
            "decode_tok_s": r["decode_tok_s"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": {k: v for k, v in launches.items() if v},
            "generated": r["generated"][0].tolist()}


def decode_rows(model, one, first_token, prompt):
    """decode_32k cut to B 8: ``one``, a B 1 prompt's cache from
    ``serve``, copied into SERVE_DECODE_BATCH rows of a zero-filled cache
    of prompt + SERVE_GEN slots; SERVE_GEN decode steps, row 0 fed
    ``first_token`` and the other rows seeded tokens, the launch counts
    set to 0 just before.  Returns {"row0": row 0's f32 logits at the
    first step, "decode_s", "cache_gib", "launches", "peak_mem_gib"}."""
    import numpy as np
    import torch
    from repro_torch.launch.steps import lm_decode_step
    cfg, B = model.cfg, SERVE_DECODE_BATCH
    torch.cuda.reset_peak_memory_stats()
    shape = (cfg.n_layers, B, prompt + SERVE_GEN, cfg.n_kv_heads,
             cfg.head_dim)
    cache = {}
    for name in ("k", "v"):
        cache[name] = torch.zeros(shape, dtype=cfg.dtype, device=model.device)
        cache[name][:, :, :prompt].copy_(one[name][:, :, :prompt])
    cache["length"] = torch.full((B,), prompt, dtype=torch.int32,
                                 device=model.device)
    del one
    rng = np.random.default_rng(SERVE_TOKEN_SEED)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, B)).to(model.device)
    tok[0] = first_token
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(SERVE_GEN):
        logits, cache = lm_decode_step(model, cache, tok)
        if step == 0:
            row0 = logits[0].float()
        tok = torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = launch_counts()
    check(bool(torch.isfinite(logits).all()), "decode_32k logits")
    check(int(cache["length"][0]) == prompt + SERVE_GEN, "decode_32k length")
    return {"row0": row0, "decode_s": decode_s, "launches": launches,
            "cache_gib": 2 * cache["k"].numel() * cache["k"].element_size()
            / 2**30,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def decode_line(phase, cell, d, drift):
    B = SERVE_DECODE_BATCH
    return {"phase": phase, "cell": cell, "batch": B,
            "cache_slots": SERVE_PROMPT + SERVE_GEN,
            "cache_gib": d["cache_gib"],
            "decode_ms_per_step": d["decode_s"] / SERVE_GEN * 1e3,
            "decode_tok_s": B * SERVE_GEN / d["decode_s"],
            "row0_drift_of_max": drift, "peak_mem_gib": d["peak_mem_gib"],
            "launches": {k: v for k, v in d["launches"].items() if v}}


def lm_serve_phase():
    """qwen3-4b at full width and depth with seeded bf16 weights:
    ``serve`` at prefill_32k cut to B 1 (32,768 prompt tokens, 16
    generated), then decode_32k cut to B 8 (that prefill's cache copied
    into 8 rows of a zero-filled 32,768 + 16 slot cache, 16 decode steps);
    in f32 with TF32 off on the same weights, ``decode_step`` after
    ``prefill`` against the forward's last logits at S 1024, and the
    chunked attention against ``attention_xla`` on layer 0's own q, k, v
    at S 4096, with and without static skipping.  Then gemma3-12b (bf16)
    ``serve`` at a 4,096-token prompt.  Every run with the launch counts
    set to 0 just before and read just after: the serving path runs no
    kernel (the reference's prefill never reaches the flash kernel)."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch.serve import grow_cache, serve
    from repro_torch.models.layers import (attention_xla,
                                           attention_xla_chunked, attn_qkv,
                                           make_attention_mask, rms_norm)
    from repro_torch.models.transformer import TransformerLM

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    zero = dict.fromkeys(launch_counts(), 0)
    walls = {}

    def no_kernel(what):
        launches = launch_counts()
        check(launches == zero, f"{what} launched {launches}")
        return launches

    t0 = time.perf_counter()
    cfg = registry.get(LM_ARCH).config
    model = TransformerLM(cfg, device=dev, seed=LM_SEED,
                          dtype=torch.bfloat16)
    emit({"phase": "lm_serve_setup", "arch": LM_ARCH,
          "weights_gib": torch.cuda.memory_allocated() / 2**30,
          "seconds": time.perf_counter() - t0})
    # prefill_32k, B 1
    t0 = time.perf_counter()
    prompt = SERVE_PROMPT
    zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    r = serve(LM_ARCH, False, 1, prompt, SERVE_GEN, seed=LM_DATA_SEED,
              model=model)
    emit(serve_line("prefill_32k_b1", r, 1, prompt, SERVE_GEN,
                    no_kernel("serve at prefill_32k")))
    walls["prefill_32k"] = time.perf_counter() - t0

    # decode_32k, B 8: the prompt's cache in 8 rows of a zero-filled cache
    t0 = time.perf_counter()
    first_logits = r["logits"][1, 0].float()
    d = decode_rows(model, r.pop("cache"), int(r["generated"][0, 0]),
                    prompt)
    del r
    no_kernel("decode at decode_32k")
    # row 0 decodes serve's first token on the same prompt: its logits
    # equal serve's second step's up to bf16 numerics at another batch
    drift = float((d["row0"] - first_logits).abs().max()
                  / first_logits.abs().max())
    check(drift <= SERVE_ROW_DRIFT, f"decode_32k row 0 moves {drift} of the "
          f"largest logit from serve's B 1 step")
    emit(decode_line("lm_serve", "decode_32k_b8", d, drift))
    del d, first_logits
    torch.cuda.empty_cache()
    walls["decode_32k"] = time.perf_counter() - t0

    # the f32 gates
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model32 = TransformerLM(cfg32, float_params(model))
    del model
    torch.cuda.empty_cache()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        rng = np.random.default_rng(SERVE_TOKEN_SEED)
        x = torch.from_numpy(rng.integers(0, cfg.vocab,
                                          (1, XLA_SEQ))).to(dev)
        zero_launch_counts()
        with torch.no_grad():
            full = model32(x)[0][:, -1]
        cache = grow_cache(model32.prefill(x[:, :-1])[1], XLA_SEQ)
        last, cache = model32.decode_step(cache, x[:, -1])
        no_kernel("the f32 serving check")
        scale = float(full.abs().max())
        decode_err = float((last - full).abs().max())
        check(decode_err <= SERVE_DECODE_RTOL * scale,
              f"decode_step after prefill differs from the forward by "
              f"{decode_err} (limit {SERVE_DECODE_RTOL * scale})")
        del cache, full, last
        # layer 0's own q, k, v at S 4096
        x = torch.from_numpy(rng.integers(0, cfg.vocab,
                                          (1, SERVE_CHUNK_SEQ))).to(dev)
        pos = torch.arange(SERVE_CHUNK_SEQ, dtype=torch.int32,
                           device=dev)[None]
        layer = model32.layers[0]
        with torch.no_grad():
            h = rms_norm(model32.embed[x].float(), layer.ln1)
            q, k, v = attn_qkv(layer.attn, h, cfg32.attn_spec, pos,
                               cfg.rope_theta)
            mask = make_attention_mask(pos, pos, 0, causal=True)
            want = attention_xla(q, k, v, mask[:, None, None])
            chunk = {}
            for static in (False, True):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                got = attention_xla_chunked(
                    q, k, v, pos, pos, window=0, causal=True,
                    chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
                    static_positions=static)
                torch.cuda.synchronize()
                chunk[static] = (float((got - want).abs().max()),
                                 time.perf_counter() - t1)
        limit = SERVE_CHUNK_RTOL * float(want.abs().max())
        for static, (err, _) in chunk.items():
            check(err <= limit, f"chunked attention (static skip {static}) "
                  f"differs from attention_xla by {err} (limit {limit})")
        emit({"phase": "lm_serve_f32", "decode_vs_forward_err": decode_err,
              "largest_logit": scale, "decode_rtol": SERVE_DECODE_RTOL,
              "chunked_err": chunk[False][0],
              "chunked_skip_err": chunk[True][0],
              "chunked_limit": limit, "chunked_s": chunk[False][1],
              "chunked_skip_s": chunk[True][1]})
        del q, k, v, h, want, got, mask
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    del model32
    torch.cuda.empty_cache()
    walls["f32_checks"] = time.perf_counter() - t0

    # gemma3-12b: local:global windows of 1024 in prefill and decode
    t0 = time.perf_counter()
    gcfg = registry.get(SERVE_GEMMA).config
    model = TransformerLM(gcfg, device=dev, seed=LM_SEED,
                          dtype=torch.bfloat16)
    zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    r = serve(SERVE_GEMMA, False, 1, SERVE_GEMMA_PROMPT, SERVE_GEN,
              seed=LM_DATA_SEED, model=model)
    line = serve_line("gemma3_prompt_4096_b1", r, 1, SERVE_GEMMA_PROMPT,
                      SERVE_GEN, no_kernel("serve on gemma3-12b"))
    emit(dict(line, arch=SERVE_GEMMA,
              windows=sorted(set(int(w) for w in gcfg.layer_windows()))))
    del r, model
    torch.cuda.empty_cache()
    walls["gemma3"] = time.perf_counter() - t0
    emit({"phase": "lm_serve_seconds", **walls})


# --------------------------------------------------------------------------
# phase: the MoE LM (llama4-scout, mixtral), its training and the runtime
# --------------------------------------------------------------------------
# kernel names of an MoE step's parts, as the profiler reports them: the
# dispatch is the sorts (routes, capacity order) and the index kernels
# (gather into the buffer, the combine's index_add, their backward)
MOE_KERNEL_KINDS = KERNEL_KINDS[:3] + (
    ("dispatch_sort", ("radixsort", "sort")),
    ("dispatch_index", ("index", "scatter", "gather")),
    ("matmul", ("gemm", "xmma", "nvjet", "cutlass")))


@contextlib.contextmanager
def recorded_routes():
    """Every ``moe.route`` call's ``Routing`` and input, in call order,
    while the block runs (the model's own calls are unchanged)."""
    from repro_torch.models import moe
    real, calls = moe.route, []

    def route(router, xt, spec):
        r = real(router, xt, spec)
        calls.append((r, xt, router))
        return r

    moe.route = route
    try:
        yield calls
    finally:
        moe.route = real


def host_moe_check(tag, spec, p32, weights, xt, shards=1):
    """Layer 0's MoE on its own (T, d) input in f32 on the card (TF32 off;
    ``p32`` its parameters cast to f32) against a float64 host computation
    written here with numpy alone from ``weights``, the same parameters in
    the model's bf16: softmax routes (ties to the lower expert), the
    stable capacity order and its drops, SwiGLU per expert on a seeded
    sample of tokens, and the shared expert.  With ``shards`` > 1 the card
    runs ``moe_apply_local`` (the per-shard dispatch: the T tokens in
    ``shards`` blocks, each with its own capacity) and the host counts
    each block's capacity and drops apart."""
    import numpy as np
    import torch
    from repro_torch.models import moe
    T, d = xt.shape
    E, K = spec.n_experts, spec.top_k
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            rs = [moe.route(p32["router"], part, spec)
                  for part in xt.chunk(shards)]
            if shards == 1:
                out, aux = moe.moe_apply(p32, xt[None], spec)
            else:
                out, aux = moe.moe_apply_local(p32, xt[None], spec, shards)
            torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    card_idx = torch.cat([r.gate_idx for r in rs]).cpu().numpy()
    card_keep = torch.cat([r.kept_by_token() for r in rs]).cpu().numpy()
    out = out[0]
    x = xt.cpu().double().numpy()
    logits = x @ weights["router"].cpu().double().numpy()
    prob = np.exp(logits - logits.max(1, keepdims=True))
    prob /= prob.sum(1, keepdims=True)
    host_idx = np.argsort(-prob, axis=1, kind="stable")[:, :K]
    hs, cs = np.sort(host_idx, 1), np.sort(card_idx, 1)
    flips = np.where((hs != cs).any(1))[0]
    margins = [float(prob[t, hs[t]].min()
                     - prob[t, np.setdiff1d(cs[t], hs[t])].max())
               for t in flips]
    check(all(m < MOE_ROUTE_MARGIN for m in margins),
          f"{tag}: routes differ from the host's past a near tie: {margins}")
    # the host resolves each near tie the card's way, then everything
    # downstream must agree exactly
    routes = host_idx.copy()
    routes[flips] = card_idx[flips]
    gates = np.take_along_axis(prob, routes, 1)
    gates /= np.maximum(gates.sum(1, keepdims=True), 1e-9)
    A = T // shards * K
    C = int(math.ceil(A / E * spec.capacity_factor))
    keep = np.empty((T, K), bool)
    for block in np.split(np.arange(T), shards):
        se = routes[block].reshape(-1)
        order = np.argsort(se, kind="stable")
        start = np.searchsorted(se[order], np.arange(E))
        kb = np.empty(A, bool)
        kb[order] = np.arange(A) - start[se[order]] < C
        keep[block] = kb.reshape(-1, K)
    kept_host = np.zeros((T, E), bool)
    kept_card = np.zeros((T, E), bool)
    rows = np.arange(T)[:, None]
    kept_host[np.broadcast_to(rows, routes.shape)[keep], routes[keep]] = True
    kept_card[np.broadcast_to(rows, card_idx.shape)[card_keep],
              card_idx[card_keep]] = True
    drop_diff = int((kept_host != kept_card).any(1).sum())
    check(drop_diff == 0, f"{tag}: {drop_diff} tokens' drops differ from "
          f"the host's")
    gate_te = np.zeros((T, E))
    np.put_along_axis(gate_te, routes, gates, 1)

    def swiglu(xs, wg, wu, wd):
        h = xs @ wg
        return (h / (1 + np.exp(-h)) * (xs @ wu)) @ wd

    def host(w):
        return w.cpu().double().numpy()

    sample = np.sort(np.random.default_rng(MOE_SAMPLE_SEED).choice(
        T, MOE_HOST_SAMPLE, replace=False))
    want = np.zeros((len(sample), d))
    for e in range(E):
        sel = np.where(kept_host[sample, e])[0]
        if len(sel):
            y = swiglu(x[sample[sel]], host(weights["w_gate"][e]),
                       host(weights["w_up"][e]), host(weights["w_down"][e]))
            want[sel] += gate_te[sample[sel], e][:, None] * y
    if spec.shared_expert:
        sh = weights["shared"]
        want += swiglu(x[sample], host(sh["w_gate"]), host(sh["w_up"]),
                       host(sh["w_down"]))
    got = out[torch.from_numpy(sample).to(out.device)].cpu().double().numpy()
    err = float(np.abs(got - want).max())
    limit = MOE_OUT_RTOL * float(np.abs(want).max())
    check(err <= limit, f"{tag}: layer 0's MoE differs from the host's by "
          f"{err} (limit {limit})")
    line = {"phase": "moe_layer_vs_host", "arch": tag, "tokens": T,
            "shards": shards,
            "capacity": C, "route_flips": len(flips), "flip_margins": margins,
            "dropped_slots": int((~keep).sum()), "slots": T * K,
            "dropped_share": float((~keep).mean()),
            "sample_tokens": MOE_HOST_SAMPLE, "max_abs_err": err,
            "limit": limit, "aux": float(aux)}
    emit(line)
    return line


def moe_serve(tag, cfg, model, calls):
    """``serve`` at prefill_32k cut to B 1 (16 tokens), then decode_32k cut
    to B 8 (the prompt's cache in 8 rows, 16 steps); row 0 against serve's
    B 1 step, its routes at each layer beside the B 1 run's.  No kernel
    launches.  Returns the two lines."""
    import torch
    from repro_torch.launch.serve import serve
    zero = dict.fromkeys(launch_counts(), 0)
    prompt, gen = SERVE_PROMPT, SERVE_GEN
    zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    calls.clear()
    r = serve(cfg.name, False, 1, prompt, gen, seed=LM_DATA_SEED,
              model=model)
    launches = launch_counts()
    check(launches == zero, f"{tag} serve launched {launches}")
    prefill_line = dict(serve_line(f"{tag}_prefill_32k_b1", r, 1, prompt,
                                   gen, launches), phase="moe_serve")
    # serve's first decode step: the calls after the prefill's L
    L = cfg.n_layers
    b1 = [(c[0].gate_idx[0].cpu(), row0_probs(c)) for c in calls[L:2 * L]]
    first_logits = r["logits"][1, 0].float()
    calls.clear()
    d = decode_rows(model, r.pop("cache"), int(r["generated"][0, 0]),
                    prompt)
    del r
    check(d["launches"] == zero, f"{tag} decode launched {d['launches']}")
    b8 = [(c[0].gate_idx[0].cpu(), row0_probs(c)) for c in calls[:L]]
    flips = []
    for layer, ((i1, p1), (i8, _)) in enumerate(zip(b1, b8)):
        a, b = set(i1.tolist()), set(i8.tolist())
        if a != b:
            gap = float(min(p1[e] for e in a) - max(p1[e] for e in b - a))
            flips.append({"layer": layer, "b1": sorted(a), "b8": sorted(b),
                          "gap": gap})
    drift = float((d["row0"] - first_logits).abs().max()
                  / first_logits.abs().max())
    check(all(f["gap"] <= MOE_NEAR_TIE for f in flips),
          f"{tag}: row 0's routes differ between B 1 and B 8 past a near "
          f"tie: {flips}")
    check(drift <= SERVE_ROW_DRIFT or flips,
          f"{tag}: decode_32k row 0 moves {drift} of the largest logit "
          f"from serve's B 1 step, with every route equal")
    line = dict(decode_line("moe_serve", f"{tag}_decode_32k_b8", d, drift),
                row0_routes_b1=[sorted(i.tolist()) for i, _ in b1],
                row0_route_flips=flips)
    return prefill_line, line


def row0_probs(call):
    """Row 0's router probabilities of one recorded ``route`` call."""
    import torch
    _, xt, router = call
    return torch.softmax((xt[:1] @ router.to(xt.dtype)).float(),
                         -1)[0].cpu().tolist()


def moe_model_run(arch):
    """One MoE arch cut to MOE_LAYERS layers with seeded bf16 weights: two
    forwards at train_4k cut to B 2 (8 flash launches each, all wgmma),
    layer 0's MoE against the host, serving, then the flash kernels on
    layers 0 and 7's own q, k, v and the backward kernels on layer 0's.
    Returns (forward launches, flash rows, backward rows)."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import LM_SHAPES
    from repro_torch.data.tokens import TokenStreamConfig, batch_at_step
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import transformer
    from repro_torch.models.transformer import (TransformerLM, init_params,
                                                lm_loss)

    dev = torch.device("cuda")
    full = registry.get(arch).config
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS,
                              attention_impl="pallas")
    tag = arch.split("-")[0]
    shape = LM_SHAPES[LM_SHAPE]
    walls = {}
    t0 = time.perf_counter()
    model = TransformerLM(cfg, init_params(cfg, torch.Generator(
        device=dev).manual_seed(LM_SEED), dtype=cfg.dtype))
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.param_count(),
          f"{arch}: {n_params} parameters, param_count() "
          f"{cfg.param_count()}")
    tokens, labels = batch_at_step(TokenStreamConfig(
        cfg.vocab, shape.seq_len, MOE_BATCH, seed=LM_DATA_SEED), 0)
    tokens = torch.from_numpy(tokens).to(dev)
    labels = torch.from_numpy(labels).to(dev)
    torch.cuda.synchronize()
    emit({"phase": "moe_setup", "arch": arch, "n_layers": cfg.n_layers,
          "full_layers": full.n_layers, "param_count": cfg.param_count(),
          "params": n_params, "full_param_count": full.param_count(),
          "weights_gib": torch.cuda.memory_allocated() / 2**30,
          "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
          "group": cfg.n_heads // cfg.n_kv_heads,
          "experts": cfg.moe_experts, "top_k": cfg.moe_top_k,
          "window": cfg.sliding_window, "batch": MOE_BATCH,
          "seq": shape.seq_len, "seconds": time.perf_counter() - t0})

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
    L, E = cfg.n_layers, cfg.moe_experts
    t_start = time.perf_counter()
    try:
        with recorded_routes() as calls:
            for rep in range(2):
                calls.clear()
                zero_launch_counts()
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.no_grad():
                    logits, aux = model(tokens)
                    torch.cuda.synchronize()
                    fwd = time.perf_counter() - t0
                    loss, metrics = lm_loss(logits, aux, labels)
                torch.cuda.synchronize()
                launches = launch_counts()
                by_route = {"wgmma": launches["fwd_wgmma"],
                            "simt": launches["fwd_simt"]}
                main_launches += launches["fwd"]
                check(launches["fwd"] == L and by_route == {"wgmma": L,
                                                            "simt": 0},
                      f"{arch} forward launched {launches}, expected {L} "
                      f"flash launches on the wgmma route")
                check(sum(launches.values()) == 2 * L,
                      f"{arch} forward launched another kernel: {launches}")
                check(bool(torch.isfinite(logits).all()),
                      f"{arch} logits not finite")
                nll = float(metrics["nll"])
                check(abs(nll / math.log(cfg.vocab) - 1) < 0.35,
                      f"{arch} untrained nll {nll} far from ln(V)")
                check(len(calls) == L, f"{len(calls)} MoE calls for {L} "
                      f"layers")
                auxs = [float(c[0].aux) for c in calls]
                check(all(math.isfinite(a) and 0 < a <= E for a in auxs),
                      f"{arch} layer aux losses {auxs}")
                check(abs(sum(auxs) - float(aux)) <= 1e-4 * max(auxs),
                      f"{arch} forward's aux {float(aux)} is not the sum "
                      f"of its layers' {auxs}")
                dropped = [float((~c[0].keep).float().mean()) for c in calls]
                if rep == 0:
                    xt0 = calls[0][1].float()
                emit({"phase": "moe_forward", "arch": arch, "rep": rep,
                      "forward_s": fwd,
                      "tokens_per_s": MOE_BATCH * shape.seq_len / fwd,
                      "flash_launches": launches["fwd"],
                      "flash_launches_by_route": by_route,
                      "loss": float(loss), "nll": nll,
                      "ln_vocab": math.log(cfg.vocab),
                      "aux_by_layer": auxs, "dropped_share_by_layer": dropped,
                      "capacity": calls[0][0].capacity,
                      "peak_mem_gib":
                      torch.cuda.max_memory_allocated() / 2**30})
                del logits, loss, metrics
            walls["forwards"] = time.perf_counter() - t_start

            t0 = time.perf_counter()
            moe0 = model.layers[0].moe
            p16 = {k: ({n: w.detach() for n, w in moe0[k].items()}
                       if k == "shared" else moe0[k].detach())
                   for k in moe0.keys()}
            p32 = {k: ({n: w.float() for n, w in v.items()}
                       if k == "shared" else v.float())
                   for k, v in p16.items()}
            host_moe_check(tag, cfg.moe_spec, p32, p16, xt0)
            del p16, p32, xt0
            torch.cuda.empty_cache()
            walls["layer_vs_host"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            for line in moe_serve(tag, cfg, model, calls):
                emit(dict(line, arch=arch))
            walls["serve"] = time.perf_counter() - t0
    finally:
        transformer.flash_attention = kernel_call
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    check(sorted(recorded) == [0, L - 1], f"recorded layers "
          f"{sorted(recorded)}")
    rows = []
    for layer in sorted(recorded):
        q, k, v, window = recorded[layer]
        check(tuple(q.shape) == (MOE_BATCH, shape.seq_len, cfg.n_heads,
                                 cfg.head_dim), f"{arch} layer {layer} q")
        # at S 4096 mixtral's window of 4096 masks no causal pair, so SDPA
        # computes the same function
        rows.append(flash_case(f"{tag}_layer{layer}", q, k, v, window,
                               timed=layer == 0, library=layer == 0))
    q, k, v, window = recorded[0]
    g = torch.Generator(device=dev).manual_seed(LM_SEED)
    do = torch.randn(q[:1].shape, generator=g, device=dev).to(q.dtype)
    bwd_row = bwd_case(f"{tag}_layer0_b1", q[:1], k[:1], v[:1], do, window,
                       timed=True, library=False)
    del recorded, q, k, v, do
    torch.cuda.empty_cache()
    walls["kernels"] = time.perf_counter() - t0
    emit({"phase": "moe_seconds", "arch": arch, **walls})
    return main_launches, rows, [bwd_row]


def moe_train_run():
    """Three ``lm_train_step``s of mixtral at full width and 1 layer (f32
    parameters, bf16 compute, remat "full", B 2 in 2 microbatches at S
    4096), the counts set to 0 just before each step and read just after;
    the last step under the profiler.  Then ``compress_tree`` on the last
    step's gradients, on the card and on their CPU copies, and
    ``compressed_psum`` of them over the one NCCL rank.  Returns the
    launches of the three steps."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import LM_SHAPES
    from repro_torch.data.tokens import TokenStreamConfig, batch_at_step
    from repro_torch.launch import steps
    from repro_torch.models.transformer import TransformerLM, init_params
    from repro_torch.optim import adamw, grad_compression

    dev = torch.device("cuda")
    cfg = dataclasses.replace(registry.get(MOE_TRAIN_ARCH).config,
                              n_layers=MOE_TRAIN_LAYERS,
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
    before = {n: fingerprint(p) for n, p in named.items()}
    torch.cuda.synchronize()
    emit({"phase": "moe_train_setup", "arch": MOE_TRAIN_ARCH,
          "n_layers": cfg.n_layers, "params": n_params,
          "param_count": cfg.param_count(),
          "params_grads_m_v_gib": 16 * n_params / 2**30,
          "allocated_gib": torch.cuda.memory_allocated() / 2**30,
          "global_batch": TRAIN_BATCH, "microbatches": TRAIN_MICRO,
          "seq": shape.seq_len, "remat": cfg.remat,
          "seconds": time.perf_counter() - t0})
    stream = TokenStreamConfig(cfg.vocab, shape.seq_len, TRAIN_BATCH,
                               seed=LM_DATA_SEED)
    L = cfg.n_layers
    want = dict.fromkeys(launch_counts(), 0)
    want.update(fwd=2 * TRAIN_MICRO * L, fwd_wgmma=2 * TRAIN_MICRO * L,
                dq=TRAIN_MICRO * L, dq_wgmma=TRAIN_MICRO * L,
                dkv=TRAIN_MICRO * L, dkv_wgmma=TRAIN_MICRO * L)
    total = dict.fromkeys(want, 0)
    # keep the last step's gradients, as the step hands them to AdamW
    real_apply, kept = steps.adamw.apply_updates, {}

    def keeping_apply(cfg_, params, grads, st):
        if profiled:
            kept.update(grads)
        return real_apply(cfg_, params, grads, st)

    steps.adamw.apply_updates = keeping_apply
    losses = []
    try:
        for step in range(TRAIN_STEPS):
            tokens, labels = batch_at_step(stream, step)
            tokens = torch.from_numpy(tokens).to(dev)
            labels = torch.from_numpy(labels).to(dev)
            torch.cuda.reset_peak_memory_stats()
            zero_launch_counts()
            torch.cuda.synchronize()
            profiled = step == TRAIN_STEPS - 1
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU,
                                torch.profiler.ProfilerActivity.CUDA],
                    record_shapes=False) if profiled \
                    else contextlib.nullcontext() as prof:
                t0 = time.perf_counter()
                metrics = steps.lm_train_step(model, opt_cfg, state, tokens,
                                              labels)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = launch_counts()
            check(launches == want, f"moe train step {step} launched "
                  f"{launches}, expected {want}")
            for key in total:
                total[key] += launches[key]
            m = {k: float(v) for k, v in metrics.items()}
            losses.append(m["loss"])
            check(all(math.isfinite(x) for x in m.values()),
                  f"moe train step {step} metrics not finite: {m}")
            check(m["grad_norm"] > 0 and m["aux"] > 0,
                  f"moe train step {step}: {m}")
            if step == 0:
                check(abs(m["nll"] / math.log(cfg.vocab) - 1) < 0.35,
                      f"untrained nll {m['nll']} far from ln(V)")
            emit({"phase": "moe_train", "arch": MOE_TRAIN_ARCH, "step": step,
                  "step_s": wall,
                  "tokens_per_s": TRAIN_BATCH * shape.seq_len / wall,
                  "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                  "profiled": profiled, "launches": launches, **m})
            if profiled:
                emit({"phase": "moe_train_profile", "step": step,
                      "wall_ms": wall * 1e3,
                      **device_time_by_kind(prof, wall * 1e3,
                                            MOE_KERNEL_KINDS)})
    finally:
        steps.adamw.apply_updates = real_apply
    check(int(state["step"]) == TRAIN_STEPS,
          f"AdamW step count {int(state['step'])}")
    unchanged = [n for n, p in named.items() if fingerprint(p) == before[n]]
    check(not unchanged, f"parameters unchanged by training: {unchanged}")
    emit({"phase": "moe_train_summary", "losses": losses, "launches": total})
    grads = dict(kept)
    kept.clear()
    del model, state, named, metrics
    torch.cuda.empty_cache()

    # compression on the card against the same call on the CPU copies
    t0 = time.perf_counter()
    fb = grad_compression.init_feedback(grads)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    q, s, new_fb = grad_compression.compress_tree(grads, fb)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t1
    del fb
    worst, mismatched = 0.0, []
    for name in grads:
        rec = grad_compression.decompress(q[name], s[name]) + new_fb[name]
        worst = max(worst, float((rec - grads[name].float()).abs().max()))
        del rec
        gc = grads[name].cpu()
        cq, cs, cfb = grad_compression.compress(
            gc, torch.zeros(gc.shape, dtype=torch.float32))
        if not (torch.equal(cq, q[name].cpu())
                and torch.equal(cs, s[name].cpu())
                and torch.equal(cfb, new_fb[name].cpu())):
            mismatched.append(name)
        del gc, cq, cs, cfb
    check(not mismatched, f"compress_tree on the card differs from the CPU "
          f"at {mismatched}")
    check(worst <= MOE_COMPRESS_ATOL, f"decompress + feedback misses the "
          f"corrected gradient by {worst}")
    n = sum(g.numel() for g in grads.values())
    emit({"phase": "moe_compress", "leaves": len(grads), "elements": n,
          "grad_bytes": 4 * n, "int8_bytes": n, "card_s": card_s,
          "feedback_max_err": worst, "bit_equal_to_cpu": True,
          "largest_scale": max(float(v) for v in s.values()),
          "seconds": time.perf_counter() - t0})
    del q, s, new_fb
    group_psum_case(grads)
    del grads
    torch.cuda.empty_cache()
    return total


def moe_runner_run():
    """``TrainRunner`` on the card over ``lm_train_step`` (llama4's smoke
    config): a simulated preemption before step MOE_RUNNER_CRASH of
    MOE_RUNNER_STEPS, a resume from the last checkpoint, and an
    uninterrupted run; checkpoints under ``build/`` (removed after)."""
    import shutil
    import torch
    from repro_torch.configs import registry
    from repro_torch.data.tokens import TokenStreamConfig, batch_at_step
    from repro_torch.launch.steps import lm_train_step
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault_tolerance import RunnerConfig, TrainRunner

    cfg = registry.get(MOE_RUNNER_ARCH).smoke_config
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                            total_steps=MOE_RUNNER_STEPS)
    stream = TokenStreamConfig(cfg.vocab, 64, 4, seed=LM_DATA_SEED)
    root = ROOT / "build" / "moe_runner"
    shutil.rmtree(root, ignore_errors=True)

    def runner(name):
        model = TransformerLM(cfg, device="cuda", seed=LM_SEED)
        named = dict(model.named_parameters())
        fresh = {n: p.detach().clone() for n, p in named.items()}

        def init_state():
            with torch.no_grad():
                for n, p in named.items():
                    p.copy_(fresh[n])
            return {"params": named, "opt": adamw.init_state(named, opt)}

        def step_fn(state, step):
            with torch.no_grad():
                for n, p in named.items():
                    if state["params"][n] is not p:
                        p.copy_(state["params"][n])
            lm_train_step(model, opt, state["opt"],
                          *batch_at_step(stream, step))
            return {"params": named, "opt": state["opt"]}

        return TrainRunner(RunnerConfig(str(root / name), ckpt_every=3,
                                        max_steps=MOE_RUNNER_STEPS),
                           init_state, step_fn)

    t0 = time.perf_counter()
    try:
        try:
            runner("a").run(crash_at_step=MOE_RUNNER_CRASH)
            check(False, "the runner did not stop at the preemption")
        except RuntimeError as e:
            check("simulated preemption" in str(e), f"runner raised {e}")
        resumed = runner("a").run()
        clean = runner("b").run()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    worst, bit_equal = 0.0, True
    for part in ("params",):
        for n, p in clean[part].items():
            diff = float((resumed[part][n] - p).detach().abs().max())
            top = float(p.abs().max())
            worst = max(worst, diff / top if top else diff)
            bit_equal &= torch.equal(resumed[part][n], p)
            check(diff <= MOE_RUNNER_RTOL * top, f"resumed {n} differs "
                  f"from the uninterrupted run's by {diff}")
    check(int(resumed["opt"]["step"]) == MOE_RUNNER_STEPS, "runner steps")
    emit({"phase": "moe_preemption", "arch": MOE_RUNNER_ARCH,
          "steps": MOE_RUNNER_STEPS, "crash_at_step": MOE_RUNNER_CRASH,
          "largest_rel_diff": worst, "bit_equal": bit_equal,
          "seconds": time.perf_counter() - t0})


def moe_lm_phase():
    """The ``moe_lm`` phase: llama4-scout then mixtral (forward, layer 0
    against the host, serving, their kernels), mixtral training with the
    gradients' compression, and the preemption runner.  Returns the flash
    launches by phase and the kernel rows."""
    import torch
    torch.cuda.empty_cache()
    fwd_launches, fwd_rows, bwd_rows = 0, [], []
    for arch in MOE_ARCHS:
        n, rows, brows = moe_model_run(arch)
        fwd_launches += n
        fwd_rows += rows
        bwd_rows += brows
    train = moe_train_run()
    moe_runner_run()
    return fwd_launches, train, fwd_rows, bwd_rows


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
    del model, state, named
    torch.cuda.empty_cache()
    rows = [dht_gather_case("sasrec_train_history", table, bags.reshape(-1),
                            timed=True)]
    rows[0]["wrapper_kernels"] = one_pass(table, bags.reshape(-1))
    # serve_bulk's candidate read: one call's 32,768 users x 1024
    # candidates into the trained table, 6.7 GB of rows
    cands = candidates(shapes["serve_bulk"].global_batch // REC_BULK_CALLS)
    rows.append(dht_gather_case("sasrec_serve_bulk_candidates", table,
                                cands.reshape(-1), timed=True))
    del cands
    torch.cuda.empty_cache()
    return by_cell, rows, table, bags


def embag_sectors(rows, row_bytes):
    """The 32-byte sectors the distinct rows ``rows > 0`` of the (B, L)
    ``rows`` span, and the same summed over bags, each bag's distinct rows
    counted once in it.  The first is what the card must move at least
    (beside the bound's bytes); the second what HBM serves when no row
    stays in L2 from one bag to the next.  A sector two rows share counts
    once; the sectors inside a row are its own."""
    import torch

    def spans(r):
        return r * row_bytes // 32, ((r + 1) * row_bytes - 1) // 32

    valid = rows > 0
    first, last = spans(torch.unique(rows[valid]).long())
    total = torch.unique(torch.cat([first, last])).numel() + int(
        (last - first - 1).clamp(min=0).sum())
    # per bag: sort each bag's rows, padding (-1) first; a row is new when
    # it differs from its left neighbour, and shares its first sector with
    # the bag's previous row when that row's last sector is the same
    r = torch.sort(torch.where(valid, rows, -1).long(), dim=1).values
    first, last = spans(r)
    new = r > 0
    new[:, 1:] &= r[:, 1:] != r[:, :-1]
    shared = torch.zeros_like(new)
    if r.shape[1] > 1:
        prev_last = torch.where(new[:, :-1], last[:, :-1], -1)
        prev_last = torch.cummax(prev_last, dim=1).values
        shared[:, 1:] = new[:, 1:] & (prev_last == first[:, 1:])
    per_bag = int(torch.where(new, last - first + 1, 0).sum()) - int(
        shared.sum())
    return total, per_bag


def embag_case(name, table, ids, timed):
    """The ``embedding_bag`` kernel (twice) against its plain version on
    one input, bit for bit; its layout, its bound and the 32-byte sectors
    its distinct rows span, and, when ``timed``, kernel, plain and library
    times (the library call where every id is in range)."""
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
    rows = torch.unique(ids[valid].clamp(max=V - 1)).long()
    es = table.element_size()
    # least bytes: each distinct row a valid id names read once, the ids
    # read once, the sums written once; one f32 add per valid element
    io_bytes = B * L * 4 + B * D * es
    nbytes = rows.numel() * D * es + io_bytes
    flops = int(valid.sum()) * D
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / PEAK_FLOPS["float32"] * 1e3
    sectors, bag_sectors = embag_sectors(ids.clamp(max=V - 1), D * es)
    err = 0.0
    if out.numel():
        err = float((out.double() - want.double()).abs().max())
    row = {"shape": name, "V": V, "D": D, "B": B, "L": L,
           "dtype": str(table.dtype).replace("torch.", ""),
           "layout": dict(zip(("chunk_bytes", "lanes_per_bag",
                               "bags_per_warp"),
                              kernel.layout(D, es, table.data_ptr(),
                                            out.data_ptr()))),
           "valid_ids": int(valid.sum()), "rows_read": rows.numel(),
           "max_abs_err": err, "bytes": nbytes, "flops": flops,
           "bound_ms": max(byte_ms, op_ms),
           "bound_by": "operations" if op_ms > byte_ms else "bytes",
           "sector_bytes": sectors * 32 + io_bytes,
           "bag_sector_bytes": bag_sectors * 32 + io_bytes}
    if timed:
        buf = torch.empty_like(out)
        row.update(ms=time_ms(lambda: kernel.launch(table, ids, buf)),
                   plain_ms=time_ms(lambda: embedding_bag_ref(table, ids),
                                    reps=5, warmup=1),
                   library_ms=None)
        if bool(((ids >= 0) & (ids < V)).all()):
            lib = F.embedding_bag(ids, table, mode="sum", padding_idx=0)
            row.update(
                library_ms=time_ms(lambda: F.embedding_bag(
                    ids, table, mode="sum", padding_idx=0)),
                library="F.embedding_bag(mode='sum', padding_idx=0)",
                library_max_abs_diff=float((lib.float()
                                            - out.float()).abs().max()))
    return row


def embedding_bag_phase(table, bags):
    """``embedding_bag`` on SASRec's trained item table with step 0's
    65,536 histories as bags: one call of the op, the counts set to 0 just
    before and read just after; then the kernel against its plain version
    there, in bf16, on uniform ids of the same shape, at the JAX package's
    test shapes and at edge cases.  Returns the op's launches and the
    rows."""
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
    # the histories draw each bag from one 64-item cluster; uniform ids
    # over [1, V) of the same shape spread every bag over the table
    uniform = torch.from_numpy(np.random.default_rng(EMBAG_UNIFORM_SEED)
                               .integers(1, table.shape[0], tuple(bags.shape),
                                         dtype=np.int32)).to(dev)
    rows = [embag_case("sasrec_train_history", table, bags, timed=True),
            embag_case("sasrec_train_history_bf16", table.bfloat16(), bags,
                       timed=True),
            embag_case("uniform_ids", table, uniform, timed=True),
            embag_case("uniform_ids_bf16", table.bfloat16(), uniform,
                       timed=True)]
    del uniform
    # tests/test_kernels.py's shapes and draw, then D 37, L 0 and 1, a
    # ragged B, ids below 0 and past the table, L 300 (many windows, in
    # passes at D 130), D 4, 8 and 1 (each chunk width and packed warp)
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
# --------------------------------------------------------------------------
# phase: the launch layer (dry-run, sharded step, elastic restore, examples)
# --------------------------------------------------------------------------
# the dry-run's worker processes (CPU only: every cell is built on meta)
DRYRUN_JOBS, DRYRUN_TIMEOUT_S = 8, 600
# PERF.md section 4's bf16 weights of the MoE LMs at full depth, GB
FULL_DEPTH_WEIGHT_GB = {"llama4-scout-17b-a16e": 215.5, "mixtral-8x22b": 281.3}
# qwen3-4b at full width, its depth cut so two states (plain and sharded,
# f32 parameters and AdamW) fit beside one step's activations
LAUNCH_LAYERS, LAUNCH_BATCH = 4, 2
LAUNCH_LOCAL_SHARDS = (2, 4)
EXAMPLE_RUNS = (("torch_quickstart", []), ("torch_graph_analytics", []),
                ("torch_train_lm", ["--tiny", "--steps", "20"]),
                ("torch_serve_lm", []))


def dryrun_start():
    """Start ``python -m repro_torch.launch.dryrun --all`` on the host (no
    card: ``CUDA_VISIBLE_DEVICES`` empty), its records into ``build/``."""
    out = ROOT / "build" / "dryrun.jsonl"
    out.parent.mkdir(exist_ok=True)
    out.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--jobs", str(DRYRUN_JOBS), "--out", str(out)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return proc, out, time.perf_counter()


def dryrun_finish(proc, out, t0):
    """Wait for the dry-run and hold its records: 37 cells ok and the 3 the
    registry skips, with its reasons; each LM's parameters
    ``param_count()`` plus the qk-norm scales and QKV biases it leaves
    out; llama4's and mixtral's bf16 weights at full depth PERF.md's."""
    from repro_torch.configs import registry
    try:
        stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SmokeFailure(f"the dry-run ran past {DRYRUN_TIMEOUT_S} s")
    for line in stdout.splitlines():
        print(f"[dryrun] {line}", flush=True)
    check(proc.returncode == 0, f"the dry-run exited {proc.returncode}: "
          f"{stderr[-2000:]}")
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    cells = list(registry.all_cells())
    check([(r["arch"], r["shape"]) for r in recs]
          == [(a, s) for a, s, _ in cells], "dry-run cells out of order")
    for r, (_, _, reason) in zip(recs, cells):
        want = "skipped" if reason else "ok"
        check(r["status"] == want and r.get("reason") == reason,
              f"dry-run {r['arch']} {r['shape']}: {r['status']} "
              f"{r.get('error')}")
    for r in recs:
        entry = registry.get(r["arch"])
        if r["status"] != "ok" or entry.family != "lm":
            continue
        cfg = entry.config
        extra = cfg.n_layers * ((2 * cfg.head_dim if cfg.qk_norm else 0)
                                + ((cfg.n_heads + 2 * cfg.n_kv_heads)
                                   * cfg.head_dim if cfg.qkv_bias else 0))
        check(r["params"] == cfg.param_count() + extra,
              f"{r['arch']}: {r['params']} parameters")
        if r["arch"] in FULL_DEPTH_WEIGHT_GB:
            check(round(r["param_bytes"] / 1e9, 1)
                  == FULL_DEPTH_WEIGHT_GB[r["arch"]],
                  f"{r['arch']}: {r['param_bytes']} bytes of bf16 weights")
    emit({"phase": "launch_dryrun",
          "ok": sum(r["status"] == "ok" for r in recs),
          "skipped": sum(r["status"] == "skipped" for r in recs),
          "fits_h100_80gb": [f"{r['arch']}/{r['shape']}" for r in recs
                             if r.get("fits_h100_80gb")],
          "weights_gb": {a: round(next(r["param_bytes"] for r in recs
                                       if r["arch"] == a
                                       and r["status"] == "ok") / 1e9, 1)
                         for a in FULL_DEPTH_WEIGHT_GB},
          "seconds": time.perf_counter() - t0})
    return recs


def dryrun_vs_card():
    """qwen3-4b at full width and LAUNCH_LAYERS layers (the train_4k cell,
    bf16 parameters, f32 AdamW, cut to B LAUNCH_BATCH): the dry-run's
    parameter and optimizer bytes against ``memory_allocated`` after the
    real build on the card, equal; its peak beside the real step's
    ``max_memory_allocated`` (no gate)."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.data.tokens import TokenStreamConfig, batch_at_step
    from repro_torch.launch import dryrun, steps
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.optim import adamw
    rec = dryrun.run_cell(LM_ARCH, LM_SHAPE,
                          overrides={"n_layers": LAUNCH_LAYERS},
                          shape_overrides={"global_batch": LAUNCH_BATCH})
    check(rec["status"] == "ok", f"dry-run of the cut cell: {rec}")
    cfg = dataclasses.replace(registry.get(LM_ARCH).config,
                              n_layers=LAUNCH_LAYERS, remat="dots",
                              attention_impl="pallas")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = TransformerLM(cfg, device="cuda", seed=LM_SEED,
                          dtype=torch.bfloat16)
    opt = adamw.init_state(model, adamw.AdamWConfig())
    torch.cuda.synchronize()
    state = torch.cuda.memory_allocated() - base
    check(state == rec["state_alloc_bytes"], f"the card allocated {state} "
          f"bytes of state, the dry-run counts {rec['state_alloc_bytes']}")
    tokens, labels = batch_at_step(TokenStreamConfig(
        cfg.vocab, registry.get(LM_ARCH).shapes[LM_SHAPE].seq_len,
        LAUNCH_BATCH, seed=LM_DATA_SEED), 0)
    torch.cuda.reset_peak_memory_stats()
    steps.lm_train_step(model, adamw.AdamWConfig(), opt, tokens, labels)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    emit({"phase": "launch_dryrun_vs_card", "arch": LM_ARCH,
          "n_layers": LAUNCH_LAYERS, "batch": LAUNCH_BATCH,
          "state_bytes": state, "dryrun_state_bytes": rec["state_alloc_bytes"],
          "param_bytes": rec["param_bytes"], "opt_bytes": rec["opt_bytes"],
          "peak_bytes": peak, "dryrun_peak_bytes": rec["peak_bytes"],
          "dryrun_flops": rec["flops"], "model_flops": rec["model_flops"]})
    del model, opt
    torch.cuda.empty_cache()


def launch_mesh():
    """A (1, 1) ("data", "model") mesh over one NCCL rank (its address on
    this host), and the sharding context on it."""
    from repro_torch.launch.mesh import MeshShape, make_mesh
    from repro_torch.models.transformer import ShardCtx
    nccl_rank()
    mesh = make_mesh(MeshShape((1, 1), ("data", "model")), "cuda")
    return ShardCtx(mesh, "data")


def bits_equal(a, b) -> bool:
    import torch
    full = getattr(a, "full_tensor", None)
    return torch.equal(full() if full else a, b)


def launch_sharded(sctx):
    """qwen3-4b at full width, LAUNCH_LAYERS layers, f32 parameters, bf16
    compute, remat "full", B LAUNCH_BATCH at S 4096: the loss and one
    ``lm_train_step`` with ``sctx`` bit-equal to the plain port's (metrics,
    every parameter, AdamW's moments), the flash launches equal and all on
    the wgmma route.  Returns the sharded step's launches and the plain
    model's state (for the restore)."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.data.tokens import TokenStreamConfig, batch_at_step
    from repro_torch.launch import steps
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(registry.get(LM_ARCH).config,
                              n_layers=LAUNCH_LAYERS, attention_impl="pallas",
                              remat="full")
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=100)
    t0 = time.perf_counter()
    plain = TransformerLM(cfg, device="cuda", seed=LM_SEED)
    sharded = TransformerLM(cfg, device="cuda", seed=LM_SEED)
    opt_p, opt_s = adamw.init_state(plain), adamw.init_state(sharded)
    steps.place_lm(sharded, opt_s, sctx)
    tokens, labels = batch_at_step(TokenStreamConfig(
        cfg.vocab, registry.get(LM_ARCH).shapes[LM_SHAPE].seq_len,
        LAUNCH_BATCH, seed=LM_DATA_SEED), 0)
    with torch.no_grad():
        loss_p = plain.loss_fn(tokens, labels)[0]
        loss_s = sharded.loss_fn(tokens, labels, sctx=sctx)[0]
    check(bits_equal(loss_s, loss_p), f"sharded loss "
          f"{float(loss_s.full_tensor())} != plain {float(loss_p)}")
    zero_launch_counts()
    t1 = time.perf_counter()
    met_p = steps.lm_train_step(plain, opt_cfg, opt_p, tokens, labels)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t1
    plain_launches = launch_counts()
    zero_launch_counts()
    t1 = time.perf_counter()
    met_s = steps.lm_train_step(sharded, opt_cfg, opt_s, tokens, labels,
                                sctx=sctx)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    launches = launch_counts()
    check(launches == plain_launches, f"sharded launches {launches} != "
          f"plain {plain_launches}")
    check(launches["fwd"] > 0 and launches["fwd_simt"] == 0
          and launches["dq_simt"] == 0 and launches["dkv_simt"] == 0,
          f"the sharded step's flash launches: {launches}")
    check(all(torch.equal(met_s[k], met_p[k]) for k in met_p),
          f"sharded metrics {met_s} != plain {met_p}")
    named = dict(sharded.named_parameters())
    unequal = [n for n, p in plain.named_parameters()
               if not bits_equal(named[n].detach(), p.detach())
               or not bits_equal(opt_s["m"][n], opt_p["m"][n])
               or not bits_equal(opt_s["v"][n], opt_p["v"][n])]
    check(not unequal, f"sharded state differs from plain at {unequal[:5]}")
    emit({"phase": "launch_sharded", "arch": LM_ARCH, "mesh": "1x1",
          "n_layers": LAUNCH_LAYERS, "batch": LAUNCH_BATCH,
          "loss": float(met_s["loss"]), "bit_equal": True,
          "launches": launches, "step_s": step_s, "plain_step_s": plain_s,
          "placements": {n: str(p.placements) for n, p in
                         list(named.items())[:3]},
          "seconds": time.perf_counter() - t0})
    del sharded, opt_s
    torch.cuda.empty_cache()
    return launches, plain, opt_p


def launch_moe(sctx):
    """One mixtral layer at full width (bf16, B 2, S 4096): the forward
    with ``moe_local_dispatch`` under ``sctx`` (one data shard: the
    per-shard dispatch at dp_shards 1) bit-equal to the plain model's
    ``moe_apply``; then ``moe_apply_local`` at LAUNCH_LOCAL_SHARDS shards
    in f32 on that layer's MoE against the float64 host computation of the
    per-shard dispatch (routes, drops, outputs on sampled tokens)."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.data.tokens import TokenStreamConfig, batch_at_step
    from repro_torch.launch import steps
    from repro_torch.models.transformer import TransformerLM, init_params
    arch = "mixtral-8x22b"
    cfg = dataclasses.replace(registry.get(arch).config, n_layers=1,
                              attention_impl="pallas")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        LM_SEED), torch.bfloat16)
    plain = TransformerLM(cfg, params)
    local = TransformerLM(dataclasses.replace(cfg, moe_local_dispatch=True),
                          params)
    steps.place_lm(local, None, sctx)
    tokens, _ = batch_at_step(TokenStreamConfig(
        cfg.vocab, 4096, 2, seed=LM_DATA_SEED), 0)
    captured, ffn = {}, plain._ffn

    def record_ffn(layer, h, sctx=None):
        captured["h"] = h      # the MoE's input, layer 0's normed tokens
        return ffn(layer, h, sctx)

    plain._ffn = record_ffn
    with torch.no_grad():
        logits_p, aux_p = plain(tokens)
        logits_l, aux_l = local(tokens, sctx=sctx)
        check(bits_equal(logits_l, logits_p) and bits_equal(aux_l, aux_p),
              "mixtral's layer with the per-shard dispatch at one shard "
              "differs from moe_apply")
    del logits_p, logits_l, local
    h = captured.pop("h")
    moe0 = plain.layers[0].moe
    p16 = {k: moe0[k].detach() for k in moe0.keys()}
    p32 = {k: v.float() for k, v in p16.items()}
    xt = h.reshape(-1, h.shape[-1]).float()
    lines = [host_moe_check(f"mixtral_local_{n}", cfg.moe_spec, p32, p16,
                            xt, shards=n) for n in LAUNCH_LOCAL_SHARDS]
    emit({"phase": "launch_moe", "arch": arch, "layers": 1,
          "bit_equal_at_one_shard": True,
          "shards": {str(n): {k: line[k] for k in ("capacity", "route_flips",
                                                   "dropped_share",
                                                   "max_abs_err", "limit")}
                     for n, line in zip(LAUNCH_LOCAL_SHARDS, lines)},
          "seconds": time.perf_counter() - t0})
    del plain, params, p16, p32, xt, h
    torch.cuda.empty_cache()


def launch_restore(sctx, plain, opt):
    """The plain model's trained state checkpointed and restored with
    ``shardings=`` onto the mesh, bit-equal; then ``TrainRunner`` with
    ``shardings=`` over the sharded step (llama4's smoke config) preempted
    and resumed, bit-equal to an uninterrupted sharded run."""
    import shutil
    import torch
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.configs import registry
    from repro_torch.data.tokens import TokenStreamConfig, batch_at_step
    from repro_torch.launch import sharding, steps
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault_tolerance import RunnerConfig, TrainRunner
    root = ROOT / "build" / "launch_restore"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        named = {n: p.detach() for n, p in plain.named_parameters()}
        state = {"params": named, "m": opt["m"]}
        ckpt.save(str(root / "elastic"), 1, state)
        t_save = time.perf_counter() - t0
        place = sharding.lm_param_shardings(sctx.mesh, named)
        restored, _ = ckpt.restore(str(root / "elastic"), state,
                                   shardings={"params": place, "m": place})
        for part in ("params", "m"):
            for n, t in restored[part].items():
                check(tuple(t.placements) == place[n].placements
                      and bits_equal(t, state[part][n]),
                      f"restored {part} {n} differs")
        del restored, state, named
        torch.cuda.empty_cache()
        t_restore = time.perf_counter() - t0 - t_save

        cfg = registry.get(MOE_RUNNER_ARCH).smoke_config
        opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                                    total_steps=MOE_RUNNER_STEPS)
        stream = TokenStreamConfig(cfg.vocab, 64, 4, seed=LM_DATA_SEED)

        def runner(name):
            model = TransformerLM(cfg, device="cuda", seed=LM_SEED)
            mopt = adamw.init_state(model, opt_cfg)
            steps.place_lm(model, mopt, sctx)
            params = dict(model.named_parameters())
            fresh = {n: p.detach().clone() for n, p in params.items()}
            shards = sharding.lm_param_shardings(sctx.mesh, params)

            def init_state():
                with torch.no_grad():
                    for n, p in params.items():
                        p.copy_(fresh[n])
                return {"params": params, "opt": adamw.init_state(
                    params, opt_cfg)}

            def step_fn(st, i):
                with torch.no_grad():
                    for n, p in params.items():
                        if st["params"][n] is not p:
                            p.copy_(st["params"][n])
                steps.lm_train_step(model, opt_cfg, st["opt"],
                                    *batch_at_step(stream, i), sctx=sctx)
                return {"params": params, "opt": st["opt"]}

            return TrainRunner(
                RunnerConfig(str(root / name), ckpt_every=3,
                             max_steps=MOE_RUNNER_STEPS), init_state,
                step_fn, shardings={"params": shards,
                                    "opt": {"m": shards, "v": shards,
                                            "step": None}})

        try:
            runner("a").run(crash_at_step=MOE_RUNNER_CRASH)
            check(False, "the runner did not stop at the preemption")
        except RuntimeError as e:
            check("simulated preemption" in str(e), f"runner raised {e}")
        resumed = runner("a").run()
        clean = runner("b").run()
        unequal = [n for n, p in clean["params"].items()
                   if not bits_equal(resumed["params"][n].detach(),
                                     p.detach().full_tensor())]
        check(not unequal, f"the resumed sharded run differs at {unequal}")
        check(int(resumed["opt"]["step"]) == MOE_RUNNER_STEPS, "runner steps")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "launch_restore", "arch": LM_ARCH,
          "n_layers": LAUNCH_LAYERS, "save_s": t_save,
          "restore_s": t_restore, "runner_arch": MOE_RUNNER_ARCH,
          "runner_steps": MOE_RUNNER_STEPS,
          "runner_crash_at": MOE_RUNNER_CRASH, "bit_equal": True,
          "seconds": time.perf_counter() - t0})


def launch_examples():
    """Each of the port's examples (``examples/torch_*.py``) on the card at
    its small size, its ``main`` called here."""
    import importlib.util
    import shutil
    import torch
    ckpt_dir = ROOT / "build" / "launch_train_lm"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    walls = {}
    try:
        for name, args in EXAMPLE_RUNS:
            if name == "torch_train_lm":
                args = args + ["--ckpt-dir", str(ckpt_dir)]
            spec = importlib.util.spec_from_file_location(
                name, ROOT / "examples" / f"{name}.py")
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            t0 = time.perf_counter()
            out = module.main(args)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            check(out is not None, f"{name} returned nothing")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    emit({"phase": "launch_examples", "seconds": walls})


def sdpa_bwd_rows():
    """SDPA's backward at G 5 (40/8 heads) and G 6 (48/8, the window of
    4096 masking nothing at S 4096) on ``flash_bwd``'s inputs: (1, 4096,
    H, 128) bf16, causal, seeded q, k, v and dO."""
    import torch
    rows = []
    for H in (40, 48):
        g = torch.Generator(device="cuda").manual_seed(LM_SEED)
        q, k, v, do = (torch.randn((1, 4096, h, 128), generator=g,
                                   device="cuda").to(torch.bfloat16)
                       for h in (H, 8, 8, H))
        ms, backend = sdpa_backward_ms(q, k, v, do)
        rows.append({"phase": "launch_sdpa_bwd", "G": H // 8, "heads": H,
                     "kv_heads": 8, "S": 4096, "D": 128, "ms": ms,
                     "backend": backend})
        emit(rows[-1])
        del q, k, v, do
    return rows


def launch_phase():
    """The launch layer: (a) the dry-run of every cell (on the host, in the
    background of the card's work), its state bytes against the card;
    (b) the sharded step on one NCCL rank; (c) elastic restore; (d) the
    examples; (e) SDPA's backward at G 5 and 6.  Returns the sharded
    step's launches."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    proc, out, t_dry = dryrun_start()
    try:
        sctx = launch_mesh()
        launches, plain, opt = launch_sharded(sctx)
        launch_restore(sctx, plain, opt)
        del plain, opt
        launch_moe(sctx)
        dryrun_vs_card()
        launch_examples()
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    dryrun_finish(proc, out, t_dry)
    sdpa_bwd_rows()
    if dist.is_initialized():
        dist.destroy_process_group()
    emit({"phase": "launch_seconds", "seconds": time.perf_counter() - t0})
    return launches


def build_kernels():
    """Build every kernel from its source: one ``nvcc`` each, all started
    together."""
    from repro_torch.kernels.dht_gather import kernel as dht_gather_kernel
    from repro_torch.kernels.embedding_bag import kernel as embag_kernel
    from repro_torch.kernels.flash_attention import bwd as flash_bwd
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.segment_matmul import kernel as seg_kernel
    t0 = time.perf_counter()
    with ThreadPoolExecutor(7) as pool:
        futures = {"dht_gather": pool.submit(dht_gather_kernel.build, True),
                   "flash_attention_fwd_wgmma": pool.submit(
                       flash_kernel.build, "wgmma", True),
                   "flash_attention_fwd": pool.submit(flash_kernel.build,
                                                      "simt", True),
                   "flash_attention_bwd_wgmma": pool.submit(
                       flash_bwd.build, "wgmma", True),
                   "flash_attention_bwd": pool.submit(flash_bwd.build,
                                                      "simt", True),
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
            if any(w in line for w in ("registers", "spill",
                                       "entry function", "(C75")):
                print(f"[{name}] {line.strip()}", flush=True)
    # the backward's wgmma kernels, dq and dk/dv at D 64 and 128: ptxas
    # reports each, and none spills
    bwd_log = logs["flash_attention_bwd_wgmma"].splitlines()
    check(sum("entry function" in line for line in bwd_log) == 4
          and all("0 bytes spill stores, 0 bytes spill loads" in line
                  for line in bwd_log if "spill" in line),
          "the backward wgmma kernels' ptxas report shows a spill or a "
          "missing kernel")

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

    k = 2 ** (CYCLE_LOG2 - 1)
    cycles = [(f"two_cycles_2^{CYCLE_LOG2 - 1}", gen.two_cycles(k), 2),
              (f"one_cycle_2^{CYCLE_LOG2}", gen.one_cycle(2 * k), 1)]
    launches, solve_rows, outputs, solves, cc_reads = engine_phase(
        g, gw, cycles)
    check(launches > 0, "the main path launched no dht_gather kernel")
    rows = solve_rows + rows
    serving_launches = {"sessions": sessions_phase(gw, cycles, outputs)}
    t0 = time.perf_counter()
    fleets = serving_fleets()
    emit({"phase": "fleets", "seconds": time.perf_counter() - t0,
          **{name: [[f.n, f.m] for f in fleet]
             for name, fleet in fleets.items()}})
    serving_launches["solve_many_sequential"] = solve_many_phase(fleets)
    serving_launches["async"] = async_phase(
        fleets["plain"], gen.rmat(16, RMAT_DEG, seed=RMAT_SEED))
    check(serving_launches["sessions"] > 0
          and serving_launches["async"] > 0,
          f"a serving phase launched no dht_gather kernel: "
          f"{serving_launches}")
    t0 = time.perf_counter()
    routed_dht_level(cc_reads)
    t1 = time.perf_counter()
    serving_launches["routed"], many_want = routed_phase(
        g, gw, cycles, outputs, solves, fleets["plain"])
    t2 = time.perf_counter()
    serving_launches["eager"] = eager_phase(g, outputs, solves)
    emit({"phase": "routed_and_eager_seconds", "routed_dht": t1 - t0,
          "routed": t2 - t1, "eager": time.perf_counter() - t2})
    check(serving_launches["eager"] == CC_LAUNCHES_PER_SOLVE,
          f"the eager phase launched dht_gather "
          f"{serving_launches['eager']} times")
    serving_launches["dht_group"] = dht_group_phase(
        cc_reads, g, gw, cycles, outputs, fleets["plain"], many_want)
    del fleets, cycles, outputs, solves, cc_reads, many_want

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
    t0 = time.perf_counter()
    lm_serve_phase()
    serve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    moe_fwd, moe_train, moe_rows, moe_bwd_rows = moe_lm_phase()
    for row in moe_rows:
        emit({"phase": "kernel", "name": "flash_attention_fwd", **row})
    for row in moe_bwd_rows:
        emit({"phase": "kernel", "name": "flash_attention_bwd", **row})
    check(moe_fwd > 0 and moe_train["dq"] > 0 and moe_train["dkv"] > 0,
          "the MoE path launched no flash kernel")
    flash_rows += moe_rows
    bwd_rows += moe_bwd_rows
    moe_s = time.perf_counter() - t0

    gnn_launches, seg_rows, gnn_blocks = gnn_phase()
    for row in seg_rows:
        emit({"phase": "kernel", "name": "segment_matmul", **row})
    check(gnn_launches["segment_matmul"] > 0,
          "the GNN path launched no segment_matmul kernel")
    seg_row = seg_rows[0]   # layer 0's own inputs, the forward's call
    t0 = time.perf_counter()
    models_launches = gnn_models_phase(gnn_blocks)
    del gnn_blocks
    emit({"phase": "new_phase_seconds", "lm_serve": serve_s,
          "moe_lm": moe_s, "gnn_models": time.perf_counter() - t0})
    check(models_launches > 0, "the GIN cells launched no segment_matmul")

    rec_launches, rec_rows, item_table, bags = rec_phase()
    for row in rec_rows:
        emit({"phase": "kernel", "name": "dht_gather", **row})
    check(all(n > 0 for n in rec_launches.values()),
          f"a SASRec cell launched no dht_gather kernel: {rec_launches}")
    embag_launches, embag_rows = embedding_bag_phase(item_table, bags)
    for row in embag_rows:
        emit({"phase": "kernel", "name": "embedding_bag", **row})
    check(embag_launches > 0, "the embedding_bag path launched no kernel")
    embag_row = embag_rows[0]   # the trained table, step 0's histories
    del item_table, bags

    launch = launch_phase()
    check(launch["fwd"] > 0 and launch["dq"] > 0 and launch["dkv"] > 0,
          "the sharded step launched no flash kernel")

    main_row = rows[0]   # the first cc solve's root-label read
    flash_row = flash_rows[0]   # the first layer's own q, k, v
    emit({"kernels": [{
        "name": "dht_gather", "route": "cuda",
        "source": "src/repro_torch/kernels/dht_gather/csrc/dht_gather.cu",
        "replaces": "src/repro/kernels/dht_gather/kernel.py:28",
        "launches": launches + sum(serving_launches.values())
        + sum(rec_launches.values()),
        "launches_by_phase": {"ampc_solves": launches, **serving_launches,
                              **rec_launches},
        "max_abs_err": max(r["max_abs_err"] for r in rows + rec_rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": "bytes",
        "library_ms": main_row["library_ms"], "library": main_row["library"],
        "shapes": rows + rec_rows}, {
        "name": "flash_attention_fwd", "route": "cuda",
        "kernel_route": flash_row["kernel_route"],
        "source": flash_source("fwd", flash_row["kernel_route"]),
        "replaces": "src/repro/kernels/flash_attention/kernel.py:25",
        "launches": flash_launches + train_launches["fwd"] + moe_fwd
        + moe_train["fwd"] + launch["fwd"],
        "launches_by_phase": {"lm_forward": flash_launches,
                              "lm_train": train_launches["fwd"],
                              "moe_forward": moe_fwd,
                              "moe_train": moe_train["fwd"],
                              "launch_sharded": launch["fwd"]},
        "launches_by_route": {"wgmma": flash_launches + moe_fwd
                              + train_launches["fwd_wgmma"]
                              + moe_train["fwd_wgmma"]
                              + launch["fwd_wgmma"],
                              "simt": train_launches["fwd_simt"]
                              + moe_train["fwd_simt"] + launch["fwd_simt"]},
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
        "kernel_route": bwd_row["kernel_route"],
        "source": flash_source("bwd", bwd_row["kernel_route"]),
        "replaces": f"src/repro/kernels/flash_attention/bwd.py:{line}",
        "launches": train_launches[kname] + moe_train[kname]
        + launch[kname],
        "launches_by_phase": {"lm_train": train_launches[kname],
                              "moe_train": moe_train[kname],
                              "launch_sharded": launch[kname]},
        "launches_by_route": {r: train_launches[f"{kname}_{r}"]
                              + moe_train[f"{kname}_{r}"]
                              + launch[f"{kname}_{r}"]
                              for r in ("wgmma", "simt")},
        "max_abs_err": max(r[f"{g}_max_abs_err"] for r in bwd_rows
                           for g in grads),
        "max_err_over_limit": max(r[f"{g}_err_over_limit"]
                                  for r in bwd_rows for g in grads),
        "ms": bwd_row[f"{kname}_ms"], "plain_ms": bwd_row["plain_ms"],
        "plain_computes": "dq, dk and dv together",
        "earlier_ms": bwd_row.get(f"{kname}_simt_ms"),
        "earlier": "the SIMT kernel (flash_attention_bwd.cu) on the same "
                   "inputs, this run",
        "bound_ms": bwd_row[f"{kname}_bound_ms"],
        "bound_by": bwd_row[f"{kname}_bound_by"],
        "library_ms": bwd_row["library_ms"],
        "library": f"SDPA backward ({bwd_row['library_backend']}), dq, dk "
                   f"and dv together",
        # the split's tensor work stays in the flash_bwd phase's lines
        "shapes": [{key: x for key, x in r.items() if key != "tensor_work"}
                   for r in bwd_rows]}
        for kname, line, grads in (("dq", 34, ("dq",)),
                                   ("dkv", 80, ("dk", "dv")))] + [{
        "name": "segment_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/segment_matmul/csrc/"
                  "segment_matmul.cu",
        "replaces": "src/repro/kernels/segment_matmul/kernel.py:22",
        "launches": gnn_launches["segment_matmul"] + models_launches,
        "launches_by_phase": {"gnn_minibatch_lg":
                              gnn_launches["segment_matmul"],
                              "gnn_models": models_launches},
        "max_abs_err": max(r["max_abs_err"] for r in seg_rows),
        "max_err_over_limit": max(r["err_over_limit"] for r in seg_rows),
        "ms": seg_row["ms"], "plain_ms": seg_row["plain_ms"],
        "bound_ms": seg_row["bound_ms"], "bound_by": seg_row["bound_by"],
        "library_ms": seg_row["library_ms"], "library": seg_row["library"],
        "shapes": seg_rows}, {
        "name": "embedding_bag", "route": "cuda", "design": EMBAG_DESIGN,
        "source": "src/repro_torch/kernels/embedding_bag/csrc/"
                  "embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/kernel.py:16",
        "launches": embag_launches,
        "max_abs_err": max(r["max_abs_err"] for r in embag_rows),
        "ms": embag_row["ms"], "plain_ms": embag_row["plain_ms"],
        "bound_ms": embag_row["bound_ms"], "bound_by": embag_row["bound_by"],
        "library_ms": embag_row["library_ms"],
        "library": embag_row["library"],
        "shapes": [{k: v for k, v in r.items() if k not in EMBAG_COUNTED}
                   for r in embag_rows]}]})
    emit({"host_reads_total": rounds.HOST_READS})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
