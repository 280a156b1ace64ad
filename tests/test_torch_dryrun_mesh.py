"""The sharded dry-run: one device of a mesh traced as rank 0 of a process
group whose collectives move no data (``launch/collectives.py``, the
counterpart of the JAX package's ``launch/hlo.py``, and the mesh half of
``launch/dryrun.py``).

  (a) ``collective_wire`` and ``roofline_terms`` equal the reference's
      ``hlo._collective_wire`` and ``hlo.roofline_terms``, given the
      reference's TPU rates;
  (b) ``LocalCounter`` over a 4-rank fake group on ``meta`` records what it
      records in every rank of a real 4-process ``gloo`` run of the same
      step: the same collectives (kind, group size, result bytes, in
      order) and the same FLOPs and bytes; rank 0's and rank 3's traces
      are equal.  The smoke configs run in f32 with the plain attention
      (``attention_impl="xla"``, masked below 2048 positions) on both
      sides: the flash op's ``meta`` branch counts its FLOPs by formula
      where its CPU version runs matmuls the counter sees, so with it the
      two op streams would differ by construction;
  (c) against the reference's ``analyze_hlo`` of the same cell compiled
      for a (2, 2) mesh of host devices: per-device FLOPs, for qwen3-4b
      cut to 2 layers (train_4k, prefill_32k, decode_32k), mixtral cut to
      2 layers (long_500k) and for the 14 GNN and SASRec cells of
      ``GRAPH_REF_CELLS`` (gin-tu's by-design products apart, by formula);
  (d) at a (1, 1) mesh the trace's FLOPs are the one-card ``measure``'s;
      at 16x16 the state bytes are ``_device_bytes``'s;
  (e) ``run_cell`` at 16x16 and 2x16x16 and the ``--mesh`` CLI: the LM
      cells and every GNN and SASRec cell; the 14 decode records at full
      depth (the sharded decode) each within 80 GB and within the
      reference's own dry-run figures (``DECODE_REFERENCE``); the seven
      train and prefill records at 16x16, full depth, within the
      reference's (``TRAIN_PREFILL_REFERENCE``);
  and ``FilledCollectives`` writes every collective's output.

A fake group is process-wide, so every trace runs in a spawned process of
its own; the ``gloo`` ranks are spawned with a join timeout.
"""
import dataclasses
import json
import multiprocessing
import os
import re
import socket
import subprocess
import sys
import textwrap
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import registry
from repro_torch.launch import collectives as col
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape

JOIN_TIMEOUT_S = 300
BATCH = (4, 16)
AXES = ("data", "model")
# (mesh sizes, arch) of (b)
RUNS = [(sizes, arch) for arch in ("qwen3-4b", "mixtral-8x22b")
        for sizes in ((2, 2), (1, 4), (4, 1))]
# (c): the port's per-device FLOPs outside attention against the
# reference's.  Prefill computes the same products on both sides (equal to
# REL_PREFILL).  In training every projection's backward runs on the
# rank's weight blocks, as GSPMD keeps them (qwen3-4b's count equals the
# reference's); REL_TRAIN bounds the decode and graph cells' too.
REL_PREFILL, REL_TRAIN = 1e-6, 0.06


# ------------------------------------------------------------- (a) formulas
@pytest.mark.parametrize("p", [2, 4, 16, 256, 512])
@pytest.mark.parametrize("kind", ["all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_collective_wire_equals_the_reference(kind, p):
    from repro.launch import hlo
    for nbytes in (0, 1, 4096, 12_345_678_912):
        assert col.collective_wire(kind, nbytes, p) \
            == hlo._collective_wire(kind, nbytes, p)


@pytest.mark.parametrize("flops,hbm,wire", [
    (4e15, 1e12, 1e10), (1e12, 5e12, 1e10), (1e12, 1e11, 5e12),
    (0.0, 0.0, 0.0)], ids=["compute", "memory", "collective", "zero"])
def test_roofline_terms_equal_the_reference(flops, hbm, wire):
    """Given the reference's TPU rates (one link rate for every group) and
    the same FLOPs, bytes and wire bytes, every term and ratio is the
    reference's; the port names the FLOPs and bytes ``flops_per_device``
    and ``bytes_per_device`` and has no ``unknown_trip_whiles``."""
    from repro.launch import hlo
    ops = {"all-gather": 3, "all-reduce": 2}
    ref = hlo.roofline_terms(hlo.HloAnalysis(
        flops, hbm, hlo.CollectiveStats(dict(ops), wire, wire / 2)), 256,
        6.0e15)
    got = col.roofline_terms(
        flops, hbm, 6.0e15, hlo.PEAK_FLOPS, 256,
        collectives=col.CollectiveStats(dict(ops), wire, wire / 2,
                                        wire_bytes_by_link={"nic": wire}),
        hbm_bytes_per_s=hlo.HBM_BW,
        link_bytes_per_s={"nvlink": hlo.ICI_BW, "nic": hlo.ICI_BW})
    names = {"hlo_flops_per_device": "flops_per_device",
             "hlo_bytes_per_device": "bytes_per_device"}
    for key, want in ref.items():
        if key == "unknown_trip_whiles":
            continue
        assert got[names.get(key, key)] == want, key


def test_one_card_roofline_has_no_collective_term():
    got = col.roofline_terms(2e15, 1e12, 1e12, 989e12)
    assert got["t_collective_s"] == 0.0
    assert got["coll_wire_bytes_per_device"] == 0.0
    assert got["collective_ops"] == {}
    assert got["dominant"] == "compute"


def test_links_follow_nodes_of_eight_ranks():
    assert col.link_of(range(8)) == "nvlink"
    assert col.link_of([8, 9, 15]) == "nvlink"
    assert col.link_of([0, 8]) == "nic"
    assert col.link_of(range(0, 256, 16)) == "nic"
    assert col.link_of(range(16, 32)) == "nic"


# ------------------------------------------- (b) the trace and a real run
def _cfg(arch):
    return dataclasses.replace(registry.get(arch).smoke_config,
                               dtype=torch.float32, attention_impl="xla")


def _trace(sizes, arch, device, sites=False, **cfg_fields):
    """One train step of ``arch``'s smoke config on ``sizes`` under
    ``LocalCounter``: (collectives as (kind, group size, bytes), flops,
    hbm bytes), or with ``sites`` their sites."""
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tr
    from repro_torch.optim import adamw
    mesh = lmesh.make_mesh(MeshShape(sizes, AXES), "cpu")
    cfg = dataclasses.replace(_cfg(arch), **cfg_fields)
    model = tr.TransformerLM(cfg, device=device)
    opt = adamw.init_state(model)
    sctx = tr.ShardCtx(mesh, "data")
    steps.place_lm(model, opt, sctx)
    rng = np.random.default_rng(0)
    tokens, labels = (torch.from_numpy(rng.integers(0, cfg.vocab, BATCH)
                                       .astype(np.int32)).to(device)
                      for _ in range(2))
    counter = col.LocalCounter()
    counter.track(model, opt)
    with counter:
        steps.lm_train_step(model, adamw.AdamWConfig(), opt, tokens, labels,
                            sctx=sctx)
    if sites:
        return sorted({d["site"] for d in counter.details})
    return ([(d["kind"], d["group_size"], d["bytes"])
             for d in counter.details], counter.flops, counter.hbm_bytes)


def _fake_side():
    """(b)'s traces on ``meta``, then the FilledCollectives check, over
    one 4-rank fake group."""
    dryrun.fake_group(4)
    traces = {f"{s}-{a}": _trace(s, a, "meta") for s, a in RUNS}
    traces["sites"] = _trace((2, 2), "mixtral-8x22b", "meta", sites=True,
                             n_microbatches=2, remat="dots")
    return json.loads(json.dumps(traces)), _filled_run()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gloo_worker(rank, world, port, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=rank, world_size=world)
    try:
        traces = {f"{s}-{a}": _trace(s, a, "cpu") for s, a in RUNS}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"gloo-{rank}.json"), "w") as f:
        json.dump(traces, f)


def _spawn_gloo(out_dir, world=4):
    ctx = mp.start_processes(_gloo_worker, args=(world, _free_port(),
                                                 out_dir),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the gloo ranks hung past {JOIN_TIMEOUT_S} s")
    return [json.load(open(os.path.join(out_dir, f"gloo-{r}.json")))
            for r in range(world)]


@pytest.mark.parametrize("run", RUNS, ids=lambda r: f"{r[0][0]}x{r[0][1]}-"
                         f"{r[1]}")
def test_fake_group_trace_equals_a_real_gloo_run(work, run):
    fake, gloo = work["fake"], work["gloo"]
    key = f"{run[0]}-{run[1]}"
    got, want = fake[key], gloo[0][key]
    assert got[0], "no collective recorded"
    assert got[0] == want[0]
    assert got[1] == want[1] and got[2] == want[2]
    assert gloo[3][key] == gloo[0][key], "rank 3's trace differs from 0's"
    sizes = run[0]
    assert {g for _, g, _ in got[0]} <= {sizes[0], sizes[1], 4}


def test_sites_follow_microbatches_and_recomputation(work):
    """A step of two microbatches with the "dots" recomputation: each
    collective's site names the model's module, " (bw)" in the backward,
    and the function of the port or the autograd node behind it."""
    sites = work["fake"]["sites"]
    assert any(s.startswith("TransformerLM:TransformerLM._sharded_moe")
               for s in sites), sites
    assert any(s.startswith("TransformerLM (bw):") and "/" in s
               for s in sites), sites
    assert any(s.startswith("Global:") for s in sites), sites


# --------------------------------------------------- (c) against the reference
# the reference's cell compiled for a (2, 2) mesh of 4 host devices and
# ``analyze_hlo``d (argv: "arch/shape"; the LM cut to 2 layers); an LM's
# attention products (the only dots with batch dimensions) counted apart:
# the same text analysed with them made custom calls
REFERENCE_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, re, sys
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs.registry import get
    from repro.launch.hlo import analyze_hlo
    from repro.launch.specs import build_lowerable

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    batched = re.compile(r"(=\\s*\\S+\\s+)dot(\\(.*lhs_batch_dims=\\{\\d)")
    out = {}
    for cell in sys.argv[1:]:
        arch, shape = cell.split("/")
        lm = get(arch).family == "lm"
        low = build_lowerable(arch, shape, mesh,
                              overrides={"n_layers": 2} if lm else None)
        text = low.lower(mesh).compile().as_text()
        a = analyze_hlo(text)
        b = analyze_hlo(batched.sub(r"\\1custom-call\\2", text)) if lm \\
            else a
        out[cell] = {"flops": a.flops, "attention": a.flops - b.flops,
                     "ops": a.collectives.ops,
                     "wire": a.collectives.wire_bytes}
    print(json.dumps(out))
""")
REF_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
# (c)'s arch of each shape: qwen3-4b's, long_500k's mixtral's (qwen3-4b
# skips it)
REF_ARCHS = {"long_500k": "mixtral-8x22b"}


def _ref_cell(shape):
    return f"{REF_ARCHS.get(shape, 'qwen3-4b')}/{shape}"


# the reference's own dry-run of the decode cells (``python -m
# repro.launch.dryrun --arch A --shape S --mesh both`` on the CPU):
# argument_bytes + temp_bytes, coll_wire_bytes_per_device and
# flops_per_device of each record, which the sharded decode's record must
# keep within PEAK_OVER_REF, WIRE_OVER_REF and FLOPS_OVER_REF of
DECODE_REFERENCE = {
    ("qwen3-4b", "decode_32k", "16x16"):
        (8831611632, 38047821440, 13685948416),
    ("qwen3-4b", "decode_32k", "2x16x16"):
        (4471231120, 19375498560, 6842974208),
    ("gemma3-12b", "decode_32k", "16x16"):
        (23412987128, 99371707904, 24649924608),
    ("gemma3-12b", "decode_32k", "2x16x16"):
        (11848240784, 50723344256, 12324962304),
    ("qwen2.5-32b", "decode_32k", "16x16"):
        (16006772416, 71886629376, 64196444160),
    ("qwen2.5-32b", "decode_32k", "2x16x16"):
        (8138585168, 38633046016, 32098222080),
    ("llama4-scout-17b-a16e", "decode_32k", "16x16"):
        (13460108648, 51852876800, 41807052800),
    ("llama4-scout-17b-a16e", "decode_32k", "2x16x16"):
        (6871649888, 26844040960, 20933017600),
    ("mixtral-8x22b", "decode_32k", "16x16"):
        (3957800152, 8529356032, 50233737216),
    ("mixtral-8x22b", "decode_32k", "2x16x16"):
        (2006329232, 4827405056, 25137512448),
    ("gemma3-12b", "long_500k", "16x16"):
        (3029186088, 12175719536, 1702526976),
    ("gemma3-12b", "long_500k", "2x16x16"):
        (2957934960, 6544812420, 1253916672),
    ("mixtral-8x22b", "long_500k", "16x16"):
        (2247204632, 66701704, 1119436800),
    ("mixtral-8x22b", "long_500k", "2x16x16"):
        (1130818784, 40693620, 565223424),
}
PEAK_OVER_REF, WIRE_OVER_REF, FLOPS_OVER_REF = 1.5, 1.0, 1.25
# the reference's train and prefill records at 16x16, which its own
# dry-run raises on: ``scripts/reference_mesh_figures.py`` (its
# ``build_lowerable`` compiled on a 16x16 mesh of 256 host devices, Auto
# axes): argument + temp bytes (+ output bytes for prefill, whose cache is
# an output), ``analyze_hlo``'s wire and FLOPs a device, held as
# ``DECODE_REFERENCE``'s are
TRAIN_PREFILL_REFERENCE = {
    ("llama4-scout-17b-a16e", "train_4k", "16x16"):
        (213990665356, 3616465012291.0, 644961817067520.0),
    ("mixtral-8x22b", "train_4k", "16x16"):
        (324217336156, 9866373778422.0, 1616201562193920.0),
    ("qwen3-4b", "train_4k", "16x16"):
        (72350953516, 400863261714.5, 143381577596928.0),
    ("gemma3-12b", "train_4k", "16x16"):
        (142857524268, 854090476803.5, 348510826266624.0),
    ("qwen2.5-32b", "train_4k", "16x16"):
        (256225154764, 1507685957285.0, 983955532677120.0),
    ("llama4-scout-17b-a16e", "prefill_32k", "16x16"):
        (44106637056, 1217681136640.0, 400463009300480.0),
    ("mixtral-8x22b", "prefill_32k", "16x16"):
        (80217759320, 3486735400960.0, 571831996121088.0),
}
TRAIN_PREFILL_CELLS = list(TRAIN_PREFILL_REFERENCE)
DECODE_CELLS = [(a, s, m) for a, s in (
    ("gemma3-12b", "decode_32k"), ("qwen2.5-32b", "decode_32k"),
    ("qwen3-4b", "decode_32k"), ("llama4-scout-17b-a16e", "decode_32k"),
    ("mixtral-8x22b", "decode_32k"), ("gemma3-12b", "long_500k"),
    ("mixtral-8x22b", "long_500k")) for m in ("16x16", "2x16x16")]
# (c): the GNN and SASRec cells held against the reference's analysis
GRAPH_REF_CELLS = (
    ("gcn-cora", "full_graph_sm"), ("gcn-cora", "ogb_products"),
    ("gin-tu", "full_graph_sm"), ("gin-tu", "minibatch_lg"),
    ("gin-tu", "molecule"), ("gin-tu", "ogb_products"),
    ("schnet", "molecule"), ("schnet", "ogb_products"),
    ("mace", "molecule"), ("mace", "ogb_products"),
    ("sasrec", "serve_p99"), ("sasrec", "serve_bulk"),
    ("sasrec", "train_batch"), ("sasrec", "retrieval_cand"))
GRAPH_ARCHS = ("gcn-cora", "gin-tu", "schnet", "mace", "sasrec")


def _port_records(cells):
    """The records of ``cells`` in turn, in this process."""
    return {key: dryrun.run_cell(arch, shape, mesh=mesh, overrides=ov)
            for key, (arch, shape, mesh, ov) in cells.items()}


TWO = {"n_layers": 2}


def _graph_records(mesh, archs):
    return {(mesh, a, s): (a, s, mesh, None) for a in archs
            for s in registry.get(a).shapes}


# the port's records of (c), (d) and (e), in processes of about the same
# work
RECORD_GROUPS = (
    {("ref", "train_4k"): ("qwen3-4b", "train_4k", MeshShape((2, 2), AXES),
                           TWO),
     ("2x16x16",): ("qwen3-4b", "train_4k", "2x16x16", TWO),
     ("one-mesh",): ("qwen3-4b", "train_4k", MeshShape((1, 1), AXES), TWO),
     ("one",): ("qwen3-4b", "train_4k", "one", TWO)},
    {("ref", "prefill_32k"): ("qwen3-4b", "prefill_32k",
                              MeshShape((2, 2), AXES), TWO),
     **{("16x16", a, s): (a, s, "16x16", TWO)
        for a in ("qwen3-4b", "mixtral-8x22b")
        for s in ("train_4k", "prefill_32k")}},
    # the GNN and SASRec records: (c)'s at (2, 2), then (e)'s every cell
    # at 16x16 and 2x16x16, in three processes of about the same work
    {**{("ref", a, s): (a, s, MeshShape((2, 2), AXES), None)
        for a, s in GRAPH_REF_CELLS},
     **_graph_records("16x16", ("gcn-cora", "sasrec"))},
    {**_graph_records("16x16", ("gin-tu", "schnet", "mace")),
     **_graph_records("2x16x16", ("gin-tu", "sasrec"))},
    _graph_records("2x16x16", ("gcn-cora", "schnet", "mace")),
    # (e)'s train and prefill records at full depth, in two processes
    {("full",) + c: c[:2] + (c[2], None) for c in TRAIN_PREFILL_CELLS
     if c[0] in ("llama4-scout-17b-a16e", "qwen3-4b")
     or c[1] == "prefill_32k"},
    {("full",) + c: c[:2] + (c[2], None) for c in TRAIN_PREFILL_CELLS
     if c[0] not in ("llama4-scout-17b-a16e", "qwen3-4b")
     and c[1] == "train_4k"},
    # (c)'s decode records at (2, 2), then (e)'s 14 at full depth
    {("ref", "decode_32k"): ("qwen3-4b", "decode_32k",
                             MeshShape((2, 2), AXES), TWO),
     **{("decode",) + c: c[:2] + (c[2], None) for c in DECODE_CELLS[:7]}},
    {("ref", "long_500k"): ("mixtral-8x22b", "long_500k",
                            MeshShape((2, 2), AXES), TWO),
     **{("decode",) + c: c[:2] + (c[2], None) for c in DECODE_CELLS[7:]}})


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Everything the process tests read, started together: the
    reference's analysis of (c) in a subprocess, the fake side of (b) and
    the port's records in spawned processes, the gloo world of (b)."""
    out = str(tmp_path_factory.mktemp("dryrun_mesh"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in [env.get("PYTHONPATH")] if p])
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_SCRIPT,
         *[_ref_cell(shape) for shape in REF_SHAPES],
         *[f"{a}/{shape}" for a, shape in GRAPH_REF_CELLS]], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        with ProcessPoolExecutor(1 + len(RECORD_GROUPS), mp_context=(
                multiprocessing.get_context("spawn")),
                max_tasks_per_child=1) as pool:
            fake = pool.submit(_fake_side)
            groups = [pool.submit(_port_records, g) for g in RECORD_GROUPS]
            got = {"gloo": _spawn_gloo(out)}
            got["fake"], got["filled"] = fake.result(timeout=JOIN_TIMEOUT_S)
            for g in groups:
                got.update(g.result(timeout=JOIN_TIMEOUT_S))
        stdout, stderr = ref.communicate(timeout=JOIN_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, stderr[-3000:]
    for group in RECORD_GROUPS:
        for k in group:
            assert got[k]["status"] == "ok", (k, got[k].get("traceback"))
    got["reference"] = json.loads(stdout.strip().splitlines()[-1])
    return got


@pytest.mark.parametrize("shape", REF_SHAPES)
def test_per_device_flops_agree_with_the_reference(work, shape):
    """Outside attention the per-device FLOPs agree within ``REL_PREFILL``
    or ``REL_TRAIN``.  Attention is set apart on each side: the port's
    flash kernels (training) and chunked attention (prefill) count their
    FLOPs by formula (``flops_kernels``), the reference's XLA attention is
    its batched dots.  Prefill runs the same chunked attention on both
    sides, so there the whole counts agree too; in training the flash
    kernels compute the causal pairs, XLA all of them.  A decode step
    (qwen3-4b's decode_32k, mixtral's long_500k) computes its attention
    with products the counter sees on both sides: its whole count agrees
    within ``REL_TRAIN``.  Both sides' collectives are printed: XLA and
    DTensor choose different ones."""
    ref, port = work["reference"][_ref_cell(shape)], work[("ref", shape)]
    attention = sum(port["flops_kernels"].values())
    port_rest = port["flops"] - attention
    ref_rest = ref["flops"] - ref["attention"]
    print(json.dumps({
        "shape": shape, "port_flops": port["flops"],
        "port_attention": attention, "ref_flops": ref["flops"],
        "ref_attention": ref["attention"], "rest_ratio": port_rest / ref_rest,
        "ratio": port["flops"] / ref["flops"],
        "port_collectives": port["collectives"]["ops"],
        "port_wire": port["collectives"]["wire_bytes"],
        "ref_collectives": ref["ops"], "ref_wire": ref["wire"],
        "wire_ratio": port["collectives"]["wire_bytes"] / ref["wire"]}))
    if port["kind"] == "decode":
        assert attention == 0
        assert abs(port["flops"] - ref["flops"]) <= REL_TRAIN * ref["flops"]
        return
    rel = REL_PREFILL if shape == "prefill_32k" else REL_TRAIN
    assert abs(port_rest - ref_rest) <= rel * ref_rest
    if shape == "prefill_32k":
        assert abs(port["flops"] - ref["flops"]) <= rel * ref["flops"]
        assert attention == ref["attention"]


# ---------------------------------------------------------- (d) consistency
def test_one_device_mesh_counts_the_one_card_flops(work):
    mesh, one = work[("one-mesh",)], work[("one",)]
    assert mesh["flops"] == one["flops"]
    assert mesh["flops_kernels"] == one["flops_kernels"]
    assert mesh["state_alloc_bytes"] == one["state_alloc_bytes"]
    assert mesh["collectives"]["ops"] == {}
    assert mesh["roofline"]["t_collective_s"] == 0.0


@pytest.mark.parametrize("arch", ["qwen3-4b", "mixtral-8x22b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_state_bytes_equal_the_placements_count(work, arch, shape):
    """The traced rank's parameter and AdamW bytes (its local shards) are
    ``_device_bytes`` of the same placements reckoned from the mesh's
    shape alone."""
    rec = work[("16x16", arch, shape)]
    assert rec["param_bytes"] == rec["placement_bytes"]["param_bytes"] > 0
    assert rec["opt_bytes"] == rec["placement_bytes"]["opt_bytes"]
    assert (rec["opt_bytes"] > 0) == (shape == "train_4k")
    assert rec["chips"] == 256 and rec["rank"] == 0


# ----------------------------------------------------- (e) production meshes
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_production_meshes_trace_ok(work, mesh):
    rec = (work[("16x16", "qwen3-4b", "train_4k")] if mesh == "16x16"
           else work[("2x16x16",)])
    assert rec["mesh"] == mesh
    assert rec["chips"] == (256 if mesh == "16x16" else 512)
    groups = rec["collectives"]["groups"]
    assert groups["data"]["ops"].get("all-gather", 0) > 0
    assert set(groups) <= {"pod", "data", "model"}
    assert all(g["link"] == "nic" for g in groups.values())
    assert rec["collectives"]["wire_bytes"] > 0
    roof = rec["roofline"]
    assert roof["t_collective_s"] > 0 and roof["collective_ops"]
    assert rec["peak_bytes"] >= rec["state_alloc_bytes"] > 0
    assert len(rec["collectives"]["top_sites"]) == dryrun.TOP_SITES


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ["gcn-cora", "sasrec"])
def test_gnn_and_sasrec_cells_are_skipped_on_a_mesh(work, arch, mesh):
    """(The name is from when these records were skipped.)  Every record
    of ``arch``'s family at ``mesh`` (the four GNN models, or SASRec) is
    ok: the step traced under a ``ShardCtx`` as one device, its state
    bytes (parameters, and AdamW's for the training kinds) those of the
    placements reckoned from the mesh's shape alone, its collectives on
    the mesh's dimensions, a three-term roofline at the f32 peak."""
    family = registry.get(arch).family
    archs = [a for a in GRAPH_ARCHS if registry.get(a).family == family]
    for a in archs:
        for shape in registry.get(a).shapes:
            rec = work[(mesh, a, shape)]
            assert rec["status"] == "ok" and rec["mesh"] == mesh, rec
            assert "reason" not in rec
            assert rec["chips"] == (256 if mesh == "16x16" else 512)
            assert rec["param_bytes"] \
                == rec["placement_bytes"]["param_bytes"] > 0
            assert rec["opt_bytes"] == rec["placement_bytes"]["opt_bytes"]
            train = rec["kind"] in dryrun.TRAIN_KINDS
            # two f32 moments a parameter and the step counter
            assert rec["opt_bytes"] == (2 * rec["param_bytes"] + 4
                                        if train else 0)
            assert rec["peak_bytes"] >= rec["state_alloc_bytes"] > 0
            assert rec["fits_h100_80gb"]
            assert rec["roofline"]["peak_flops"] == dryrun.H100_FLOPS[
                "float32"]
            assert set(rec["collectives"]["groups"]) <= {
                "pod", "data", "model"}
            assert rec["collectives"]["wire_bytes"] > 0
            if a == "gin-tu":
                assert rec["flops_kernels"]["segment_matmul"] > 0
            if a == "sasrec":
                assert rec["bytes_kernels"]["dht_gather"] > 0


@pytest.mark.parametrize("cell", DECODE_CELLS, ids="-".join)
def test_decode_records_fit_a_device(work, cell):
    """Each LM decode record at 16x16 and 2x16x16, full depth: the
    sharded decode's rank holds its parameter and cache shards (state
    bytes those of the placements reckoned from the mesh's shape, plus
    the cache's), its peak fits 80 GB and stays within ``PEAK_OVER_REF``
    of the reference's arg+temp bytes, its wire within ``WIRE_OVER_REF``
    of the reference's and its FLOPs within ``FLOPS_OVER_REF`` of the
    reference's (``DECODE_REFERENCE``); no group is larger than a mesh
    axis."""
    rec = work[("decode",) + cell]
    peak, wire, flops = DECODE_REFERENCE[cell]
    print(json.dumps({"cell": "/".join(cell), "peak": rec["peak_bytes"],
                      "ref_peak": peak,
                      "wire": rec["collectives"]["wire_bytes"],
                      "ref_wire": wire, "flops": rec["flops"],
                      "ref_flops": flops}))
    assert rec["kind"] == "decode" and rec["mesh"] == cell[2]
    assert rec["fits_h100_80gb"] and rec["peak_bytes"] < dryrun.H100_HBM_BYTES
    assert rec["param_bytes"] == rec["placement_bytes"]["param_bytes"] > 0
    assert rec["state_alloc_bytes"] >= rec["param_bytes"] \
        + rec["cache_bytes"] > rec["param_bytes"]
    assert rec["peak_bytes"] <= PEAK_OVER_REF * peak
    assert rec["collectives"]["wire_bytes"] <= WIRE_OVER_REF * wire
    assert rec["flops"] <= FLOPS_OVER_REF * flops
    assert set(rec["collectives"]["groups"]) <= {"pod", "data", "model"}
    assert rec["collectives"]["ops"].get("all-to-all", 0) == 0


@pytest.mark.parametrize("cell", TRAIN_PREFILL_CELLS, ids="-".join)
def test_train_and_prefill_records_keep_the_reference_placements(work,
                                                                  cell):
    """Each LM train and prefill record at 16x16, full depth, against the
    reference's (``TRAIN_PREFILL_REFERENCE``): the rank holds its
    parameter (and AdamW) shards, the experts and the table stay split,
    and its peak, wire and FLOPs are within ``PEAK_OVER_REF``,
    ``WIRE_OVER_REF`` and ``FLOPS_OVER_REF`` of the reference's."""
    rec = work[("full",) + cell]
    peak, wire, flops = TRAIN_PREFILL_REFERENCE[cell]
    print(json.dumps({"cell": "/".join(cell), "peak": rec["peak_bytes"],
                      "ref_peak": peak,
                      "wire": rec["collectives"]["wire_bytes"],
                      "ref_wire": wire, "flops": rec["flops"],
                      "ref_flops": flops}))
    assert rec["kind"] == cell[1].split("_")[0] and rec["mesh"] == cell[2]
    assert rec["param_bytes"] == rec["placement_bytes"]["param_bytes"] > 0
    assert rec["opt_bytes"] == rec["placement_bytes"]["opt_bytes"]
    assert rec["peak_bytes"] <= PEAK_OVER_REF * peak
    assert rec["collectives"]["wire_bytes"] <= WIRE_OVER_REF * wire
    assert rec["flops"] <= FLOPS_OVER_REF * flops
    assert set(rec["collectives"]["groups"]) <= {"data", "model"}


def _gin_by_design(shape_name, chips=4):
    """(segment_matmul's FLOPs, every by-design FLOP) of gin-tu's cell as
    one device of ``chips``: the port computes a layer as ``(1 + eps) (x @
    W1) + segment_matmul(x, nbr, W1)`` (plus, where the cell has overflow
    edges, the hub rows times W1), the reference as one product of the
    summed rows.  On M = N / chips node rows, a layer of input width D and
    F = d_hidden: the kernel's M K D slot sums and 2 M D F product, its
    2 M D F weight gradient and, past layer 0, its 2 M D F input gradient;
    the hub rows' product, weight gradient and (past layer 0) input
    gradient, 2 M D F each; less the reference's input gradient at layer
    0 (2 M D F), which its eps needs and the port's (a scale of x @ W1)
    does not."""
    from repro_torch.launch.specs import _gnn_sizes, gin_table_sizes
    entry = registry.get("gin-tu")
    cfg = entry.config
    N, E, _, d_feat = _gnn_sizes(entry.shapes[shape_name], chips)
    K, over, _ = gin_table_sizes(N, E)
    M, F = N // chips, cfg.d_hidden
    kernel = extra = 0
    for layer in range(cfg.n_layers):
        D = d_feat if layer == 0 else F
        prod = 2 * M * D * F
        backward = 1 + (layer > 0)
        kernel += M * K * D + prod
        extra += M * K * D + prod * (1 + backward)
        if over:
            extra += prod * (1 + backward)
        if layer == 0:
            extra -= prod
    return kernel, extra


@pytest.mark.parametrize("cell", GRAPH_REF_CELLS, ids="-".join)
def test_graph_cells_flops_agree_with_the_reference(work, cell):
    """At (2, 2) the port's per-device FLOPs, gin-tu's by-design products
    set apart (``_gin_by_design``: its kernel's share asserted exactly),
    agree with the reference's ``analyze_hlo`` within ``REL_TRAIN``.  Both
    sides' collectives are printed: GSPMD all-gathers and all-reduces;
    DTensor reduce-scatters the node rows of each scatter and all-reduces
    each replicated parameter's gradient on its own."""
    arch, shape = cell
    ref, port = work["reference"]["/".join(cell)], work[("ref", *cell)]
    extra = 0
    if arch == "gin-tu":
        kernel, extra = _gin_by_design(shape)
        assert port["flops_kernels"] == {"segment_matmul": kernel}
    else:
        assert "segment_matmul" not in port["flops_kernels"]
    rest = port["flops"] - extra
    print(json.dumps({
        "cell": "/".join(cell), "port_flops": port["flops"],
        "by_design": extra, "ref_flops": ref["flops"],
        "ratio": rest / ref["flops"],
        "port_collectives": port["collectives"]["ops"],
        "port_wire": port["collectives"]["wire_bytes"],
        "ref_collectives": ref["ops"], "ref_wire": ref["wire"]}))
    assert abs(rest - ref["flops"]) <= REL_TRAIN * ref["flops"]


def test_mesh_cli_runs_an_lm_cell(tmp_path, capsys):
    """``--mesh multi`` with ``--overrides``, in this process: the fake
    group is made and ended around the record."""
    import torch.distributed as dist
    out = tmp_path / "mesh.jsonl"
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "prefill_32k",
                        "--mesh", "multi", "--overrides", '{"n_layers": 1}',
                        "--out", str(out)]) == 0
    assert not dist.is_initialized()
    rec, = [json.loads(line) for line in out.read_text().splitlines()]
    assert rec["status"] == "ok" and rec["chips"] == 512
    assert rec["mesh"] == "2x16x16"
    assert re.search(r"^OK qwen3-4b prefill_32k 2x16x16 ",
                     capsys.readouterr().out, re.M)


# ------------------------------------------------------- FilledCollectives
def _filled_run():
    """Each functional collective under ``FilledCollectives`` on real
    tensors, then two sharded mixtral steps (the fake group is up)."""
    from torch.distributed import _functional_collectives as funcol
    from repro_torch.launch import mesh as lmesh
    mesh = lmesh.make_mesh(MeshShape((2, 2), AXES), "cpu")
    name = mesh.get_group("model").group_name
    x = torch.arange(6.0).reshape(2, 3)
    f = torch.ops._c10d_functional
    with col.FilledCollectives():
        outs = [funcol.wait_tensor(t) for t in (
            f.all_gather_into_tensor(x, 2, name),
            f.all_reduce(x, "sum", name),
            f.reduce_scatter_tensor(x, "sum", 2, name),
            f.all_to_all_single(x, [1, 1], [1, 1], name),
            f.broadcast(x, 0, name))]
        metrics = [float(_trace_metrics()) for _ in range(2)]
    return [t.tolist() for t in outs], metrics


def _trace_metrics():
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tr
    from repro_torch.optim import adamw
    mesh = lmesh.make_mesh(MeshShape((2, 2), AXES), "cpu")
    cfg = _cfg("mixtral-8x22b")
    model = tr.TransformerLM(cfg, device="cpu")
    opt = adamw.init_state(model)
    sctx = tr.ShardCtx(mesh, "data")
    steps.place_lm(model, opt, sctx)
    tok = torch.zeros(BATCH, dtype=torch.int32)
    met = steps.lm_train_step(model, adamw.AdamWConfig(), opt, tok, tok,
                              sctx=sctx)
    assert all(torch.isfinite(p.to_local()).all()
               for p in model.parameters())
    return met["loss"]


def test_filled_collectives_write_their_outputs(work):
    """On real tensors over the fake group every functional collective
    writes the output it would give if each rank of its group held this
    rank's data, and a sharded mixtral step gives finite metrics and
    parameters."""
    (gathered, reduced, scattered, a2a, broadcast), metrics = work["filled"]
    x = np.arange(6.0).reshape(2, 3)
    assert gathered == np.concatenate([x, x]).tolist()
    assert reduced == a2a == broadcast == x.tolist()
    assert scattered == x[:1].tolist()
    assert all(np.isfinite(metrics))
