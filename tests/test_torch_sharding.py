"""Sharding: the port's DTensor placements against the JAX package's
``PartitionSpec``s, and the sharded LM step in 2 and 4 ``gloo`` processes
on the CPU against the JAX package's own sharded step (mixtral and
llama4, with and without ``moe_local_dispatch``, on 4 host devices in a
subprocess) and, with the global dispatch (or the per-shard one on one
data shard; also traded over two data axes), against the unsharded port
on the same batch; the MoE prefills against the unsharded port; the
attention shared among a model axis's ranks by rows (5 heads over 2) and
by kv-head groups and rows (6 heads in 2 groups over 4, also against the
reference's sharded prefill and step); the collectives of (2, 2) train
steps (``LocalCounter``: no whole expert weight, expert f or table
moves); and the sharded decode
(weight-stationary: no parameter or cache shard leaves its rank) in 2
and 4 ``gloo`` processes against the unsharded port and the reference's
``lm_decode_step`` jitted with its in-shardings on 4 host devices in a
subprocess.

A reference spec translates to placements by the rule of
``launch/sharding.py``: on each mesh dimension ``Shard(d)`` where tensor
dimension d is split over that axis (alone or in a tuple), ``Replicate()``
elsewhere; the reference's stacked leaves lose their leading L entry.

The process tests spawn their ranks with a join timeout, so a hang fails
the test.  Each rank writes what it found to a file, rank 0 its full
tensors; the parent holds them against the one-process port and the
reference's.

Tolerances, stated before measuring: against the unsharded port, every
metric, parameter and first moment within ``RTOL`` (1e-5) of the
tensor's largest |element|, but the parameters of llama4's f32 runs and
of ``GROUPED_HEADS``' run within ``RTOL`` of the model's largest
|parameter| (``MODEL_SCALE_ARCHS``; their float64 runs, and the
``ODD_HEADS`` runs, in float64, hold each tensor's own); against the
reference's sharded step, those of
``tests/test_torch_moe_lm.py`` for one f32 step: the metrics within
1e-5 relative, each first moment (a tenth of the clipped gradient) within
1e-4 of its largest |element|, each parameter within 2 lr.  The sharded
decode's logits, new keys and values within ``RTOL`` of each tensor's
largest |element| of both the unsharded port's and the reference's, its
``length`` equal.
"""
import contextlib
import dataclasses
import functools
import json
import math
import os
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import registry
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import sharding, steps
from repro_torch.models import transformer as tr
from repro_torch.optim import adamw

JOIN_TIMEOUT_S = 300
BATCH = (4, 16)
# |sharded - unsharded| <= RTOL * the largest |unsharded| of each tensor
RTOL = 1e-5


# ------------------------------------------------- placements vs reference
def _translate(spec, axes, stacked):
    from torch.distributed.tensor import Replicate, Shard
    entries = list(spec)[1:] if stacked else list(spec)
    out = []
    for name in axes:
        dims = [d for d, a in enumerate(entries)
                if a == name or (isinstance(a, tuple) and name in a)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _abstract(multi):
    from jax.sharding import AbstractMesh
    shape = lmesh.production_mesh_shape(multi_pod=multi)
    return shape, AbstractMesh(shape.sizes, shape.axis_names)


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ["gemma3-12b", "qwen2.5-32b", "qwen3-4b",
                                  "llama4-scout-17b-a16e", "mixtral-8x22b",
                                  "sasrec"])
def test_placements_equal_the_reference_specs(arch, multi):
    """Every parameter leaf (and AdamW moment) of the five LMs and SASRec,
    and each decode cell's KV cache, at 16x16 and 2x16x16."""
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as jreg
    from repro.launch import sharding as jsh
    from repro.models import sasrec as jsasrec
    from repro.models import transformer as jtr
    from repro_torch.models.sasrec import SASRec

    shape, amesh = _abstract(multi)
    axes = shape.axis_names
    entry = registry.get(arch)
    if entry.family == "lm":
        model = tr.TransformerLM(entry.config, device="meta",
                                 dtype=torch.bfloat16)
        init = functools.partial(jtr.init_params, jreg.get(arch).config,
                                 dtype=jnp.bfloat16)
        rule, jrule = sharding.lm_param_shardings, jsh.lm_param_shardings
    else:
        model = SASRec(entry.config, device="meta")
        init = functools.partial(jsasrec.init_params, jreg.get(arch).config)
        rule, jrule = sharding.rec_param_shardings, jsh.rec_param_shardings
    params = dict(model.named_parameters())
    want_tree = jrule(amesh, jax.eval_shape(init, jax.random.PRNGKey(0)))
    flat, _ = jsh._tree_paths(want_tree)
    want = {path: ns.spec for path, ns in flat}
    got = rule(shape, params)
    assert len(got) == len(params)
    for name, sh in got.items():
        path = sharding.param_path(name)
        if entry.family != "lm":   # SASRec's blocks are a list: blocks/0/wq
            path = name.replace(".", "/")
        stacked = entry.family == "lm" and name.startswith("layers.")
        assert sh.placements == _translate(want[path], axes, stacked), name
    opt = adamw.init_state(params)
    assert rule(shape, opt["m"]) == got
    if entry.family == "lm":
        for sname, spec in entry.shapes.items():
            if spec.kind != "decode" or entry.skip_shapes.get(sname):
                continue
            cache = steps.lm_cache_shape(entry.config, spec.global_batch,
                                         spec.seq_len)
            w = jsh.kv_cache_shardings(amesh, cache, spec.global_batch).spec
            g = sharding.kv_cache_shardings(shape, cache, spec.global_batch)
            assert g.placements == _translate(w, axes, False), sname
            assert g.local_shape(cache)[1] in (spec.global_batch // (
                shape.shape["data"] * shape.shape.get("pod", 1)),
                spec.global_batch)


def test_rules_fall_back_where_an_axis_does_not_divide():
    mesh = lmesh.MeshShape((2, 3), ("data", "model"))
    got = sharding.lm_param_shardings(mesh, {
        "layers.0.attn.wq": torch.empty(4, 6, device="meta"),
        "layers.0.attn.wk": torch.empty(5, 4, device="meta"),
        "embed": torch.empty(7, 4, device="meta")})
    assert got["layers.0.attn.wq"].spec == ("data", "model")
    assert got["layers.0.attn.wk"].spec == (None, None)
    assert got["embed"].spec == (None, "data")
    assert got["layers.0.attn.wq"].local_shape((4, 6)) == (2, 2)
    pod = lmesh.production_mesh_shape(multi_pod=True)
    assert lmesh.data_axes(pod) == ("pod", "data")
    assert lmesh.n_chips(pod) == 512
    assert sharding.batch_sharding(pod, 2).spec == (("pod", "data"), None)


# --------------------------------------------------------- gloo processes
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(fn, nprocs, *args):
    """Run ``fn(rank, nprocs, port, *args)`` in ``nprocs`` spawned
    processes; fail (and stop them) past ``JOIN_TIMEOUT_S``, with the
    stacks the ranks dumped (``args[0]``, the output directory)."""
    ctx = mp.start_processes(fn, args=(nprocs, _free_port()) + args,
                             nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            for p in ctx.processes:
                p.join(10)
            stacks = "".join(
                open(os.path.join(args[0], f)).read()
                for f in sorted(os.listdir(args[0])) if f.startswith(
                    f"stacks-{nprocs}-"))
            pytest.fail(f"{fn.__name__} hung past {JOIN_TIMEOUT_S} s:\n"
                        f"{stacks}")
    assert all(not p.is_alive() for p in ctx.processes)


def _batch(vocab):
    rng = np.random.default_rng(0)
    return (rng.integers(0, vocab, BATCH).astype(np.int32),
            rng.integers(0, vocab, BATCH).astype(np.int32))


def _cfg(arch, local=False, remat="none", n_micro=1):
    return dataclasses.replace(registry.get(arch).smoke_config,
                               dtype=torch.float32, attention_impl="pallas",
                               moe_local_dispatch=local, remat=remat,
                               n_microbatches=n_micro)


# the sharded runs: (mesh sizes, arch, moe_local_dispatch, remat,
# microbatches, dtype); a float64 run's parameters are the seed-0 float32
# ones, cast
LLAMA4 = "llama4-scout-17b-a16e"
MOE_ARCHS = ("mixtral-8x22b", LLAMA4)
F32, F64 = "float32", "float64"
RUNS_2 = [((2, 1), "qwen3-4b", False, "none", 1, F32),
          ((2, 1), "mixtral-8x22b", False, "dots", 1, F32),
          ((1, 2), "mixtral-8x22b", False, "none", 1, F32),
          ((2, 1), "mixtral-8x22b", True, "none", 1, F32),
          ((1, 2), "mixtral-8x22b", True, "none", 1, F32),
          ((1, 2), LLAMA4, True, "none", 1, F32),
          ((1, 2), LLAMA4, True, "none", 1, F64)]
RUNS_4 = [((2, 2), "qwen3-4b", False, "full", 1, F32),
          ((2, 2), "mixtral-8x22b", False, "none", 2, F32),
          ((2, 2), "mixtral-8x22b", True, "dots", 1, F32),
          ((2, 2), LLAMA4, False, "full", 1, F32),
          ((2, 2), LLAMA4, False, "full", 1, F64)]
# the archs whose f32 runs hold each parameter within ``RTOL`` of the
# model's largest |parameter| (not of its own): llama4.  Its first moments
# (its gradients) hold ``RTOL`` of their own, but one AdamW step (m̂ /
# (sqrt(v̂) + eps), its clipped gradients down to 25 eps) turns their
# rounding into some 5e-5 of layer 3's zero-initialized norm scales: a
# parameter whose gradient is rounding noise moves by lr times that
# noise's sign.  Its float64 runs hold every tensor to its own largest
MODEL_SCALE_ARCHS = (LLAMA4,)
# the MoE runs, each held to the reference's sharded step
MOE_RUNS = [r for r in RUNS_2 + RUNS_4 if r[1] in MOE_ARCHS]
# the runs held to the unsharded port: the global dispatch, and the
# per-shard dispatch on one data shard (one shard: the same dispatch)
GLOBAL_RUNS = [r for r in RUNS_2 + RUNS_4 if not r[2] or r[0][0] == 1]


def _model(arch, local=False, remat="none", n_micro=1, dtype=F32,
           **overrides):
    """The port's seed-0 model on the CPU, in ``dtype``."""
    cfg = dataclasses.replace(_cfg(arch, local, remat, n_micro), **overrides)
    if dtype == F32:
        return tr.TransformerLM(cfg, device="cpu")
    cfg = dataclasses.replace(cfg, dtype=torch.float64)
    return tr.TransformerLM(cfg, device="cpu").to(torch.float64)


def _run_id(run):
    sizes, arch, local, remat, n_micro, dtype = run
    return (f"{sizes[0]}x{sizes[1]}-{arch}{'-local' if local else ''}"
            f"-remat_{remat}{f'-micro{n_micro}' if n_micro > 1 else ''}"
            f"{'-f64' if dtype == F64 else ''}")


def _mesh_id(sizes):
    return "x".join(map(str, sizes))


def _run_file(run):
    sizes, arch, local, *_, dtype = run
    return f"{sizes}-{arch}-{local}-{dtype}.pt"


def _reference_file(run):
    """The reference's step of ``run`` (f32 whatever the run's dtype)."""
    sizes, arch, local = run[:3]
    return f"jax-{sizes}-{arch}-{local}.pt"


# the reference's sharded ``lm_train_step`` on 4 host devices, from the
# port's seed-0 parameters, for each job in argv[2] (JSON: the output file,
# mesh sizes, arch, moe_local_dispatch, microbatches, config overrides and
# whether to run the sharded ``lm_prefill_step`` first); jitted with
# ``xla_allow_excess_precision`` off, as ``tests/test_torch_moe_lm.py``
REFERENCE_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, functools, json, sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    import torch
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import registry as jreg
    from repro.launch import sharding as jsh
    from repro.launch import steps as jsteps
    from repro.models import transformer as jtr
    from repro.optim import adamw as jadamw
    from repro_torch.configs import registry
    from repro_torch.convert import (lm_params_from_reference,
                                     lm_params_to_reference, named_lm_params)
    from repro_torch.models.transformer import TransformerLM

    assert len(jax.devices()) == 4
    out_dir, runs, batch = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
    saved = np.load(batch)
    tokens, labels = jnp.asarray(saved["tokens"]), jnp.asarray(saved["labels"])
    for name, sizes, arch, local, n_micro, overrides, prefill in runs:
        cfg = dataclasses.replace(
            registry.get(arch).smoke_config, dtype=torch.float32,
            remat="none", n_microbatches=n_micro, **overrides)
        jcfg = dataclasses.replace(
            jreg.get(arch).smoke_config, dtype=jnp.float32,
            moe_local_dispatch=local, n_microbatches=n_micro, **overrides)
        params = jax.tree.map(jnp.asarray, lm_params_to_reference(
            TransformerLM(cfg, device="cpu")))
        mesh = Mesh(np.array(jax.devices()[:int(np.prod(sizes))])
                    .reshape(sizes), ("data", "model"))
        opt_cfg = jadamw.AdamWConfig()
        opt = jadamw.init_state(params)
        p_sh = jsh.lm_param_shardings(mesh, params)
        o_sh = {"m": p_sh, "v": p_sh, "step": NamedSharding(mesh, P())}
        b_sh = jsh.batch_sharding(mesh, 2)
        found = {}
        if prefill:
            found["logits"] = torch.from_numpy(np.asarray(jax.jit(
                functools.partial(jsteps.lm_prefill_step, jcfg,
                                  sctx=jtr.ShardCtx(mesh, "data")),
                in_shardings=(p_sh, b_sh),
                compiler_options={"xla_allow_excess_precision": False})(
                    params, tokens)[0]))
        step = jax.jit(functools.partial(
            jsteps.lm_train_step, jcfg, opt_cfg,
            sctx=jtr.ShardCtx(mesh, "data")),
            in_shardings=(p_sh, o_sh, b_sh, b_sh),
            compiler_options={"xla_allow_excess_precision": False})
        new, opt, metrics = step(params, opt, tokens, labels)

        def named(tree):
            return named_lm_params(lm_params_from_reference(
                cfg, jax.tree.map(np.asarray, tree)))
        found.update(metrics={k: float(v) for k, v in metrics.items()},
                     params=named(new), m=named(opt["m"]))
        torch.save(found, os.path.join(out_dir, name))
    print("REFERENCE_OK")
""")


def _reference_jobs():
    """``REFERENCE_SCRIPT``'s jobs: each MoE run's step (one for a run in
    both dtypes), and ``GROUPED_HEADS``' prefill and step."""
    jobs = {_reference_file(r): [_reference_file(r), r[0], r[1], r[2],
                                 r[4], {}, False] for r in MOE_RUNS}
    return list(jobs.values()) + [
        ["jax-grouped-heads.pt", GROUPED_MESH, "qwen3-4b", False, 1,
         GROUPED_HEADS, True]]


def _start_reference(out_dir):
    """The reference's sharded steps of ``_reference_jobs``, started in a
    subprocess (4 host devices must be set before JAX starts)."""
    batch = os.path.join(out_dir, "batch.npz")
    tokens, labels = _batch(_cfg("mixtral-8x22b").vocab)
    np.savez(batch, tokens=tokens, labels=labels)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in [env.get("PYTHONPATH")] if p])
    return subprocess.Popen(
        [sys.executable, "-c", REFERENCE_SCRIPT, out_dir,
         json.dumps(_reference_jobs()), batch], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _lm_runs(rank, world, out_dir, runs):
    from torch.distributed.tensor.debug import CommDebugMode
    for run in runs:
        sizes, arch, local, remat, n_micro, dtype = run
        mesh = lmesh.make_mesh(lmesh.MeshShape(sizes, ("data", "model")),
                               "cpu")
        model = _model(arch, local, remat, n_micro, dtype)
        cfg = model.cfg
        opt = adamw.init_state(model)
        sctx = tr.ShardCtx(mesh, "data")
        steps.place_lm(model, opt, sctx)
        tokens, labels = _batch(cfg.vocab)
        # CommDebugMode's module tracker fails on a second forward of the
        # model inside one mode, so a microbatched step goes uncounted
        comm = CommDebugMode() if n_micro == 1 else None
        with comm or contextlib.nullcontext():
            metrics = steps.lm_train_step(model, adamw.AdamWConfig(), opt,
                                          tokens, labels, sctx=sctx)
        counts = None if comm is None else {
            str(k).split(".")[-1]: v
            for k, v in comm.get_comm_counts().items()}
        params = {n: _full(p.detach()) for n, p in model.named_parameters()}
        m = {n: _full(t) for n, t in opt["m"].items()}
        if rank == 0:
            torch.save({"metrics": metrics, "params": params, "m": m,
                        "counts": counts, "placements": {
                            n: str(p.placements)
                            for n, p in model.named_parameters()}},
                       os.path.join(out_dir, _run_file(run)))


def _serve_run(rank, out_dir):
    """prefill and one decode step of the qwen3 smoke model on (2, 2)."""
    mesh = lmesh.make_mesh(lmesh.MeshShape((2, 2), ("data", "model")), "cpu")
    cfg = _cfg("qwen3-4b")
    model = tr.TransformerLM(cfg, device="cpu")
    sctx = tr.ShardCtx(mesh, "data")
    steps.place_lm(model, None, sctx)
    tokens, _ = _batch(cfg.vocab)
    logits, cache = steps.lm_prefill_step(model, tokens, sctx=sctx)
    from repro_torch.launch.serve import grow_cache
    full = {k: _full(v) for k, v in cache.items()}
    grown = grow_cache(full, BATCH[1] + 1)
    place = sharding.kv_cache_shardings(mesh, grown["k"].shape, BATCH[0])
    grown = {"k": place.distribute(grown["k"]),
             "v": place.distribute(grown["v"]), "length": grown["length"]}
    step_logits, new = steps.lm_decode_step(
        model, grown, torch.as_tensor(tokens[:, -1]).long(), sctx=sctx)
    assert tuple(new["k"].placements) == tuple(grown["k"].placements)
    found = {"logits": _full(logits), "k": full["k"],
             "step_logits": _full(step_logits), "k_after": _full(new["k"])}
    if rank == 0:
        torch.save(found, os.path.join(out_dir, "serve.pt"))


# the MoE prefills (global dispatch) held to the unsharded port
PREFILL_MESHES = [(1, 2), (2, 2)]


def _prefill_runs(rank, world, out_dir):
    """mixtral's and llama4's sharded prefill on each mesh of
    ``PREFILL_MESHES`` of ``world`` ranks: rank 0 writes the logits and
    the cache's k and v whole."""
    for sizes in [s for s in PREFILL_MESHES if math.prod(s) == world]:
        mesh = lmesh.make_mesh(lmesh.MeshShape(sizes, ("data", "model")),
                               "cpu")
        sctx = tr.ShardCtx(mesh, "data")
        for arch in MOE_ARCHS:
            model = tr.TransformerLM(_cfg(arch), device="cpu")
            steps.place_lm(model, None, sctx)
            tokens, _ = _batch(model.cfg.vocab)
            logits, cache = steps.lm_prefill_step(model, tokens, sctx=sctx)
            found = {"logits": _full(logits), "k": _full(cache["k"]),
                     "v": _full(cache["v"])}
            if rank == 0:
                torch.save(found, os.path.join(
                    out_dir, f"prefill-{_mesh_id(sizes)}-{arch}.pt"))


# qwen3's smoke config with 5 query heads and 1 kv head: the heads split
# over no model axis of 2, so its ranks share the attention by rows (in
# float64: its f32 step misses ``RTOL`` on zero-initialized norm scales
# as llama4's does)
ODD_HEADS = {"n_heads": 5, "n_kv_heads": 1}
ODD_MESHES = [(1, 2), (2, 2)]
# and with 6 query heads in 2 kv-head groups over a model axis of 4 (f32):
# neither splits, so the ranks share the attention by kv-head groups (2)
# and rows (2), as llama4's and qwen2.5's 40 heads in 8 groups do over 16
# ranks at 16x16 (8 groups, 2 row blocks)
GROUPED_HEADS = {"n_heads": 6, "n_kv_heads": 2}
GROUPED_MESH = (1, 4)
# (file, heads, mesh sizes, dtype)
HEAD_CASES = [(f"odd-heads-{_mesh_id(s)}.pt", ODD_HEADS, s, F64)
              for s in ODD_MESHES] + [
    ("grouped-heads.pt", GROUPED_HEADS, GROUPED_MESH, F32)]


def _heads_runs(rank, world, out_dir):
    """A prefill and a train step of each ``HEAD_CASES`` case of ``world``
    ranks: rank 0 writes the prefill's logits, the metrics, the
    parameters and the first moments whole."""
    for name, heads, sizes, dtype in HEAD_CASES:
        if math.prod(sizes) != world:
            continue
        mesh = lmesh.make_mesh(lmesh.MeshShape(sizes, ("data", "model")),
                               "cpu")
        sctx = tr.ShardCtx(mesh, "data")
        model = _model("qwen3-4b", dtype=dtype, **heads)
        cfg = model.cfg
        opt = adamw.init_state(model)
        steps.place_lm(model, opt, sctx)
        tokens, labels = _batch(cfg.vocab)
        logits, _ = steps.lm_prefill_step(model, tokens, sctx=sctx)
        metrics = steps.lm_train_step(model, adamw.AdamWConfig(), opt,
                                      tokens, labels, sctx=sctx)
        found = {"metrics": metrics, "logits": _full(logits),
                 "params": {n: _full(p.detach())
                            for n, p in model.named_parameters()},
                 "m": {n: _full(t) for n, t in opt["m"].items()}}
        if rank == 0:
            torch.save(found, os.path.join(out_dir, name))


# mixtral's global dispatch over two data axes, (pod, data, model) =
# (2, 2, 1): its tokens traded for d blocks over both
POD_MESH = (2, 2, 1)


def _pod_run(rank, out_dir):
    """One train step of mixtral's global dispatch on ``POD_MESH``: rank 0
    writes the metrics, the parameters and the first moments whole."""
    mesh = lmesh.make_mesh(_decode_mesh(POD_MESH), "cpu")
    sctx = tr.ShardCtx(mesh, ("pod", "data"))
    model = _model("mixtral-8x22b")
    opt = adamw.init_state(model)
    steps.place_lm(model, opt, sctx)
    tokens, labels = _batch(model.cfg.vocab)
    metrics = steps.lm_train_step(model, adamw.AdamWConfig(), opt, tokens,
                                  labels, sctx=sctx)
    found = {"metrics": metrics,
             "params": {n: _full(p.detach())
                        for n, p in model.named_parameters()},
             "m": {n: _full(t) for n, t in opt["m"].items()}}
    if rank == 0:
        torch.save(found, os.path.join(out_dir, "pod.pt"))


# the (2, 2) train steps whose collectives ``LocalCounter`` records: the
# smoke configs with the experts' f at 96 (no other dimension of the step
# is 96, so a collective's shape shows an expert's whole f)
COUNTED_F = 96
TRAIN_COUNTED = [("mixtral-8x22b", False), ("mixtral-8x22b", True),
                 (LLAMA4, False)]


def _train_counted(rank, out_dir):
    """One (2, 2) train step of each ``TRAIN_COUNTED`` case under
    ``LocalCounter``: each collective's kind, result shapes and site."""
    from repro_torch.launch.collectives import LocalCounter
    mesh = lmesh.make_mesh(lmesh.MeshShape((2, 2), ("data", "model")),
                           "cpu")
    sctx = tr.ShardCtx(mesh, "data")
    found = {}
    for arch, local in TRAIN_COUNTED:
        cfg = dataclasses.replace(_cfg(arch, local), moe_d_ff=COUNTED_F)
        model = tr.TransformerLM(cfg, device="cpu")
        opt = adamw.init_state(model)
        steps.place_lm(model, opt, sctx)
        tokens, labels = _batch(cfg.vocab)
        counter = LocalCounter()
        with counter:
            metrics = steps.lm_train_step(model, adamw.AdamWConfig(), opt,
                                          tokens, labels, sctx=sctx)
        found[f"{arch}-{local}"] = {
            "collectives": [(d["kind"], d["shapes"], d["site"])
                            for d in counter.details],
            "loss": float(metrics["loss"])}
    if rank == 0:
        torch.save(found, os.path.join(out_dir, "train-counted.pt"))


def _restore_run(rank, out_dir):
    """Write a state placed on (2, 1) and restore it onto (1, 2); then a
    ``TrainRunner`` preempted on one mesh resumes on the other."""
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.runtime.fault_tolerance import RunnerConfig, TrainRunner
    a = lmesh.make_mesh(lmesh.MeshShape((2, 1), ("data", "model")), "cpu")
    b = lmesh.make_mesh(lmesh.MeshShape((1, 2), ("data", "model")), "cpu")
    model = tr.TransformerLM(_cfg("qwen3-4b"), device="cpu")
    named = dict(model.named_parameters())
    on_a = sharding.place_tensors(
        {n: p.detach() for n, p in named.items()},
        sharding.lm_param_shardings(a, named))
    ckpt.save(os.path.join(out_dir, "elastic"), 0, {"params": on_a})
    target = sharding.lm_param_shardings(b, named)
    restored, step = ckpt.restore(os.path.join(out_dir, "elastic"),
                                  {"params": named},
                                  shardings={"params": target})
    assert step == 0
    for n, t in restored["params"].items():
        assert tuple(t.placements) == target[n].placements, n
        assert torch.equal(t.full_tensor(), named[n].detach()), n

    def state():
        return {"w": torch.arange(24.0).reshape(8, 3), "n": torch.zeros(())}

    def step_fn(s, i):
        return {"w": s["w"] * 1.5 + i, "n": s["n"] + 1}

    place = {"w": sharding.Sharding(b, ("model", None)), "n": None}
    cfg = RunnerConfig(os.path.join(out_dir, "runner"), ckpt_every=1,
                       max_steps=5)
    try:
        TrainRunner(cfg, state, step_fn).run(crash_at_step=3)
    except RuntimeError:
        pass
    resumed = TrainRunner(cfg, state, step_fn, shardings=place).run()
    assert tuple(resumed["w"].placements) == place["w"].placements
    clean = state()
    for i in range(5):
        clean = step_fn(clean, i)
    assert torch.equal(resumed["w"].full_tensor(), clean["w"])
    assert torch.equal(resumed["n"], clean["n"])


def _one_rank(out_dir):
    """On a (1, 1) mesh the sharded loss and step are the plain port's bit
    for bit, with the global and the per-shard dispatch alike."""
    mesh = lmesh.make_mesh(lmesh.MeshShape((1, 1), ("data", "model")), "cpu")
    sctx = tr.ShardCtx(mesh, "data")
    for arch, local in (("qwen3-4b", False), ("mixtral-8x22b", True),
                        ("mixtral-8x22b", False), (LLAMA4, False)):
        cfg = _cfg(arch, local, "full")
        plain = tr.TransformerLM(cfg, device="cpu")
        shard = tr.TransformerLM(cfg, device="cpu")
        o_p, o_s = adamw.init_state(plain), adamw.init_state(shard)
        steps.place_lm(shard, o_s, sctx)
        tokens, labels = _batch(cfg.vocab)
        with torch.no_grad():
            assert torch.equal(
                shard.loss_fn(tokens, labels, sctx=sctx)[0].full_tensor(),
                plain.loss_fn(tokens, labels)[0])
        m_p = steps.lm_train_step(plain, adamw.AdamWConfig(), o_p, tokens,
                                  labels)
        m_s = steps.lm_train_step(shard, adamw.AdamWConfig(), o_s, tokens,
                                  labels, sctx=sctx)
        assert all(torch.equal(m_s[k], m_p[k]) for k in m_p), (m_s, m_p)
        try:   # a step under a context runs only on a placed state
            steps.lm_train_step(plain, adamw.AdamWConfig(), o_p, tokens,
                                labels, sctx=sctx)
        except ValueError as e:
            assert "place_lm" in str(e), e
        else:
            raise AssertionError("a step on an unplaced state ran")
        named = dict(shard.named_parameters())
        for n, p in plain.named_parameters():
            assert torch.equal(named[n].detach().full_tensor(), p.detach()), n
            assert torch.equal(o_s["v"][n].full_tensor(), o_p["v"][n]), n
    with open(os.path.join(out_dir, "one_rank.ok"), "w") as f:
        f.write("bit-equal\n")


def _worker(rank, world, port, out_dir, runs, extra):
    import faulthandler
    import torch.distributed as dist
    # one thread a rank: the suite runs beside other test processes, and
    # spinning intra-op threads over more ranks than cores stall gloo
    torch.set_num_threads(1)
    # where a rank stands if it outlives the parent's patience
    stacks = open(os.path.join(out_dir, f"stacks-{world}-{rank}.txt"), "w")
    faulthandler.dump_traceback_later(JOIN_TIMEOUT_S - 20, file=stacks)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=rank, world_size=world)
    try:
        _lm_runs(rank, world, out_dir, runs)
        _decode_runs(rank, world, out_dir)
        _prefill_runs(rank, world, out_dir)
        _heads_runs(rank, world, out_dir)
        if extra == "one_rank":
            _one_rank(out_dir)
        elif extra == "restore":
            _restore_run(rank, out_dir)
        elif extra == "serve":
            _serve_run(rank, out_dir)
            _decode_counted(rank, out_dir)
            _train_counted(rank, out_dir)
            _pod_run(rank, out_dir)
    finally:
        faulthandler.cancel_dump_traceback_later()
        stacks.close()
        dist.destroy_process_group()


# ------------------------------------------------------- the sharded decode
# (arch, B, S, length): the qwen3, gemma3 (windowed and global layers) and
# mixtral (MoE, global dispatch) smoke models at B 4 on rings that have
# wrapped; and two single streams (B 1), whose slots split over "data"
# where it has 2 ranks: qwen3's 8 slots at length 13 (the written slot, 5,
# on data rank 1), and gemma3's 24 at length 37, wrapped past its window
# of 16 (the written slot, 13, on data rank 1; slots 14-21 valid but out
# of the window, slots 0-13, 22 and 23 in it, on both data ranks)
DECODE_CASES = [("qwen3-4b", 4, 16, 19), ("gemma3-12b", 4, 24, 30),
                ("mixtral-8x22b", 4, 16, 21), ("qwen3-4b", 1, 8, 13),
                ("gemma3-12b", 1, 24, 37)]
# (data, model) meshes, and a (pod, data, model) one: at B 1 its cache is
# replicated over "pod", which splits the kv heads
DECODE_MESHES = [(1, 2), (2, 1), (2, 2), (2, 1, 2)]
# the collective-size runs of (2, 2): B 2, so each data rank decodes one row
DECODE_COUNTED = [("qwen3-4b", 2, 16, 19), ("mixtral-8x22b", 2, 16, 21)]


def _decode_id(case):
    arch, B, S, length = case
    return f"{arch}-B{B}-S{S}-len{length}"


def _decode_mesh(sizes):
    """The ``MeshShape`` of ``sizes``: (data, model) or (pod, data, model)."""
    return lmesh.MeshShape(sizes, ("pod", "data", "model")[-len(sizes):])


def _decode_file(sizes, case, prefix="decode"):
    return f"{prefix}-{_mesh_id(sizes)}-{_decode_id(case)}.pt"


def _decode_inputs(case):
    """(cfg, {"k", "v", "length"} as numpy, token): a cache of standard
    normal keys and values and a token from seed 1."""
    arch, B, S, length = case
    cfg = _cfg(arch)
    rng = np.random.default_rng(1)
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": rng.standard_normal(shape).astype(np.float32),
             "v": rng.standard_normal(shape).astype(np.float32),
             "length": np.full((B,), length, np.int32)}
    return cfg, cache, rng.integers(0, cfg.vocab, (B,)).astype(np.int32)


def _torch_cache(cache):
    return {k: torch.from_numpy(v.copy()) for k, v in cache.items()}


def _decode_runs(rank, world, out_dir):
    """Every case of ``DECODE_CASES`` on each mesh of ``world`` ranks:
    rank 0 writes the logits, the new cache whole and its placements;
    every rank whether it wrote its own block of layer 0's keys."""
    for sizes in [s for s in DECODE_MESHES if math.prod(s) == world]:
        shape = _decode_mesh(sizes)
        mesh = lmesh.make_mesh(shape, "cpu")
        dp = shape.axis_names[:-1]
        sctx = tr.ShardCtx(mesh, dp if len(dp) > 1 else dp[0])
        for case in DECODE_CASES:
            cfg, cache, token = _decode_inputs(case)
            model = tr.TransformerLM(cfg, device="cpu")
            steps.place_lm(model, None, sctx)
            placed = steps.place_cache(_torch_cache(cache), sctx)
            before = placed["k"].to_local()[0].clone()
            pl = tuple(placed["k"].placements)
            logits, new = steps.lm_decode_step(
                model, placed, torch.from_numpy(token), sctx=sctx)
            assert tuple(new["k"].placements) == pl
            assert tuple(new["v"].placements) == pl
            wrote = not torch.equal(new["k"].to_local()[0], before)
            found = {"logits": _full(logits), "k": _full(new["k"]),
                     "v": _full(new["v"]), "length": new["length"],
                     "logits_placements": str(logits.placements),
                     "cache_placements": str(pl)}
            with open(os.path.join(out_dir, _decode_file(
                    sizes, case, f"wrote-{rank}")), "w") as f:
                json.dump({"data_rank": sctx.data_rank(), "wrote": wrote},
                          f)
            if rank == 0:
                torch.save(found, os.path.join(out_dir,
                                               _decode_file(sizes, case)))


def _decode_counted(rank, out_dir):
    """One (2, 2) decode step of each ``DECODE_COUNTED`` case under
    ``LocalCounter``: every collective's kind and payload (its result
    bytes), beside the bytes of each parameter's local shard and of the
    cache's; then a prefill's cache (kv heads over "model") and a plain
    cache given to the decode (each must raise), and the prefill's cache
    after ``place_cache`` decoded."""
    from repro_torch.launch.collectives import LocalCounter
    mesh = lmesh.make_mesh(lmesh.MeshShape((2, 2), ("data", "model")),
                           "cpu")
    sctx = tr.ShardCtx(mesh, "data")
    found = {}
    for case in DECODE_COUNTED:
        cfg, cache, token = _decode_inputs(case)
        model = tr.TransformerLM(cfg, device="cpu")
        steps.place_lm(model, None, sctx)
        placed = steps.place_cache(_torch_cache(cache), sctx)
        counter = LocalCounter()
        with counter:
            steps.lm_decode_step(model, placed, torch.from_numpy(token),
                                 sctx=sctx)
        found[_decode_id(case)] = {
            "collectives": [(d["kind"], d["bytes"], d["site"])
                            for d in counter.details],
            "params": {n: p.to_local().numel() * p.to_local().element_size()
                       for n, p in model.named_parameters()
                       if p.dim() >= 2},
            "cache": placed["k"].to_local().numel()
            * placed["k"].to_local().element_size()}
    cfg = _cfg("qwen3-4b")
    model = tr.TransformerLM(cfg, device="cpu")
    steps.place_lm(model, None, sctx)
    tokens, _ = _batch(cfg.vocab)
    _, cache = steps.lm_prefill_step(model, tokens, sctx=sctx)
    errors = []
    for given in (cache, {k: _full(v) for k, v in cache.items()}):
        try:
            steps.lm_decode_step(model, given, torch.as_tensor(
                tokens[:, -1]).long(), sctx=sctx)
        except ValueError as e:
            errors.append(str(e))
    logits, new = steps.lm_decode_step(
        model, steps.place_cache(cache, sctx),
        torch.as_tensor(tokens[:, -1]).long(), sctx=sctx)
    found["errors"] = errors
    found["after_prefill"] = {"logits": _full(logits), "k": _full(new["k"])}
    if rank == 0:
        torch.save(found, os.path.join(out_dir, "decode-counted.pt"))


# the reference's ``lm_decode_step`` jitted with the in-shardings of
# ``launch/specs.py`` (the parameters', ``kv_cache_shardings``, the token's)
# on each mesh of argv[3] over 4 host devices, from the port's seed-0
# parameters and each case's inputs (argv[2], their files in argv[1])
DECODE_REFERENCE_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, functools, json, sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    import torch
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import registry as jreg
    from repro.launch import sharding as jsh
    from repro.launch import steps as jsteps
    from repro_torch.configs import registry
    from repro_torch.convert import lm_params_to_reference
    from repro_torch.models.transformer import TransformerLM

    assert len(jax.devices()) == 4
    out_dir, cases, meshes = (sys.argv[1], json.loads(sys.argv[2]),
                              json.loads(sys.argv[3]))
    for arch, B, S, length in cases:
        name = f"{arch}-B{B}-S{S}-len{length}"
        saved = np.load(os.path.join(out_dir, f"inputs-{name}.npz"))
        cfg = dataclasses.replace(registry.get(arch).smoke_config,
                                  dtype=torch.float32)
        jcfg = dataclasses.replace(jreg.get(arch).smoke_config,
                                   dtype=jnp.float32)
        params = jax.tree.map(jnp.asarray, lm_params_to_reference(
            TransformerLM(cfg, device="cpu")))
        for sizes in meshes:
            mesh = Mesh(np.array(jax.devices()[:int(np.prod(sizes))])
                        .reshape(sizes),
                        ("pod", "data", "model")[-len(sizes):])
            kv = jsh.kv_cache_shardings(mesh, saved["k"].shape, B)
            c_sh = {"k": kv, "v": kv, "length": NamedSharding(mesh, P())}
            dpn = int(np.prod(sizes[:-1]))
            t_sh = (jsh.batch_sharding(mesh, 1) if B % dpn == 0 and B >= dpn
                    else NamedSharding(mesh, P()))
            step = jax.jit(functools.partial(jsteps.lm_decode_step, jcfg),
                           in_shardings=(jsh.lm_param_shardings(mesh, params),
                                         c_sh, t_sh),
                           compiler_options={
                               "xla_allow_excess_precision": False})
            cache = {k: jnp.asarray(saved[k]) for k in ("k", "v", "length")}
            logits, new = step(params, cache, jnp.asarray(saved["token"]))
            mesh_id = "x".join(map(str, sizes))
            np.savez(os.path.join(out_dir, f"jax-{mesh_id}-{name}.npz"),
                     logits=np.asarray(logits),
                     k=np.asarray(new["k"]), v=np.asarray(new["v"]),
                     length=np.asarray(new["length"]))
    print("REFERENCE_OK")
""")


def _start_decode_reference(out_dir):
    """The reference's sharded decodes of every case on every mesh,
    started in a subprocess on the cases' inputs, written first."""
    for case in DECODE_CASES:
        _, cache, token = _decode_inputs(case)
        np.savez(os.path.join(out_dir, f"inputs-{_decode_id(case)}.npz"),
                 token=token, **cache)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in [env.get("PYTHONPATH")] if p])
    return subprocess.Popen(
        [sys.executable, "-c", DECODE_REFERENCE_SCRIPT, out_dir,
         json.dumps(DECODE_CASES), json.dumps(DECODE_MESHES)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharded"))
    references = {"train": _start_reference(out),
                  "decode": _start_decode_reference(out)}
    try:
        _spawn(_worker, 1, out, [], "one_rank")
        _spawn(_worker, 2, out, RUNS_2, "restore")
        _spawn(_worker, 4, out, RUNS_4, "serve")
        ran = {name: ref.communicate(timeout=JOIN_TIMEOUT_S)
               for name, ref in references.items()}
    finally:
        for ref in references.values():
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    for name, ref in references.items():
        stdout, stderr = ran[name]
        assert ref.returncode == 0 and "REFERENCE_OK" in stdout, \
            (name, stderr[-3000:])
    return out


def _unsharded(run, **overrides):
    """The one-process port's step on the same global batch."""
    model = _model(run[1], remat=run[3], n_micro=run[4], dtype=run[5],
                   **overrides)
    opt = adamw.init_state(model)
    tokens, labels = _batch(model.cfg.vocab)
    metrics = steps.lm_train_step(model, adamw.AdamWConfig(), opt, tokens,
                                  labels)
    return metrics, dict(model.named_parameters()), opt["m"]


def _close(got, want, what, scale=None):
    """|got - want| within ``RTOL`` of ``scale`` (want's largest |element|
    by default)."""
    want = want.detach()
    if scale is None:
        scale = float(want.abs().max())
    scale = max(scale, 1e-30)
    err = float((got - want).abs().max())
    assert err <= RTOL * scale, f"{what}: {err} > {RTOL} * {scale}"


def _close_step(got, metrics, params, m, model_scale=False):
    """A sharded step against the unsharded port's: the metrics and first
    moments within ``RTOL`` of each tensor's largest |element|, the
    parameters of each tensor's or (``model_scale``) the model's largest
    |parameter|."""
    for key in ("loss", "nll", "aux", "grad_norm", "lr"):
        _close(got["metrics"][key], metrics[key], key)
    assert set(got["params"]) == set(params)
    scale = max(float(p.detach().abs().max()) for p in params.values())
    for n, p in params.items():
        _close(got["params"][n], p, n, scale if model_scale else None)
        _close(got["m"][n], m[n], f"m {n}")


def _close_to_reference(got, want):
    """A sharded step against the reference's, within the module
    docstring's tolerances."""
    for key in ("loss", "nll", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got["metrics"][key]),
                                   want["metrics"][key], rtol=1e-5,
                                   err_msg=key)
    lr = want["metrics"]["lr"]
    assert set(got["params"]) == set(want["params"])
    for n, p in want["params"].items():
        assert float((got["params"][n] - p).abs().max()) <= 2 * lr, n
        scale = max(float(want["m"][n].abs().max()), 1e-30)
        err = float((got["m"][n] - want["m"][n]).abs().max())
        assert err <= 1e-4 * scale, f"m {n}: {err} > 1e-4 * {scale}"


def _check_collectives(got, run):
    """The step's collectives (``CommDebugMode``'s counts): all-reduces,
    all-gathers exactly where "data" has 2 ranks, reduce-scatters on (2,
    2); an all-to-all exactly where the global MoE dispatch trades tokens
    over 2 data ranks."""
    sizes, arch, local = run[:3]
    counts = got["counts"]
    assert "Shard" in got["placements"]["layers.0.attn.wq"]
    if counts is None:   # a microbatched step (``_lm_runs``)
        return
    # weights are gathered over the data axis only, never over "model"
    assert (counts.get("all_gather_into_tensor", 0) > 0) == (sizes[0] > 1), \
        counts
    assert counts.get("all_reduce", 0) > 0, counts
    trades = arch in MOE_ARCHS and not local and sizes[0] > 1
    assert (counts.get("all_to_all_single", 0) > 0) == trades, counts
    assert set(counts) <= {"all_gather_into_tensor", "reduce_scatter_tensor",
                           "all_reduce", "all_to_all_single", "broadcast_",
                           "scatter_"}, counts
    if sizes == (2, 2):
        assert counts.get("reduce_scatter_tensor", 0) > 0, counts


@pytest.mark.parametrize("run", GLOBAL_RUNS, ids=_run_id)
def test_sharded_step_equals_the_unsharded_port(sharded, run):
    """Loss, nll, aux, grad norm, every parameter and AdamW's first moment
    after one step on a (2,1), (1,2) or (2,2) mesh, with the global MoE
    dispatch (or the per-shard one on one data shard), equal the
    one-process port's on the same batch within ``RTOL`` of each tensor's
    largest value; the step's collectives (CommDebugMode): all-gathers of
    the ZeRO-sharded weights' data blocks, reduce-scatters and all-reduces
    of the gradients, the partial products, the loss and the global norm,
    and an all-to-all only where the global dispatch trades tokens."""
    got = torch.load(os.path.join(sharded, _run_file(run)))
    _close_step(got, *_unsharded(run),
                model_scale=run[1] in MODEL_SCALE_ARCHS and run[5] == F32)
    _check_collectives(got, run)


@pytest.mark.parametrize("run", MOE_RUNS, ids=_run_id)
def test_sharded_step_equals_the_reference_sharded_step(sharded, run):
    """mixtral's and llama4's sharded steps, with the global and the
    per-shard MoE dispatch, against the reference's ``lm_train_step`` under its
    ``ShardCtx`` on a mesh of the same shape, from the same parameters on
    the same global batch: the same tokens go to each dispatch, so the
    same ones are dropped; tolerances in the module's docstring."""
    got = torch.load(os.path.join(sharded, _run_file(run)))
    _close_to_reference(got, torch.load(os.path.join(
        sharded, _reference_file(run))))
    _check_collectives(got, run)


def test_one_rank_step_is_bit_equal_to_the_plain_port(sharded):
    """Checked in the rank (``_one_rank``); here that it finished."""
    with open(os.path.join(sharded, "one_rank.ok")) as f:
        assert f.read() == "bit-equal\n"


def test_local_dispatch_differs_from_the_global_one(sharded):
    """With 2 data shards the local dispatch counts capacity a shard, so
    its step is not the global dispatch's on the same mesh; with one data
    shard it is the same dispatch.  On (2, 2) the global run takes 2
    microbatches: each dispatches the rows 0-1 or 2-3, the same groups as
    the local dispatch's two data shards, so the aux losses agree."""
    def aux(sizes, local):
        return float(torch.load(os.path.join(sharded, _run_file(
            (sizes, "mixtral-8x22b", local, "none", 1, F32))))[
                "metrics"]["aux"])
    assert aux((2, 1), True) != aux((2, 1), False)
    np.testing.assert_allclose(aux((2, 2), True), aux((2, 2), False),
                               rtol=RTOL)
    np.testing.assert_allclose(aux((1, 2), True), aux((1, 2), False),
                               rtol=RTOL)


def test_sharded_prefill_and_decode_equal_the_unsharded_port(sharded):
    got = torch.load(os.path.join(sharded, "serve.pt"))
    cfg = _cfg("qwen3-4b")
    model = tr.TransformerLM(cfg, device="cpu")
    tokens, _ = _batch(cfg.vocab)
    logits, cache = steps.lm_prefill_step(model, tokens)
    _close(got["logits"], logits, "prefill logits")
    _close(got["k"], cache["k"], "cache k")
    from repro_torch.launch.serve import grow_cache
    step_logits, new = steps.lm_decode_step(
        model, grow_cache(cache, BATCH[1] + 1),
        torch.as_tensor(tokens[:, -1]).long())
    _close(got["step_logits"], step_logits, "decode logits")
    _close(got["k_after"], new["k"], "cache k after decode")
    # mixtral's and llama4's prefill (the global MoE dispatch on each
    # rank's expert blocks) on (1, 2) and (2, 2)
    for arch in MOE_ARCHS:
        model = tr.TransformerLM(_cfg(arch), device="cpu")
        logits, cache = steps.lm_prefill_step(model, tokens)
        for sizes in PREFILL_MESHES:
            got = torch.load(os.path.join(
                sharded, f"prefill-{_mesh_id(sizes)}-{arch}.pt"))
            what = f"{arch} prefill on {_mesh_id(sizes)}"
            _close(got["logits"], logits, f"{what}: logits")
            _close(got["k"], cache["k"], f"{what}: k")
            _close(got["v"], cache["v"], f"{what}: v")


def test_global_dispatch_over_two_data_axes(sharded):
    """mixtral's step on (pod, data, model) = (2, 2, 1), its tokens traded
    over "pod" and "data": metrics, parameters and first moments equal
    the unsharded port's within ``RTOL``."""
    got = torch.load(os.path.join(sharded, "pod.pt"))
    metrics, params, m = _unsharded(((2, 2), "mixtral-8x22b", False,
                                     "none", 1, F32))
    for key in ("loss", "nll", "aux", "grad_norm"):
        _close(got["metrics"][key], metrics[key], key)
    for n, p in params.items():
        _close(got["params"][n], p, n)
        _close(got["m"][n], m[n], f"m {n}")


@pytest.mark.parametrize("sizes", ODD_MESHES, ids=_mesh_id)
def test_attention_split_where_heads_do_not_divide(sharded, sizes):
    """5 query heads and 1 kv head over a model axis of 2: the prefill's
    logits and the step's metrics and parameters equal the unsharded
    port's within ``RTOL``."""
    got = torch.load(os.path.join(sharded,
                                  f"odd-heads-{_mesh_id(sizes)}.pt"))
    model = _model("qwen3-4b", dtype=F64, **ODD_HEADS)
    opt = adamw.init_state(model)
    tokens, labels = _batch(model.cfg.vocab)
    logits, _ = steps.lm_prefill_step(model, tokens)
    metrics = steps.lm_train_step(model, adamw.AdamWConfig(), opt, tokens,
                                  labels)
    _close(got["logits"], logits, "prefill logits")
    for key in ("loss", "nll", "grad_norm"):
        _close(got["metrics"][key], metrics[key], key)
    for n, p in model.named_parameters():
        _close(got["params"][n], p, n)


def test_attention_split_by_kv_head_groups(sharded):
    """``GROUPED_HEADS`` on (1, 4), f32: each rank of the model axis
    computes one kv-head group's attention on half the rows.  Against
    the unsharded port, the prefill's logits within ``RTOL`` of the
    largest |logit| and the step by ``_close_step`` (parameters at the
    model's largest, as llama4's f32 runs: the same zero-initialized norm
    scales); against the reference's sharded prefill and step on a (1, 4)
    mesh, the logits within ``RTOL`` of its largest |logit| and the step
    within the module docstring's tolerances."""
    assert [tr._attention_split(4, 2, 4, r) for r in range(4)] == [
        (slice(0, 2), slice(0, 1)), (slice(0, 2), slice(1, 2)),
        (slice(2, 4), slice(0, 1)), (slice(2, 4), slice(1, 2))]
    got = torch.load(os.path.join(sharded, "grouped-heads.pt"))
    model = _model("qwen3-4b", **GROUPED_HEADS)
    tokens, _ = _batch(model.cfg.vocab)
    logits, _ = steps.lm_prefill_step(model, tokens)
    _close(got["logits"], logits, "prefill logits")
    run = (GROUPED_MESH, "qwen3-4b", False, "none", 1, F32)
    _close_step(got, *_unsharded(run, **GROUPED_HEADS), model_scale=True)
    want = torch.load(os.path.join(sharded, "jax-grouped-heads.pt"))
    _close(got["logits"], want.pop("logits"),
           "prefill logits against the reference")
    _close_to_reference(got, want)


@pytest.mark.parametrize("case", TRAIN_COUNTED,
                         ids=lambda c: f"{c[0]}{'-local' if c[1] else ''}")
def test_sharded_train_step_moves_no_expert_or_table(sharded, case):
    """Every collective of a (2, 2) train step (``LocalCounter``): no
    result holds a whole (E, d, f) expert weight, an expert's whole f
    (``COUNTED_F``, which no other dimension of the step equals) or the
    whole (V, d) table; the global dispatch trades its tokens by
    all-to-alls over "data", the per-shard dispatch by none."""
    arch, local = case
    got = torch.load(os.path.join(sharded, "train-counted.pt"))[
        f"{arch}-{local}"]
    cfg = _cfg(arch)
    whole_expert = cfg.moe_experts * cfg.d_model * COUNTED_F
    table = cfg.vocab * cfg.d_model
    assert got["collectives"], "no collective recorded"
    assert math.isfinite(got["loss"])
    for kind, shapes, site in got["collectives"]:
        for shape in shapes:
            what = (kind, shape, site)
            assert math.prod(shape) < min(whole_expert, table), what
            assert COUNTED_F not in shape, what
            assert not (cfg.vocab in shape and cfg.d_model in shape), what
    trades = [c for c in got["collectives"] if c[0] == "all-to-all"]
    assert bool(trades) == (not local), trades


def test_restore_with_shardings_across_meshes(sharded):
    """The checks run in the ranks (``_restore_run``): a checkpoint
    written from (2, 1) restores onto (1, 2) bit for bit in the target
    placements, and a runner preempted at step 3 resumes onto a mesh to
    the uninterrupted run's state; here only that they wrote it."""
    assert os.path.isdir(os.path.join(sharded, "elastic", "step_00000000"))
    assert sorted(os.listdir(os.path.join(sharded, "runner"))) == [
        "step_00000002", "step_00000003", "step_00000004"]


def _decoded(case):
    """The unsharded port's decode step of ``case``."""
    cfg, cache, token = _decode_inputs(case)
    model = tr.TransformerLM(cfg, device="cpu")
    return steps.lm_decode_step(model, _torch_cache(cache),
                                torch.from_numpy(token))


@pytest.mark.parametrize("sizes", DECODE_MESHES, ids=_mesh_id)
@pytest.mark.parametrize("case", DECODE_CASES, ids=_decode_id)
def test_sharded_decode_equals_the_unsharded_port(sharded, case, sizes):
    """The sharded decode's logits (rows over "data", the vocabulary over
    "model"), new keys and values within ``RTOL`` of the one-process
    port's, ``length`` equal; the cache keeps ``kv_cache_shardings``'
    placements.  On the B 1 stream with 2 data ranks only data rank 1,
    which holds slot 5, writes its block."""
    got = torch.load(os.path.join(sharded, _decode_file(sizes, case)))
    logits, new = _decoded(case)
    _close(got["logits"], logits, "logits")
    _close(got["k"], new["k"], "k")
    _close(got["v"], new["v"], "v")
    assert torch.equal(got["length"], new["length"])
    place = sharding.kv_cache_shardings(
        _decode_mesh(sizes), tuple(new["k"].shape), case[1])
    assert got["cache_placements"] == str(place.placements)
    wrote = [json.load(open(os.path.join(sharded, _decode_file(
        sizes, case, f"wrote-{r}")))) for r in range(math.prod(sizes))]
    if case[1] == 1 and sizes[-2] == 2:
        assert "Shard(dim=2)" in got["cache_placements"]
        assert all(w["wrote"] == (w["data_rank"] == 1) for w in wrote), wrote
    else:
        assert all(w["wrote"] for w in wrote), wrote


@pytest.mark.parametrize("sizes", DECODE_MESHES, ids=_mesh_id)
@pytest.mark.parametrize("case", DECODE_CASES, ids=_decode_id)
def test_sharded_decode_equals_the_reference_decode(sharded, case, sizes):
    """Against the reference's GSPMD decode on a mesh of the same shape,
    from the same parameters and inputs: logits, new keys and values
    within ``RTOL`` of each tensor's largest |element|, ``length``
    equal."""
    got = torch.load(os.path.join(sharded, _decode_file(sizes, case)))
    want = np.load(os.path.join(sharded, f"jax-{_mesh_id(sizes)}-"
                                f"{_decode_id(case)}.npz"))
    for key in ("logits", "k", "v"):
        _close(got[key], torch.from_numpy(want[key]), key)
    assert np.array_equal(got["length"].numpy(), want["length"])


@pytest.mark.parametrize("case", DECODE_COUNTED, ids=_decode_id)
def test_sharded_decode_moves_no_parameter_or_cache_shard(sharded, case):
    """Every collective of a (2, 2) decode step (``LocalCounter``) is an
    all-gather, all-reduce or reduce-scatter whose payload is smaller than
    the cache's local shard and than every expert's local shard; for the
    dense model, than every parameter's of two or more dimensions too."""
    got = torch.load(os.path.join(sharded, "decode-counted.pt"))[
        _decode_id(case)]
    shards = [b for n, b in got["params"].items()
              if case[0] == "qwen3-4b" or ".moe.w_" in n]
    limit = min(shards + [got["cache"]])
    assert got["collectives"], "no collective recorded"
    kinds = {kind for kind, _, _ in got["collectives"]}
    assert kinds <= {"all-gather", "all-reduce", "reduce-scatter"}, kinds
    big = [c for c in got["collectives"] if c[1] >= limit]
    assert not big, (limit, big)


def test_decode_cache_in_other_placements_raises(sharded):
    """A prefill's cache (kv heads over "model") and a plain cache raise
    ``ValueError`` naming ``kv_cache_shardings``' placements; the
    prefill's cache after ``place_cache`` decodes to the unsharded
    port's prefill-then-decode."""
    got = torch.load(os.path.join(sharded, "decode-counted.pt"))
    assert len(got["errors"]) == 2, got["errors"]
    for e in got["errors"]:
        assert "kv_cache_shardings" in e and "Shard(dim=4)" in e, e
    assert "a plain tensor" in got["errors"][1]
    model = tr.TransformerLM(_cfg("qwen3-4b"), device="cpu")
    tokens, _ = _batch(model.cfg.vocab)
    _, cache = steps.lm_prefill_step(model, tokens)
    logits, new = steps.lm_decode_step(model, cache,
                                       torch.as_tensor(tokens[:, -1]).long())
    _close(got["after_prefill"]["logits"], logits, "logits")
    _close(got["after_prefill"]["k"], new["k"], "k")
