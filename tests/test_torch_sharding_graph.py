"""The sharded GNN and SASRec steps: ``gnn_train_step``, ``gnn_forward_step``
and ``rec_{train,serve,retrieval}_step`` under a ``ShardCtx`` in ``gloo``
processes on the CPU, with the reference's placements (node and edge
arrays over every mesh axis, GNN parameters replicated; the item table's
rows over "model", the batch over the data axes).

  (a) gcn-cora, gin-tu, schnet and mace (registry smoke configs, f32) on a
      seeded graph of two components, each with a hub whose in-edges pass
      ``gin.K_CAP`` and come from every node shard, and SASRec (smoke
      config) through train, serve and retrieval, at (1, 1), (1, 2),
      (2, 1) and (2, 2): after one step the metrics, every parameter and
      AdamW's first moment, and the forward and serving outputs, equal
      the unsharded port's on the same batch;
  (b) at (2, 2) the same steps against the reference's, jitted with its
      own ``flat_shard`` and ``rec_param_shardings`` placements on 4 host
      devices (one subprocess, started beside the ranks);
  (c) each region against the global plain op: ``segment_matmul`` and its
      backward, ``dedup_gather`` with keys < 0, keys >= V and keys
      repeated across the table's shards, and its backward.

Tolerances, stated before measuring:
- (a): every metric and output within ``RTOL`` (1e-5) of the largest
  |value| of the unsharded port's tensor, every parameter and first
  moment within ``RTOL`` of the largest |value| over all the model's
  parameters or moments (the sharded step sums the same terms in another
  order, partial sums over the ranks; a bias whose gradient is rounding
  noise moves by lr times that noise's sign);
- (b): those of the unsharded parity tests (``tests/test_torch_gnn.py``,
  ``tests/test_torch_gnn_models.py``, ``tests/test_torch_recsys.py``):
  loss and grad norm within 1e-5 relative; parameters within 2 lr;
  moments within 1e-3 of each element plus 1e-3 of the tensor's RMS;
  outputs within 1e-5 of the largest |value| (gin-tu's logits 1e-4: five
  layers of sums in other orders, hub rows apart);
- (c): forward values bit-equal (each rank runs the plain op on its rows,
  and a row read on another model rank is a zero added); gradients within
  1e-6 of the largest |value| (partial sums reduced across ranks).
"""
import dataclasses
import json
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
from repro_torch.data.graphs import _to_batch
from repro_torch.data.recsys import RecStreamConfig, batch_at_step
from repro_torch.graph import generators as gen
from repro_torch.graph.coo import UGraph
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import steps
from repro_torch.models.gnn import gin
from repro_torch.models.gnn.common import split_neighbors
from repro_torch.models.sasrec import SASRec
from repro_torch.optim import adamw
from repro_torch.placement import ShardCtx

JOIN_TIMEOUT_S = 300
AXES = ("data", "model")
# the (2, 2) mesh is (b)'s, the reference's
MESHES = ((1, 1), (1, 2), (2, 1), (2, 2))
GNN_ARCHS = ("gcn-cora", "gin-tu", "schnet", "mace")
RTOL = 1e-5
# the graph: two components of COMPONENT nodes, padded to PAD_NODES rows
COMPONENT, PAD_NODES, D_FEAT = 46, 96, 64
# each component's hub: node 3 (node shard 0 of 4) and node 46 + 27 (3)
HUBS = (3, COMPONENT + 27)
# SASRec: B users of the smoke config's stream, C candidates each
REC_B, REC_C = 16, 24


def _opt_cfg():
    return adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=100)


# ------------------------------------------------------------------- data
def _graph_batch():
    """The graph of (a) as a port batch on the CPU: two components, each a
    hub joined to every other node of it plus an Erdos-Renyi graph, 4
    padding rows and masked padding edges up to a multiple of 4; node
    features, positions (1.5 N(0, 1), inside both cutoffs) and species
    below 10 from one seed."""
    parts = []
    for c, hub in enumerate(HUBS):
        off = c * COMPONENT
        parts.append([(o, hub) for o in range(off, off + COMPONENT)
                      if o != hub])
        parts.append(gen.erdos_renyi(COMPONENT, 3.0, seed=c).edges + off)
    g = UGraph(2 * COMPONENT, np.concatenate([np.asarray(p, np.int32)
                                              for p in parts]))
    rng = np.random.default_rng(7)
    n = g.n
    return _to_batch(
        g, node_feat=(0.1 * rng.standard_normal((n, D_FEAT))).astype(
            np.float32),
        positions=(1.5 * rng.standard_normal((n, 3))).astype(np.float32),
        species=rng.integers(0, 10, n).astype(np.int32),
        graph_ids=np.repeat(np.arange(2, dtype=np.int32), COMPONENT),
        n_graphs=2, pad_nodes=PAD_NODES,
        pad_edges=4 * (-(-(2 * g.m + 5) // 4)), device="cpu")


def _gnn_case(arch):
    """(config, batch) of ``arch`` on the graph: gcn-cora's input width
    set to D_FEAT and (N,) node labels; gin-tu with its neighbour table
    and overflow and (n_graphs,) labels; SchNet and MACE (n_graphs,)
    energies."""
    cfg = registry.get(arch).smoke_config
    batch = _graph_batch()
    rng = np.random.default_rng(11)
    if arch == "gcn-cora":
        cfg = dataclasses.replace(cfg, d_feat=D_FEAT)
        labels = torch.from_numpy(rng.integers(
            0, cfg.n_classes, PAD_NODES).astype(np.int32))
    elif arch == "gin-tu":
        nbr, over_s, over_r = split_neighbors(
            batch.senders, batch.receivers, batch.edge_mask, PAD_NODES,
            cap=gin.K_CAP)
        hubs, hub_of = torch.unique_consecutive(over_r, return_inverse=True)
        assert hubs.tolist() == list(HUBS), hubs
        batch = dataclasses.replace(batch, nbr=nbr,
                                    overflow=(over_s, hub_of, hubs))
        # the sum readout's logits are large (a graph labelled with its
        # larger logit has no gradient): graph 0 takes its smaller logit's
        # label, graph 1 its larger's, so their gradients do not cancel
        with torch.no_grad():
            logits = gin.GIN(cfg, device="cpu", seed=0)(batch)
        labels = torch.stack([logits[0].argmin(), logits[1].argmax()]).to(
            torch.int32)
    else:
        labels = torch.from_numpy(rng.standard_normal(2).astype(np.float32))
    return cfg, dataclasses.replace(batch, labels=labels)


def _rec_batch():
    """(seq, pos, neg, candidates) numpy int32: the smoke config's stream
    at step 1, candidates from a seed (0 and past-the-end ids included)."""
    cfg = registry.get("sasrec").smoke_config
    seq, pos, neg = batch_at_step(RecStreamConfig(cfg.n_items, cfg.seq_len,
                                                  REC_B), 1)
    cand = np.random.default_rng(5).integers(
        0, cfg.n_items, (REC_B, REC_C)).astype(np.int32)
    return seq, pos, neg, cand


# ----------------------------------------------------- the steps, any mesh
def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _gnn_run(arch, sctx):
    """gnn_forward_step, then one gnn_train_step, from seed 0's
    parameters: {forward, metrics, params, m} as full CPU tensors."""
    cfg, batch = _gnn_case(arch)
    model = steps.GNN_MODELS[arch](cfg, device="cpu", seed=0)
    opt = adamw.init_state(model)
    if sctx is not None:
        steps.place_gnn(model, opt, sctx)
    fwd = _full(steps.gnn_forward_step(model, batch, sctx=sctx))
    met = steps.gnn_train_step(model, _opt_cfg(), opt, batch, sctx=sctx)
    return {"forward": fwd, "metrics": met,
            "params": {n: _full(p.detach())
                       for n, p in model.named_parameters()},
            "m": {n: _full(t) for n, t in opt["m"].items()}}


def _rec_run(sctx):
    """rec_serve_step and rec_retrieval_step (the first user, B 1, which
    no data split divides), then one rec_train_step."""
    seq, pos, neg, cand = _rec_batch()
    model = SASRec(registry.get("sasrec").smoke_config, device="cpu",
                   seed=0)
    opt = adamw.init_state(model)
    if sctx is not None:
        steps.place_rec(model, opt, sctx)
    serve = _full(steps.rec_serve_step(model, seq, cand, sctx=sctx))
    retrieval = steps.rec_retrieval_step(model, seq[:1], sctx=sctx)
    placements = None if sctx is None else str(retrieval.placements)
    met = steps.rec_train_step(model, _opt_cfg(), opt, seq, pos, neg,
                               sctx=sctx)
    return {"forward": serve, "retrieval": _full(retrieval),
            "retrieval_placements": placements, "metrics": met,
            "params": {n: _full(p.detach())
                       for n, p in model.named_parameters()},
            "m": {n: _full(t) for n, t in opt["m"].items()}}


def _regions(sctx):
    """(c): each region's forward and gradients under ``sctx``, as full
    tensors, beside the global plain op's."""
    from repro_torch.core.dht import dedup_gather
    from repro_torch.kernels.segment_matmul.ops import segment_matmul
    from repro_torch.launch.sharding import (Sharding, flat_shard,
                                            rec_param_shardings)
    rng = np.random.default_rng(3)
    N, D, F, K = 32, 7, 5, 6
    x = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((D, F)).astype(np.float32))
    nbr = torch.from_numpy(rng.integers(-1, N, (N, K)).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((N, F)).astype(np.float32))
    V, E = 40, 9
    table = torch.from_numpy(rng.standard_normal((V, E)).astype(np.float32))
    # each row: a negative key, one past the end, and ids from every
    # quarter of the table (every model rank's rows), some repeated
    keys = rng.integers(0, V, (8, 12)).astype(np.int32)
    keys[:, 0], keys[:, 1], keys[:, 2] = -3, V + 5, keys[:, 3]
    keys = torch.from_numpy(keys)
    gk = torch.from_numpy(rng.standard_normal((8, 12, E)).astype(np.float32))

    def seg(xx, ww, nb, gg, ctx):
        out = segment_matmul(xx, nb, ww, sctx=ctx)
        (out * gg).sum().backward()
        return out

    def dedup(tab, kk, gg, ctx):
        out = dedup_gather(tab, kk, sctx=ctx)
        (out * gg).sum().backward()
        return out

    found = {}
    xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
    found["seg_plain"] = (seg(xp, wp, nbr, g, None).detach(), xp.grad,
                          wp.grad)
    def rows(t):
        return flat_shard(sctx.mesh, t.dim()).distribute(t)

    xs = rows(x.clone()).requires_grad_()
    ws = Sharding(sctx.mesh).distribute(w.clone()).requires_grad_()
    out = seg(xs, ws, rows(nbr), rows(g), sctx)
    found["seg_sharded"] = (_full(out.detach()), _full(xs.grad),
                            _full(ws.grad))
    tp = table.clone().requires_grad_()
    found["dedup_plain"] = (dedup(tp, keys, gk, None).detach(), tp.grad)
    sh = rec_param_shardings(sctx.mesh, {"item_embed": table})["item_embed"]
    ts = sh.distribute(table.clone()).requires_grad_()
    out = dedup(ts, sctx.batch(keys), sctx.batch(gk), sctx)
    found["dedup_sharded"] = (_full(out.detach()), _full(ts.grad))
    found["dedup_table_placements"] = str(ts.placements)
    return found


def _mesh_run(sizes):
    mesh = lmesh.make_mesh(lmesh.MeshShape(sizes, AXES), "cpu")
    sctx = ShardCtx(mesh, "data")
    found = {arch: _gnn_run(arch, sctx) for arch in GNN_ARCHS}
    found["sasrec"] = _rec_run(sctx)
    found["regions"] = _regions(sctx)
    return found


# --------------------------------------------------------- gloo processes
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, world, port, out_dir, meshes):
    import faulthandler
    import torch.distributed as dist
    torch.set_num_threads(1)
    stacks = open(os.path.join(out_dir, f"stacks-{world}-{rank}.txt"), "w")
    faulthandler.dump_traceback_later(JOIN_TIMEOUT_S - 20, file=stacks)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=rank, world_size=world)
    try:
        for sizes in meshes:
            found = _mesh_run(sizes)
            if rank == 0:
                torch.save(found, os.path.join(out_dir, f"{sizes}.pt"))
    finally:
        faulthandler.cancel_dump_traceback_later()
        stacks.close()
        dist.destroy_process_group()


def _start(world, out_dir, meshes):
    return mp.start_processes(_worker, args=(world, _free_port(), out_dir,
                                             meshes),
                              nprocs=world, join=False, start_method="spawn")


def _join(ctx, world, out_dir, deadline):
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            for p in ctx.processes:
                p.join(10)
            stacks = "".join(
                open(os.path.join(out_dir, f)).read()
                for f in sorted(os.listdir(out_dir))
                if f.startswith(f"stacks-{world}-"))
            pytest.fail(f"{world} gloo ranks hung past {JOIN_TIMEOUT_S} s:"
                        f"\n{stacks}")
    assert all(not p.is_alive() for p in ctx.processes)


# the reference's sharded steps on a (2, 2) mesh of 4 host devices, from
# the port's seed-0 parameters on the same batches, jitted with the
# reference's placements (``launch/specs.py``'s ``_gnn_lowerable`` and
# ``_rec_lowerable``); written as port tensors to argv[1]
REFERENCE_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, functools, sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    import torch
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import registry as jreg
    from repro.launch import sharding as jsh
    from repro.launch import steps as jsteps
    from repro.models.gnn import common as jcommon
    from repro.optim import adamw as jadamw
    from repro_torch import convert
    from repro_torch.configs import registry
    from repro_torch.launch.steps import GNN_MODELS
    from repro_torch.models.sasrec import SASRec
    sys.path.insert(0, os.path.dirname(sys.argv[2]))
    import test_torch_sharding_graph as t

    assert len(jax.devices()) == 4
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    rep = NamedSharding(mesh, P())
    opt_cfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=100)
    FIELDS = ("senders", "receivers", "node_mask", "edge_mask", "graph_ids",
              "node_feat", "positions", "species", "labels")
    out = {}

    def arrays(tree):
        return jax.tree.map(np.asarray, tree)

    for arch in t.GNN_ARCHS:
        cfg, batch = t._gnn_case(arch)
        jcfg = jreg.get(arch).smoke_config
        if arch == "gcn-cora":
            jcfg = dataclasses.replace(jcfg, d_feat=cfg.d_feat)
        model = GNN_MODELS[arch](cfg, device="cpu", seed=0)
        if arch == "gin-tu":
            to_ref, from_ref, named = (convert.gnn_params_to_reference,
                                       convert.gnn_params_from_reference,
                                       convert.named_gnn_params)
        else:
            to_ref, named = (convert.graph_params_to_reference,
                             convert.named_graph_params)
            from_ref = {"gcn-cora": convert.gcn_params_from_reference,
                        "schnet": convert.schnet_params_from_reference,
                        "mace": convert.mace_params_from_reference}[arch]
        params = jax.tree.map(jnp.asarray, to_ref(model))
        opt = jadamw.init_state(params)
        fs = functools.partial(jsh.flat_shard, mesh)
        node_labels = batch.labels.shape[0] == batch.n_nodes
        jb = jcommon.GraphBatch(n_graphs=batch.n_graphs, **{
            f: None if getattr(batch, f) is None
            else jnp.asarray(getattr(batch, f).numpy()) for f in FIELDS})
        sh = jcommon.GraphBatch(n_graphs=batch.n_graphs, **{
            f: None if getattr(batch, f) is None
            else (rep if f == "labels" and not node_labels
                  else fs(getattr(batch, f).dim())) for f in FIELDS})
        p_sh = jsh.replicated(mesh, params)
        o_sh = jsh.replicated(mesh, opt)
        step = jax.jit(functools.partial(jsteps.gnn_train_step, arch, jcfg,
                                         opt_cfg),
                       in_shardings=(p_sh, o_sh, sh))
        fwd = jax.jit(functools.partial(jsteps.gnn_forward_step, arch, jcfg),
                      in_shardings=(p_sh, sh))
        forward = np.asarray(fwd(params, jb))
        new, opt, met = step(params, opt, jb)
        out[arch] = {
            "forward": torch.from_numpy(forward),
            "metrics": {k: float(v) for k, v in met.items()},
            "params": named(from_ref(cfg, arrays(new))),
            "m": named(from_ref(cfg, arrays(opt["m"])))}

    cfg = registry.get("sasrec").smoke_config
    jcfg = jreg.get("sasrec").smoke_config
    model = SASRec(cfg, device="cpu", seed=0)
    params = jax.tree.map(jnp.asarray, convert.rec_params_to_reference(model))
    opt = jadamw.init_state(params)
    seq, pos, neg, cand = (jnp.asarray(a) for a in t._rec_batch())
    p_sh = jsh.rec_param_shardings(mesh, params)
    o_sh = {"m": jsh.rec_param_shardings(mesh, opt["m"]),
            "v": jsh.rec_param_shardings(mesh, opt["v"]), "step": rep}
    b2 = jsh.batch_sharding(mesh, 2)
    serve = jax.jit(functools.partial(jsteps.rec_serve_step, jcfg),
                    in_shardings=(p_sh, b2, b2))(params, seq, cand)
    retrieval = jax.jit(functools.partial(jsteps.rec_retrieval_step, jcfg),
                        in_shardings=(p_sh, rep))(params, seq[:1])
    step = jax.jit(functools.partial(jsteps.rec_train_step, jcfg, opt_cfg),
                   in_shardings=(p_sh, o_sh, b2, b2, b2))
    new, opt, met = step(params, opt, seq, pos, neg)

    def rec_named(tree):
        return convert.named_rec_params(
            convert.rec_params_from_reference(cfg, arrays(tree)))
    out["sasrec"] = {"forward": torch.from_numpy(np.asarray(serve)),
                     "retrieval": torch.from_numpy(np.asarray(retrieval)),
                     "metrics": {k: float(v) for k, v in met.items()},
                     "params": rec_named(new), "m": rec_named(opt["m"])}
    torch.save(out, sys.argv[1])
    print("REFERENCE_OK")
""")


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The reference's subprocess and the gloo worlds of 1, 2 and 4 ranks,
    all started together; rank 0 of each writes its meshes' results."""
    out = str(tmp_path_factory.mktemp("sharded_graph"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in [env.get("PYTHONPATH")] if p])
    ref_path = os.path.join(out, "reference.pt")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE_SCRIPT, ref_path,
                            os.path.abspath(__file__)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        worlds = {1: [(1, 1)], 2: [(1, 2), (2, 1)], 4: [(2, 2)]}
        ctxs = {w: _start(w, out, m) for w, m in worlds.items()}
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for w, ctx in ctxs.items():
            _join(ctx, w, out, deadline)
        stdout, stderr = ref.communicate(timeout=JOIN_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "REFERENCE_OK" in stdout, stderr[-3000:]
    found = {sizes: torch.load(os.path.join(out, f"{sizes}.pt"))
             for sizes in MESHES}
    found["reference"] = torch.load(ref_path)
    return found


@pytest.fixture(scope="module")
def unsharded():
    found = {arch: _gnn_run(arch, None) for arch in GNN_ARCHS}
    found["sasrec"] = _rec_run(None)
    found["regions"] = None
    return found


def _close(got, want, what, rtol=RTOL):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(want.abs().max()) if want.numel() else 0.0, 1e-30)
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


MODELS = GNN_ARCHS + ("sasrec",)


# ---------------------------------------------------------------- (a)
@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", MODELS)
def test_sharded_step_equals_the_unsharded_port(sharded, unsharded, arch,
                                                sizes):
    got, want = sharded[sizes][arch], unsharded[arch]
    for key in want["metrics"]:
        _close(got["metrics"][key], want["metrics"][key], key)
    _close(got["forward"], want["forward"], "forward")
    if arch == "sasrec":
        _close(got["retrieval"], want["retrieval"], "retrieval")
        # the scores stay split over the model axis on the item dimension
        assert "Shard(dim=1)" in got["retrieval_placements"] \
            or sizes[1] == 1, got["retrieval_placements"]
    assert set(got["params"]) == set(want["params"])
    for key in ("params", "m"):
        scale = max(float(t.abs().max()) for t in want[key].values())
        for n, t in want[key].items():
            err = float((got[key][n].double() - t.double()).abs().max())
            assert err <= RTOL * scale, f"{key} {n}: {err} > {RTOL} * {scale}"


def test_the_graph_has_hubs_whose_edges_cross_shards():
    """gin-tu's overflow: each hub's in-edges past ``K_CAP`` come from node
    rows of all 4 shards of the (2, 2) mesh, and its own row lies in the
    first or the last shard."""
    _, batch = _gnn_case("gin-tu")
    over_s, hub_of, hubs = batch.overflow
    rows = PAD_NODES // 4
    assert hubs.tolist() == list(HUBS)
    assert [h // rows for h in HUBS] == [0, 3]
    for j in range(len(HUBS)):
        assert len(set((over_s[hub_of == j] // rows).tolist())) >= 2
    assert batch.n_nodes % 4 == 0 and batch.senders.shape[0] % 4 == 0


# ---------------------------------------------------------------- (b)
def _moments_close(got, want, rtol=1e-3, floor=1e-3):
    got, want = got.double(), torch.as_tensor(want).double()
    rms = float(want.pow(2).mean().sqrt())
    return float((((got - want).abs() - rtol * want.abs() - floor * rms)
                  .max())) <= 0.0


@pytest.mark.parametrize("arch", MODELS)
def test_sharded_step_equals_the_reference_sharded_step(sharded, arch):
    got, want = sharded[(2, 2)][arch], sharded["reference"][arch]
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got["metrics"][key]),
                                   want["metrics"][key], rtol=1e-5,
                                   err_msg=key)
    _close(got["forward"], want["forward"], "forward",
           1e-4 if arch == "gin-tu" else RTOL)
    if arch == "sasrec":
        _close(got["retrieval"], want["retrieval"], "retrieval")
    lr = want["metrics"]["lr"]
    assert set(got["params"]) == set(want["params"])
    for n, p in want["params"].items():
        assert float((got["params"][n] - p).abs().max()) <= 2 * lr, n
        assert _moments_close(got["m"][n], want["m"][n]), f"m {n}"


# ---------------------------------------------------------------- (c)
@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("op", ["seg", "dedup"])
def test_regions_equal_the_global_plain_op(sharded, op, sizes):
    found = sharded[sizes]["regions"]
    plain, got = found[f"{op}_plain"], found[f"{op}_sharded"]
    assert torch.equal(got[0], plain[0]), f"{op} forward"
    for i, (g, p) in enumerate(zip(got[1:], plain[1:])):
        _close(g, p, f"{op} gradient {i}", 1e-6)
    if op == "dedup" and sizes[1] > 1:
        # the table's gradient stays split over the model axis
        assert found["dedup_table_placements"].endswith(
            "Shard(dim=0))"), found["dedup_table_placements"]


def test_steps_need_a_placed_state():
    """A sharded step on a state no ``place_*`` placed raises (a one-rank
    group in this process)."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import fake_group
    fake_group(1)
    try:
        mesh = lmesh.make_mesh(lmesh.MeshShape((1, 1), AXES), "cpu")
        sctx = ShardCtx(mesh, "data")
        cfg, batch = _gnn_case("gcn-cora")
        model = steps.GNN_MODELS["gcn-cora"](cfg, device="cpu")
        with pytest.raises(ValueError, match="place_gnn"):
            steps.gnn_train_step(model, _opt_cfg(), adamw.init_state(model),
                                 batch, sctx=sctx)
        rec = SASRec(registry.get("sasrec").smoke_config, device="cpu")
        with pytest.raises(ValueError, match="place_rec"):
            steps.rec_serve_step(rec, *_rec_batch()[::3], sctx=sctx)
    finally:
        dist.destroy_process_group()


def test_results_are_json_free_of_nans(sharded):
    """Every sharded metric is finite."""
    for sizes in MESHES:
        for arch in MODELS:
            mets = sharded[sizes][arch]["metrics"]
            assert all(np.isfinite(float(v)) for v in mets.values()), \
                json.dumps({k: float(v) for k, v in mets.items()})
