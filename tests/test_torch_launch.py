"""The port's launch layer against the JAX package's: the registry's cells,
every cell's input specs and model FLOPs, the LMs' parameter leaves, the
dry-run's counts, ``shard_of_batch`` and ``yoshida_mis_queries``.

The reference builds its cells from ``jax.eval_shape`` on a 1-device mesh
(and, for the GNN padding, on 8 host devices in a subprocess); the port
builds them on the ``meta`` device.  The port keeps one parameter a layer
where the reference stacks the layers into one leaf: a port leaf
``layers.<i>.<path>`` is layer i of the reference's ``layers/<path>``.
"""
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import textwrap
from collections import defaultdict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import registry as jreg
from repro.core import oracle as joracle
from repro.data import tokens as jtokens
from repro.graph import generators as jgen
from repro.launch import sharding as jsharding
from repro.launch import specs as jspecs
from repro.models import transformer as jtr
from repro_torch.configs import registry
from repro_torch.convert import graph_from_reference
from repro_torch.core import oracle
from repro_torch.data import tokens
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.launch import dryrun, specs, steps
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.sharding import param_path
from repro_torch.models.transformer import TransformerLM

REPO = Path(__file__).resolve().parents[1]
ONE = MeshShape((1, 1), ("data", "model"))
CELLS = [(a, s) for a, s, skip in registry.all_cells() if skip is None]
LM_ARCHS = [a for a, e in registry.REGISTRY.items() if e.family == "lm"]


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _sds(x):
    return (tuple(x.shape), str(np.dtype(x.dtype)))


def _meta(t):
    return (tuple(t.shape), _name(t.dtype))


def _stacked(named):
    """{reference path: (shape, dtype)} of a port name -> tensor mapping,
    each layer's leaves stacked on a leading L axis as the reference's."""
    groups = defaultdict(list)
    for name, t in named.items():
        groups[param_path(name)].append(t)
    out = {}
    for path, ts in groups.items():
        shape = tuple(ts[0].shape)
        if path.startswith("layers/"):
            shape = (len(ts),) + shape
        out[path] = (shape, _name(ts[0].dtype))
    return out


def _ref_leaves(tree):
    flat, _ = jsharding._tree_paths(tree)
    return {path: _sds(leaf) for path, leaf in flat}


# the reference's bf16 init multiplies these weights by an np.float64
# scale, which promotes them to f32 (ROADMAP queue 3); the port keeps bf16
_F32_IN_REFERENCE = re.compile(r"(attn/w[qkvo]|mlp/w_|moe/)")


def _assert_lm_params(model, want_tree):
    """The port's bf16 leaves against the reference's ``eval_shape`` of
    its bf16 init: the same paths and shapes, the port's all bf16 where
    the reference's np.float64-scaled weights are f32."""
    got = _stacked(dict(model.named_parameters()))
    want = _ref_leaves(want_tree)
    assert {k: s for k, (s, _) in got.items()} == \
        {k: s for k, (s, _) in want.items()}
    for path, (_, dtype) in want.items():
        assert got[path][1] == "bfloat16", path
        assert dtype == ("float32" if _F32_IN_REFERENCE.search(path)
                         else "bfloat16"), path


@pytest.fixture(scope="module")
def jax_one_mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def test_all_cells_equal_the_reference():
    assert list(registry.all_cells()) == list(jreg.all_cells())
    assert len(CELLS) == 37
    skipped = [(a, s) for a, s, r in registry.all_cells() if r]
    assert skipped == [("qwen2.5-32b", "long_500k"), ("qwen3-4b", "long_500k"),
                       ("llama4-scout-17b-a16e", "long_500k")]


@pytest.mark.parametrize("arch", list(registry.REGISTRY))
def test_cell_inputs_and_model_flops_equal_the_reference(arch, jax_one_mesh):
    """Every cell of ``arch``: its arguments' shapes and dtypes (the
    parameters leaf by leaf, the optimizer state, tokens, cache, graph
    batch, histories) and ``model_flops`` equal the reference's
    ``build_lowerable`` on a 1-device mesh."""
    entry = registry.get(arch)
    for shape in entry.shapes:
        if entry.skip_shapes.get(shape):
            continue
        want = jspecs.build_lowerable(arch, shape, jax_one_mesh)
        got = specs.build_cell(arch, shape, ONE)
        assert got.model_flops == want.model_flops, shape
        assert got.donate_argnums == want.donate_argnums, shape
        if entry.family == "lm":
            _assert_lm_params(got.args[0], want.args[0])
            if got.kind == "train":
                for key in ("m", "v"):
                    assert _stacked(got.args[1][key]) == _ref_leaves(
                        want.args[1][key])
                assert _meta(got.args[1]["step"]) == _sds(want.args[1]["step"])
                assert [_meta(t) for t in got.args[2:]] == \
                    [_sds(t) for t in want.args[2:]]
            elif got.kind == "prefill":
                assert _meta(got.args[1]) == _sds(want.args[1])
            else:
                assert {k: _meta(t) for k, t in got.args[1].items()} == \
                    {k: _sds(t) for k, t in want.args[1].items()}
                assert _meta(got.args[2]) == _sds(want.args[2])
                assert got.notes == want.notes
        elif entry.family == "gnn":
            gb, wb = got.args[2], want.args[2]
            assert gb.n_graphs == wb.n_graphs
            for f in ("senders", "receivers", "node_mask", "edge_mask",
                      "graph_ids", "node_feat", "positions", "species",
                      "labels"):
                w = getattr(wb, f)
                g = getattr(gb, f)
                assert (g is None) == (w is None), (shape, f)
                if w is not None:
                    assert _meta(g) == _sds(w), (shape, f)
            ref = sorted(_ref_leaves(want.args[0]).values())
            assert sorted(_meta(p) for p in got.args[0].parameters()) == ref
        else:
            first = 1
            if got.kind == "rec_train":
                first = 2
                for key in ("m", "v"):
                    got_m = sorted(_meta(t) for t in got.args[1][key].values())
                    assert got_m == sorted(
                        _ref_leaves(want.args[1][key]).values())
            assert [_meta(t) for t in got.args[first:]] == \
                [_sds(t) for t in want.args[first:]], shape
            ref = _ref_leaves(want.args[0])
            assert sum(np.prod(s) for s, _ in ref.values()) == sum(
                p.numel() for p in got.args[0].parameters())


GNN_PADDING = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from repro.configs import registry
    from repro.launch import specs
    assert len(jax.devices()) == 8
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    out = {}
    for arch, shape, skip in registry.all_cells():
        if registry.get(arch).family != "gnn":
            continue
        low = specs.build_lowerable(arch, shape, mesh)
        b = low.args[2]
        out[arch + "/" + shape] = {
            "flops": low.model_flops,
            **{f: list(getattr(b, f).shape) for f in
               ("senders", "node_mask", "graph_ids", "labels")}}
    print(json.dumps(out))
""")


def test_gnn_padding_to_the_chip_count_equals_the_reference():
    """On 8 chips every GNN cell pads its nodes and edges to a multiple of
    8, as the reference's does on 8 host devices."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", GNN_PADDING], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    mesh = MeshShape((2, 4), ("data", "model"))
    assert len(want) == 16
    for key, w in want.items():
        arch, shape = key.split("/")
        cell = specs.build_cell(arch, shape, mesh)
        b = cell.args[2]
        assert cell.model_flops == w["flops"], key
        for f in ("senders", "node_mask", "graph_ids", "labels"):
            assert list(getattr(b, f).shape) == w[f], (key, f)
        assert b.senders.shape[0] % 8 == 0 and b.n_nodes % 8 == 0


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_meta_parameters_equal_the_reference_leaves(arch):
    """The full config built on ``meta``: every leaf's shape equals the
    reference's ``jax.eval_shape(init_params)`` leaf (layers stacked; the
    port's bf16 where the reference's scaled weights come out f32), and
    the count is ``param_count()`` plus the qk-norm scales and the QKV
    biases, which ``param_count()`` leaves out (ROADMAP queue 3)."""
    cfg = registry.get(arch).config
    model = TransformerLM(cfg, device="meta", dtype=torch.bfloat16)
    jcfg = jreg.get(arch).config
    want = jax.eval_shape(functools.partial(jtr.init_params, jcfg,
                                            dtype=jnp.bfloat16),
                          jax.random.PRNGKey(0))
    _assert_lm_params(model, want)
    n = sum(p.numel() for p in model.parameters())
    qk = 2 * cfg.head_dim * cfg.n_layers if cfg.qk_norm else 0
    bias = ((cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim * cfg.n_layers
            if cfg.qkv_bias else 0)
    assert n == cfg.param_count() + qk + bias
    assert all(p.device.type == "meta" for p in model.parameters())


def _smoke_overrides(arch):
    smoke = registry.get(arch).smoke_config
    return {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)
            if f.name not in ("name", "attention_impl", "remat")}


@pytest.mark.parametrize("arch", ["qwen3-4b", "mixtral-8x22b"])
def test_dry_run_flops_equal_a_real_cpu_run(arch):
    """The dry-run's FLOPs of a smoke prefill (B 2, S 64) on ``meta``
    equal ``FlopCounterMode``'s count of the same step run for real on the
    CPU; and the flash kernels' formula counts what the plain attention's
    products do where every pair is kept."""
    cell = specs.build_cell(arch, "prefill_32k", ONE,
                            overrides=_smoke_overrides(arch),
                            shape_overrides={"global_batch": 2,
                                             "seq_len": 64})
    rec = dryrun.measure(cell)
    model = TransformerLM(cell.args[0].cfg, device="cpu",
                          dtype=torch.bfloat16)
    counter = FlopCounterMode(display=False)
    with counter:
        steps.lm_prefill_step(model, np.zeros((2, 64), np.int32))
    assert rec["flops"] == counter.get_total_flops() > 0
    assert rec["flops_kernels"] == {}
    assert rec["params"] == sum(p.numel() for p in model.parameters())
    assert rec["fits_h100_80gb"] and rec["peak_bytes"] >= rec["param_bytes"]

    q = torch.zeros((2, 16, 4, 8))
    k = torch.zeros((2, 24, 2, 8))
    counter = FlopCounterMode(display=False)
    with counter:
        attention_ref(q, k, k, causal=False)
    assert flash_ref.attention_flops(q, k, False, 0, 2) == \
        counter.get_total_flops()


def test_dry_run_counts_the_kernels_on_meta():
    """A smoke training step on ``meta`` counts the flash forward, dq and
    dk/dv by formula (4, 6 and 8 multiply-adds a kept pair and head
    width; the forward twice, as ``remat="dots"`` recomputes it), and a
    gin-tu cell its ``segment_matmul``'s work; the state's
    bytes are the parameters' and AdamW's, whose allocator-rounded sum
    is what the card allocates for them."""
    cell = specs.build_cell("qwen3-4b", "train_4k", ONE,
                            overrides=_smoke_overrides("qwen3-4b"),
                            shape_overrides={"global_batch": 2,
                                             "seq_len": 32})
    cfg = cell.args[0].cfg
    rec = dryrun.measure(cell)
    pairs = flash_ref.attention_pairs(32, 32, True, 0)
    per = 2 * 2 * cfg.n_heads * cfg.head_dim * pairs * cfg.n_layers
    assert rec["flops_kernels"] == {
        "flash_attention_fwd": 2 * 2 * per, "flash_attention_bwd_dq": 3 * per,
        "flash_attention_bwd_dkv": 4 * per}
    n = rec["params"]
    assert rec["param_bytes"] == rec["grad_bytes"] == 2 * n   # bf16
    assert rec["opt_bytes"] == 8 * n + 4                      # f32 m, v
    assert rec["state_alloc_bytes"] >= rec["param_bytes"] + rec["opt_bytes"]
    assert rec["flops"] == rec["flops_counted"] + 11 * per
    gin = dryrun.measure(specs.build_cell("gin-tu", "molecule", ONE))
    assert gin["flops_kernels"]["segment_matmul"] > 0


def test_dry_run_cli_records_ok_and_skipped(tmp_path, capsys):
    out = tmp_path / "cells.jsonl"
    assert dryrun.main(["--arch", "gcn-cora", "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["status"] for r in recs] == ["ok"] * 4 + ["skipped"]
    assert recs[-1]["reason"] == jreg.get("qwen3-4b").skip_shapes["long_500k"]
    for r in recs[:4]:
        assert set(r["device_bytes"]) == {"16x16", "2x16x16"}
        assert r["roofline"]["dominant"] in ("compute", "memory")
    assert "OK gcn-cora molecule" in capsys.readouterr().out


def test_dry_run_records_an_error_and_exits_nonzero(monkeypatch, capsys):
    def broken(*args, **kwargs):
        raise RuntimeError("no such cell")

    monkeypatch.setattr(specs, "build_cell", broken)
    assert dryrun.main(["--arch", "gcn-cora", "--shape", "molecule"]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["status"] == "error" and "no such cell" in line["error"]


def test_shard_of_batch_equals_the_reference():
    t, lab = jtokens.batch_at_step(jtokens.TokenStreamConfig(97, 8, 12), 3)
    for n in (1, 2, 3, 4):
        for s in range(n):
            want = jtokens.shard_of_batch(t, lab, s, n)
            got = tokens.shard_of_batch(t, lab, s, n)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_yoshida_mis_queries_equals_the_reference(seed):
    g = jgen.erdos_renyi(40, 3.0, seed=seed)
    rank = np.random.default_rng(seed).permutation(g.n).astype(np.float32)
    want = joracle.yoshida_mis_queries(g, rank)
    assert oracle.yoshida_mis_queries(graph_from_reference(g), rank) == want
    assert want > 0
