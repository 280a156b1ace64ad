"""The PyTorch port stands alone: it never imports ``jax`` or ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "repro")


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
            + sorted((REPO / "examples").glob("torch_*.py")))


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_neither_jax_nor_repro(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.ampc, repro_torch.convert, "
            "repro_torch.kernels.dht_gather.ops, "
            "repro_torch.kernels.flash_attention, "
            "repro_torch.models.transformer, repro_torch.configs.registry, "
            "repro_torch.data.tokens, repro_torch.optim.adamw, "
            "repro_torch.launch.steps, repro_torch.launch.train, "
            "repro_torch.checkpoint.checkpointer, "
            "repro_torch.kernels.flash_attention.bwd, "
            "repro_torch.kernels.segment_matmul.ops, "
            "repro_torch.models.gnn.gin, repro_torch.data.graphs, "
            "repro_torch.configs.shapes, "
            "repro_torch.kernels.embedding_bag.ops, "
            "repro_torch.models.sasrec, repro_torch.data.recsys, "
            "repro_torch.ampc.async_engine, repro_torch.ampc.cache, "
            "repro_torch.ampc.session, repro_torch.graph.batching, "
            "repro_torch.runtime.retry, repro_torch.launch.serve, "
            "repro_torch.models.gnn.gcn, repro_torch.models.gnn.schnet, "
            "repro_torch.models.gnn.mace, repro_torch.configs.qwen3_4b, "
            "repro_torch.configs.gcn_cora, repro_torch.configs.sasrec_cfg, "
            "repro_torch.models.moe, repro_torch.runtime.fault_tolerance, "
            "repro_torch.optim.grad_compression, repro_torch.launch.mesh, "
            "repro_torch.launch.sharding, repro_torch.launch.specs, "
            "repro_torch.launch.dryrun, repro_torch.launch.collectives, "
            "repro_torch.devices, "
            "repro_torch.placement; "
            "from repro_torch.ampc import RoutedDht; "
            "from repro_torch.core.dht import DhtMesh, make_mesh, "
            "routed_lookup; "
            "from repro_torch.core.rounds import TRANSFERS; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; "
            "assert not bad, bad; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_refuses_to_run_without_a_card_or_checkout(tmp_path):
    """Alone in a directory (or without CUDA) the smoke script exits
    nonzero and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
