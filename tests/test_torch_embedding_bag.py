"""The port's ``embedding_bag`` op on the CPU against the JAX package's
``embedding_bag_ref`` (the Pallas kernel's oracle; its interpret mode does
not run under this JAX).  Inputs come from numpy seeds.  The CUDA kernel
is held against the port's plain version in ``tests/test_torch_cuda.py``.

Tolerances, stated before measuring:
- f32: per element |got - want| <= 2 L 2^-24 sum_l |row_l| (both sum the
  same L terms in f32, the port in slot order and the reference in XLA's,
  each within L 2^-24 of the sum of |terms| of the exact sum);
- bf16: the port's bf16 output against the reference run on the table
  upcast to f32, within that bound plus 2^-8 |want| (one rounding of the
  f32 sum to bf16, half a unit of 2^-7);
- the port's plain version against a numpy loop over the slots in f32:
  bit for bit (the same adds in the same order).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_ref

from repro_torch.kernels.embedding_bag import kernel, ops
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

REPO = Path(__file__).resolve().parents[1]
# tests/test_kernels.py's (V, D, B, L), then D 37, L 0 and 1, a ragged B
SHAPES = [(64, 16, 16, 4), (256, 32, 32, 10), (1024, 64, 8, 50),
          (300, 37, 13, 7), (50, 8, 5, 0), (50, 8, 5, 1), (2048, 50, 1001, 50)]


def _inputs(V, D, B, L, seed=3):
    """A standard-normal table and ids over [-3, V + 5): padding (0 and
    negative) and ids past the table in every case with slots."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(-3, V + 5, (B, L)).astype(np.int32)
    if L:
        ids[:, -1] = 0
    return table, ids


def _abs_sums(table, ids):
    """sum over a bag's valid slots of |row|, in f64: (B, D)."""
    safe = np.clip(ids, 0, table.shape[0] - 1)
    rows = np.abs(table[safe].astype(np.float64))
    return np.where((ids > 0)[..., None], rows, 0.0).sum(axis=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V,D,B,L", SHAPES)
def test_op_matches_jax_ref(V, D, B, L, dtype):
    table, ids = _inputs(V, D, B, L)
    t = torch.from_numpy(table).to(dtype)
    before = ops.embedding_bag.launches
    got = ops.embedding_bag(t, torch.from_numpy(ids))
    assert ops.embedding_bag.launches == before      # CPU: no kernel
    assert got.dtype == dtype and tuple(got.shape) == (B, D)
    # the reference on the same values in f32 (bf16 upcast exactly)
    t32 = t.float().numpy()
    want = np.asarray(jax_ref(jnp.asarray(t32), jnp.asarray(ids)), np.float64)
    limit = 2 * L * 2.0 ** -24 * _abs_sums(t32, ids)
    if dtype == torch.bfloat16:
        limit = limit + 2.0 ** -8 * np.abs(want)
    err = np.abs(got.float().numpy().astype(np.float64) - want)
    assert (err <= limit).all(), float((err - limit).max())


@pytest.mark.parametrize("V,D,B,L", SHAPES)
def test_plain_version_sums_in_slot_order(V, D, B, L):
    table, ids = _inputs(V, D, B, L, seed=4)
    acc = np.zeros((B, D), np.float32)
    for slot in range(L):
        rows = table[np.clip(ids[:, slot], 0, V - 1)]
        acc = acc + np.where((ids[:, slot] > 0)[:, None], rows,
                             np.float32(0))
    got = embedding_bag_ref(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), acc)


def test_padding_and_clipping():
    """0 and negative ids add nothing; ids of V or more read row V - 1."""
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    ids = torch.tensor([[0, -1, -7, 0], [2, 0, 4, 100], [1, 1, 0, 3]],
                       dtype=torch.int32)
    got = ops.embedding_bag(table, ids)
    want = torch.stack([torch.zeros(3), table[2] + 2 * table[3],
                        2 * table[1] + table[3]])
    assert torch.equal(got, want)


def test_op_refuses_what_it_does_not_take():
    table = torch.randn(8, 4)
    ids = torch.ones(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="no backward"):
        ops.embedding_bag(table.clone().requires_grad_(True), ids)
    with torch.no_grad():     # no gradient wanted: the table may train
        ops.embedding_bag(table.clone().requires_grad_(True), ids)
    with pytest.raises(ValueError, match="int32"):
        ops.embedding_bag(table, ids.long())
    with pytest.raises(ValueError, match=r"\(B, L\)"):
        ops.embedding_bag(table, ids[0])
    with pytest.raises(ValueError, match="f32 or bf16"):
        ops.embedding_bag(table.half(), ids)
    with pytest.raises(ValueError, match="without rows"):
        ops.embedding_bag(torch.zeros(0, 4), ids)
    assert ops.embedding_bag(torch.zeros(0, 4), ids[:, :0]).shape == (2, 4)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.embedding_bag(table.to("meta"), ids.to("meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.embedding_bag_cuda(table, ids)


def test_importing_and_running_on_the_cpu_builds_nothing():
    """In a fresh process: import the op, run it on CPU tensors; the
    kernel's library was never loaded (nor built)."""
    code = ("import torch\n"
            "from repro_torch.kernels.embedding_bag import kernel, ops\n"
            "ops.embedding_bag(torch.randn(5, 2), "
            "torch.ones(1, 2, dtype=torch.int32))\n"
            "assert kernel._fn is None\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
