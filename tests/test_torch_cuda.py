"""Port tests that need the card: the CUDA ``dht_gather`` kernel and the
engine on CUDA, each held against the port's own CPU path (exact).

This file imports no JAX, so it also runs on a machine with a card and no
JAX:  ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Elsewhere every test skips (a CUDA kernel has no CPU mode).
"""
import numpy as np
import pytest
import torch

from repro_torch.ampc import AmpcEngine
from repro_torch.ampc.engine import _field_eq
from repro_torch.graph import generators as gen
from repro_torch.kernels.dht_gather import ops
from repro_torch.kernels.dht_gather.ref import dht_gather_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("D,dtype", [(1, torch.int32), (64, torch.float32),
                                     (128, torch.bfloat16), (3, torch.int32)])
def test_kernel_matches_plain_version(card, D, dtype):
    V, Q = 5000, 20000
    rng = np.random.default_rng(0)
    table = torch.randn(V, D, device=card).to(dtype)
    keys = rng.integers(-3, V + 5, size=Q).astype(np.int32)
    keys[::7] = -1
    keys = torch.from_numpy(keys).to(card)
    before = ops.dht_gather.launches
    out, hits = ops.dht_gather(table, keys)
    assert ops.dht_gather.launches == before + 1
    sk, order = torch.sort(keys, stable=True)
    ref_out, ref_hits = dht_gather_ref(table, sk)
    expect = torch.empty_like(ref_out)
    expect[order] = ref_out
    assert torch.equal(out, expect) and int(hits) == int(ref_hits)


def test_kernel_empty_batch_launches_nothing(card):
    table = torch.zeros(10, 1, dtype=torch.int32, device=card)
    before = ops.dht_gather.launches
    out, hits = ops.dht_gather(table, torch.zeros(0, dtype=torch.int32,
                                                  device=card))
    assert out.shape == (0, 1) and int(hits) == 0
    assert ops.dht_gather.launches == before


@pytest.mark.parametrize("problem", ["mis", "connectivity", "msf"])
def test_cuda_solve_equals_cpu_solve(card, problem):
    g = gen.rmat(10, 8.0, seed=1)
    if problem == "msf":
        g = g.with_random_weights(2)
    want = AmpcEngine(seed=0, device="cpu").solve(g, problem)
    before = ops.dht_gather.launches
    got = AmpcEngine(seed=0).solve(g, problem)
    assert ops.dht_gather.launches - before == \
        (2 if problem == "connectivity" else 0)
    np.testing.assert_array_equal(got.output, want.output)
    assert _field_eq(got.stats, want.stats)
    for key in got.ledger:
        if key not in ("wall_time_s", "phase_times"):
            assert got.ledger[key] == want.ledger[key], key
