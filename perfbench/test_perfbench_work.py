"""work.py's counts against the figures PERF.md records for the cells."""
import json
from pathlib import Path

import pytest

from perfbench import work

ROOT = Path(__file__).resolve().parents[1]


def shape(name):
    return work.LmShape.of(json.loads(
        (ROOT / "perfbench" / "configs" / f"{name}.json").read_text()))


def test_train_flops_a_token():
    # PERF.md: 27.7 GFLOP a token for qwen3-4b (6 x (3.63 B + 0.389 B)
    # + 3.6 GFLOP of attention), 5.51 for one mixtral layer
    assert work.train_step_flops(shape("qwen3-4b"), 2, 4096) / 8192 \
        == pytest.approx(27.76e9, rel=1e-3)
    assert work.train_step_flops(shape("mixtral-8x22b"), 2, 4096) / 8192 \
        == pytest.approx(5.512e9, rel=1e-3)


def test_parameters_and_state():
    q, m = shape("qwen3-4b"), shape("mixtral-8x22b")
    assert q.params() == pytest.approx(4.022e9, rel=1e-3)
    assert m.params() == pytest.approx(2.907e9, rel=1e-3)
    # mixtral's f32 parameters, gradients, m and v: 46.5 GB
    assert 16 * m.params() == pytest.approx(46.5e9, rel=1e-2)


def test_decode_step_bound():
    # 8.04 GB of bf16 weights and 38.65 GB of K and V: 13.9 ms at 3.35 TB/s
    flops, data = work.decode_step_work(shape("qwen3-4b"), 8, 32768)
    assert data == pytest.approx(46.70e9, rel=1e-3)
    assert work.least_seconds(flops, data) == pytest.approx(13.94e-3,
                                                            rel=1e-3)
    assert flops / work.PEAK_FLOPS["bfloat16"] < data / work.HBM_BYTES_PER_S


@pytest.mark.parametrize("kind,ms", [("fwd", 0.139), ("dq", 0.2085),
                                     ("dkv", 0.2780)])
def test_flash_launch_bound(kind, ms):
    # PERF.md's table: a (1, 4096, 32/8, 128) bf16 causal launch
    f, b = work.flash_launch(kind, 1, 4096, 32, 8, 128)
    assert 1e3 * work.least_seconds(f, b) == pytest.approx(ms, rel=2e-3)
    assert f / work.PEAK_FLOPS["bfloat16"] > b / work.HBM_BYTES_PER_S


@pytest.mark.parametrize("S,K,window", [(7, 7, 0), (9, 9, 3), (5, 12, 0),
                                        (16, 16, 16), (4, 8, 2)])
def test_causal_pairs_by_count(S, K, window):
    want = sum(1 for i in range(S) for j in range(K)
               if 0 <= i + K - S - j < (window if window > 0 else K + 1))
    assert work.causal_pairs(S, K, window) == want
