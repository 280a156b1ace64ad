"""The reduction from a traced stretch to the per-layer metrics, on
synthetic device timelines."""
import pytest
import torch

from perfbench import harness, tracing, work
from perfbench.tracing import Trace, breakdown, read_metrics


def trace(cell_name, ops, host=(), window=(0.0, 1.0), steps=2):
    cell = harness.cell(cell_name)
    return Trace(list(ops), list(host), window, steps, cell.config,
                 cell.mix), cell.readers()


def test_busy_is_the_union_inside_the_window():
    t, _ = trace("qwen3-4b.train_4k", [("a", -0.2, 0.1), ("b", 0.05, 0.3),
                                       ("c", 0.5, 0.6), ("d", 0.9, 1.4)],
                 host=[("aten::mul", 0.25, 0.55), ("cudaLaunchKernel", 0.31,
                                                   0.32)])
    assert t.busy_s == pytest.approx(0.3 + 0.1 + 0.1)
    gaps = dict((name, s) for name, s in t.idle_gaps())
    assert gaps["aten::mul"] == pytest.approx(0.2)       # 0.3 .. 0.5
    assert t.idle_gaps()[0][1] == pytest.approx(0.3)     # 0.6 .. 0.9
    assert len(breakdown(t)["device_ops"]) == 4


def test_idle_share_and_elementwise_by_kernel_name():
    ops = [("void flash_fwd_wgmma_kernel<128>", 0.0, 0.1),
           ("nvjet_tst_256x128", 0.1, 0.3),
           ("void at::native::vectorized_elementwise_kernel", 0.3, 0.6),
           ("Memcpy DtoD (Device -> Device)", 0.6, 0.7)]
    t, readers = trace("qwen3-4b.train_4k", ops)
    t.after_steps, t.after_s = 2, 1.0     # 0.35 s busy in a 0.5 s step
    got = read_metrics(t, readers)
    assert got["device_idle_share.train"] == pytest.approx(30.0)
    assert got["elementwise_ms.train"] == pytest.approx(1e3 * 0.3 / 2)
    assert "moe_dispatch_ms.train" not in got          # a dense model


def test_moe_dispatch_class():
    ops = [("void at::native::index_elementwise_kernel", 0.0, 0.1),
           ("void cub::DeviceRadixSortOnesweepKernel", 0.1, 0.2),
           ("void at::native::vectorized_elementwise_kernel", 0.2, 0.5)]
    t, readers = trace("mixtral-8x22b.train_4k", ops, steps=1)
    got = read_metrics(t, readers)
    assert got["moe_dispatch_ms.train"] == pytest.approx(200.0)
    assert got["elementwise_ms.train"] == pytest.approx(300.0)


def test_flash_roofline_is_100_at_the_least_time():
    cell = harness.cell("qwen3-4b.train_4k")
    shape = work.LmShape.of(cell.config)
    rows = cell.mix["batch"] // cell.mix["microbatches"]
    ops, at = [], 0.0
    for name, kind in (("flash_fwd_wgmma_kernel", "fwd"),
                       ("flash_bwd_dq_wgmma_kernel", "dq"),
                       ("flash_bwd_dkv_wgmma_kernel", "dkv")):
        s = work.least_seconds(*work.flash_launch(
            kind, rows, cell.mix["seq_len"], shape.heads, shape.kv_heads,
            shape.head_dim))
        ops.append((name, at, at + s))
        at += s
    t, readers = trace("qwen3-4b.train_4k", ops)
    assert read_metrics(t, readers)["flash_roofline.train"] == \
        pytest.approx(100.0)


def test_step_mfu_from_the_untraced_steps():
    cell = harness.cell("qwen3-4b.train_4k")
    flops = work.train_step_flops(work.LmShape.of(cell.config),
                                  cell.mix["batch"], cell.mix["seq_len"])
    seconds = 4 * flops / work.PEAK_FLOPS["bfloat16"]
    t, readers = trace("qwen3-4b.train_4k", [("k", 0.0, 1.0)])
    t.after_steps, t.after_s = 2, seconds
    assert read_metrics(t, readers)["step_mfu.train"] == pytest.approx(50.0)
    d, dreaders = trace("qwen3-4b.decode_32k", [("k", 0.0, 0.1)])
    d.after_steps, d.after_s = 4, 4 * 0.13941269
    # 13.94 ms needed a step, 139.41 ms taken: 10%
    assert read_metrics(d, dreaders)["step_mfu.decode"] == \
        pytest.approx(10.0, rel=1e-4)
    d.after_steps = 0
    assert "step_mfu.decode" not in read_metrics(d, dreaders)


def test_no_trace_reads_nothing():
    _, readers = trace("mixtral-8x22b.train_4k", [])
    assert read_metrics(None, readers) == {}


class _Event:
    def __init__(self, name, start_s, end_s, cuda):
        self.name = name
        self.time_range = type("R", (), {"start": start_s * 1e6,
                                         "end": end_s * 1e6})()
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)
        self.is_user_annotation = False


def test_window_ends_with_the_last_device_op():
    """The window is as long as the device timed it and ends where the last
    device operation ends; the warm step before it is left out."""
    prof = type("P", (), {"events": lambda self: [
        _Event("warm", 0.0, 0.5, True), _Event("aten::mm", 1.0, 1.2, False),
        _Event("k", 1.1, 1.6, True), _Event("last", 1.9, 2.0, True)]})()
    ops, host, window = tracing._events(prof, 1.0)
    assert window == pytest.approx((1.0, 2.0))
    assert [o[0] for o in ops] == ["k", "last"]
    assert [h[0] for h in host] == ["aten::mm"]
    with pytest.raises(RuntimeError):
        tracing._events(type("P", (), {"events": lambda self: []})(), 1.0)


def test_idle_gaps_named_from_the_host_stretch():
    t, _ = trace("qwen3-4b.train_4k", [("a", 0.0, 0.9)])
    gaps, _ = trace("qwen3-4b.train_4k", [("a", 0.0, 0.2), ("b", 0.6, 1.0)],
                    host=[("aten::to", 0.1, 0.7)], steps=1)
    t.gaps_from = gaps
    assert t.busy_s == pytest.approx(0.9)
    assert t.idle_gaps() == [["aten::to", pytest.approx(0.4)]]
    assert breakdown(t)["device_ops"] == [["a", pytest.approx(0.9)]]


def test_recorder_needs_a_card():
    with pytest.raises(ValueError):
        tracing.Recorder(torch.device("cpu"))
