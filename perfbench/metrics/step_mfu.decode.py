"""step_mfu.decode: the decode step's share of the chip's roofline, in %:
its least time at the chip's peaks (``work.decode_step_work``: the larger
of its FLOPs at 989 TFLOP/s and its bytes at 3.35 TB/s; here the bytes
bound it, the weights once and the keys and values of every attended
position) over the mean step, timed on the host's clock in the traced
run's window after its traced stretch, with the profiler off."""
from perfbench import work


def read(trace):
    if trace is None or trace.after_steps <= 0:
        return None
    mix = trace.mix
    least = work.least_seconds(*work.decode_step_work(
        work.LmShape.of(trace.config), mix["batch"], mix["cache_len"]))
    return work.mfu_share(least, trace.after_s / trace.after_steps)
