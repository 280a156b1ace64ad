"""step_mfu.train: the training step's share of the chip's bf16 peak, in %:
the model FLOPs of a step (``work.train_step_flops``: 6 a matmul weight a
token, the causal attention forward and backward, recomputation not
counted) over the seconds a step took at 989 TFLOP/s, the steps timed on
the host's clock in the traced run's window after its traced stretch,
with the profiler off."""
from perfbench import work


def read(trace):
    if trace is None or trace.after_steps <= 0:
        return None
    mix = trace.mix
    flops = work.train_step_flops(work.LmShape.of(trace.config),
                                  mix["batch"], mix["seq_len"])
    return work.mfu_share(
        flops * trace.after_steps / work.PEAK_FLOPS["bfloat16"],
        trace.after_s)
