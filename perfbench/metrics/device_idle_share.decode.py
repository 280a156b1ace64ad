"""device_idle_share.decode: the share of a step, in %, in which no kernel,
copy or fill ran on the device: 1 - the device's busy time a traced step
(the union of its operations' intervals, from the profiler's record of the
device alone) over the mean step of the same run's untraced rest (host
clock, ended by a synchronize).  Timing the step untraced keeps the
profiler's own host cost, which lengthens a traced step, out of it."""


def read(trace):
    if trace is None or trace.steps <= 0 or trace.after_steps <= 0 \
            or not trace.ops:
        return None
    busy = trace.busy_s / trace.steps
    return 100.0 * (1.0 - busy / (trace.after_s / trace.after_steps))
