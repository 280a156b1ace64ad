"""moe_dispatch_ms.train: device ms a training step in the MoE dispatch's
kernels (the router's sorts and ``searchsorted``, ``index_put``,
``index_add``, scatter and gather), by the kernel-name classes of the
port's MoE training profile.  Nothing to read in a dense model."""

FLASH = ("flash_fwd", "flash_bwd")
SORT = ("radixsort", "sort")
INDEX = ("index", "scatter", "gather")


def read(trace):
    if trace is None or trace.steps <= 0 \
            or not trace.config.get("num_local_experts"):
        return None
    took = [s for name, s in trace.kernels()
            if not any(p in name.lower() for p in FLASH)
            and any(p in name.lower() for p in SORT + INDEX)]
    return 1e3 * sum(took) / trace.steps if took else None
