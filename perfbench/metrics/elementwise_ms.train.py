"""elementwise_ms.train: device ms a training step in kernels that are
neither GEMMs nor the port's flash-attention kernels nor, in an MoE model,
the dispatch's sort and index kernels: the model's and AdamW's elementwise
and reduction work (norms, RoPE, SiLU, casts, the loss, the optimizer).
Classified by kernel name."""

GEMM = ("gemm", "xmma", "nvjet", "cutlass", "splitk")
FLASH = ("flash_fwd", "flash_bwd")
DISPATCH = ("radixsort", "sort", "index", "scatter", "gather")


def read(trace):
    if trace is None or trace.steps <= 0 or not trace.kernels():
        return None
    moe = bool(trace.config.get("num_local_experts"))
    skip = GEMM + FLASH + (DISPATCH if moe else ())
    total = sum(s for name, s in trace.kernels()
                if not any(p in name.lower() for p in skip))
    return 1e3 * total / trace.steps
