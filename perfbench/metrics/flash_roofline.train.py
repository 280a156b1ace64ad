"""flash_roofline.train: the flash-attention kernels' share of their
roofline, in %: the sum over the traced launches of each one's least time
(``work.flash_launch``: its FLOPs at 989 TFLOP/s against its bytes at
3.35 TB/s) over the sum of their device time.  A launch is one
microbatch's (B / microbatches rows) forward, dq or dk/dv at the mix's
sequence length, its kind read from the kernel's name."""
from perfbench import work

KINDS = (("flash_fwd", "fwd"), ("flash_bwd_dq", "dq"),
         ("flash_bwd_dkv", "dkv"))


def read(trace):
    if trace is None:
        return None
    cfg, mix = trace.config, trace.mix
    shape = work.LmShape.of(cfg)
    rows = mix["batch"] // mix.get("microbatches", 1)
    least = {kind: work.least_seconds(*work.flash_launch(
        kind, rows, mix["seq_len"], shape.heads, shape.kv_heads,
        shape.head_dim, shape.window)) for _, kind in KINDS}
    need = took = 0.0
    for name, s in trace.kernels():
        kind = next((k for p, k in reversed(KINDS) if p in name), None)
        if kind is not None:
            need += least[kind]
            took += s
    return work.mfu_share(need, took) if took > 0 else None
