"""Time the LM train step under a one-rank ``ShardCtx`` against the plain
step on the card, in turns.

    PYTHONPATH=src python3 scripts/time_sharded_step.py [--layers 4] \
        [--steps 3]

The model is ``chip_smoke.py``'s ``launch`` phase's: qwen3-4b at full
width cut to ``--layers`` layers, f32 parameters, bf16 compute, remat
"full", the flash kernels, B 2 at S 4096.  One process is one NCCL rank on
a (1, 1) ("data", "model") mesh.  After one warm-up step each, the plain
and the sharded step run ``--steps`` times in turns, each timed on the
host's clock to a ``torch.cuda.synchronize()``.  Also timed: one
``steps.place_lm`` on the state it has already placed.  One JSON line on
standard output, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import socket
import subprocess
import time

import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.data.tokens import TokenStreamConfig, batch_at_step
from repro_torch.kernels.flash_attention import bwd as flash_bwd
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.launch import steps
from repro_torch.launch.mesh import MeshShape, make_mesh
from repro_torch.models.transformer import ShardCtx, TransformerLM
from repro_torch.optim import adamw


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    flash_kernel.build("wgmma")
    flash_bwd.build("wgmma")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        sctx = ShardCtx(make_mesh(MeshShape((1, 1), ("data", "model")),
                                  "cuda"), "data")
        entry = registry.get("qwen3-4b")
        cfg = dataclasses.replace(entry.config, n_layers=args.layers,
                                  attention_impl="pallas", remat="full")
        opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=20,
                                    total_steps=100)
        plain = TransformerLM(cfg, device="cuda")
        sharded = TransformerLM(cfg, device="cuda")
        opt_p, opt_s = adamw.init_state(plain), adamw.init_state(sharded)
        steps.place_lm(sharded, opt_s, sctx)
        batch = batch_at_step(TokenStreamConfig(
            cfg.vocab, entry.shapes["train_4k"].seq_len, 2), 0)

        def plain_step():
            steps.lm_train_step(plain, opt_cfg, opt_p, *batch)

        def sharded_step():
            steps.lm_train_step(sharded, opt_cfg, opt_s, *batch, sctx=sctx)

        warm = {"plain": _timed(plain_step), "sharded": _timed(sharded_step)}
        times = {"plain": [], "sharded": []}
        for _ in range(args.steps):
            times["plain"].append(_timed(plain_step))
            times["sharded"].append(_timed(sharded_step))
        place_s = _timed(lambda: steps.place_lm(sharded, opt_s, sctx))
        print(json.dumps({"layers": args.layers, "batch": 2,
                          "seq_len": int(batch[0].shape[1]),
                          "warm_s": warm, "step_s": times,
                          "place_lm_s": place_s}))
    finally:
        dist.destroy_process_group()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
