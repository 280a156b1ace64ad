"""End-to-end training on the PyTorch port: a ~100M-parameter qwen3-family
LM trained on the synthetic token stream with checkpointing, on the card
by default.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 300          # full
  PYTHONPATH=src python examples/torch_train_lm.py --steps 20 --tiny \\
      --device cpu                                                      # smoke

The "100M" configuration is the reference example's scaled qwen3 (same
qk-norm/GQA family): d_model=640, 10 layers, vocab 32k -> 91.1M params by
``param_count()`` (the reference's docstring says ~103M).  Checkpoints go to
``--ckpt-dir`` (default ``runs/torch_train_lm`` under the working
directory); a rerun resumes from the latest.
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.lm_archs import QWEN3_4B
from repro_torch.data.tokens import TokenStreamConfig, batch_at_step
from repro_torch.launch import steps
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim import adamw


def config_100m():
    return dataclasses.replace(
        QWEN3_4B, name="qwen3-100m", vocab=32768, n_layers=10, d_model=640,
        n_heads=8, n_kv_heads=4, head_dim=64, d_ff=2048, max_seq_len=1024)


def config_tiny():
    return dataclasses.replace(
        QWEN3_4B, name="qwen3-tiny", vocab=1024, n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, max_seq_len=256)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default="runs/torch_train_lm")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = config_tiny() if args.tiny else config_100m()
    print(f"model {cfg.name}: {cfg.param_count() / 1e6:.1f}M params")
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=30,
                                total_steps=max(args.steps, 100))
    model = TransformerLM(cfg, device=args.device, seed=0)
    params = dict(model.named_parameters())
    opt_state = adamw.init_state(params)
    start = 0
    if ckpt.latest_step(args.ckpt_dir) is not None:
        state, last = ckpt.restore(args.ckpt_dir,
                                   {"params": params, "opt": opt_state})
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(state["params"][name])
        opt_state = state["opt"]
        start = last + 1
        print(f"resumed from step {last}")

    stream = TokenStreamConfig(cfg.vocab, args.seq_len, args.batch, seed=0)
    t0 = time.time()
    first = last_loss = None
    for step in range(start, args.steps):
        tokens, labels = batch_at_step(stream, step)
        metrics = steps.lm_train_step(model, opt_cfg, opt_state, tokens,
                                      labels)
        last_loss = float(metrics["loss"])
        first = first if first is not None else last_loss
        if step % 10 == 0:
            dt = time.time() - t0
            toks = (step - start + 1) * args.batch * args.seq_len
            print(f"step {step:4d} loss {last_loss:.4f} "
                  f"({toks / max(dt, 1e-9):.0f} tok/s)", flush=True)
        if (step + 1) % 50 == 0:
            ckpt.save(args.ckpt_dir, step,
                      {"params": params, "opt": opt_state})
    ckpt.save(args.ckpt_dir, args.steps - 1,
              {"params": params, "opt": opt_state})
    if first is not None:
        print(f"done: loss {first:.3f} -> {last_loss:.3f} "
              f"in {time.time() - t0:.0f}s")
        assert last_loss < first, "training should reduce the loss"
    return {"first": first, "last": last_loss, "start": start}


if __name__ == "__main__":
    main()
