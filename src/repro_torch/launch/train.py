"""Training driver (CLI): LM training with checkpoint and restart, the
counterpart of the JAX package's ``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --steps 50 --ckpt-dir runs/run1 [--device cpu] [--no-smoke]

``--smoke`` (the default) trains the registry's reduced config; unlike the
reference's flag (``store_true`` with ``default=True``), ``--no-smoke``
selects the full one.  Re-running with the same ``--ckpt-dir`` continues
from the latest checkpoint.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint import checkpointer as ckpt
from ..configs.registry import get
from ..data.tokens import TokenStreamConfig, batch_at_step
from ..models.transformer import TransformerLM
from ..optim import adamw
from . import steps


def train_lm(arch: str, smoke: bool, n_steps: int, ckpt_dir: str,
             batch: int = 8, seq_len: int = 64, ckpt_every: int = 20,
             log_every: int = 10, seed: int = 0, device=None):
    """Train ``arch`` for steps [start, n_steps) on the synthetic token
    stream, resuming from ``ckpt_dir``'s latest checkpoint where there is
    one; returns the losses of the steps run.  Parameters are f32, drawn
    from ``seed``; the AdamW settings are the reference's."""
    entry = get(arch)
    cfg = entry.smoke_config if smoke else entry.config
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=20,
                                total_steps=max(n_steps, 100))
    model = TransformerLM(cfg, device=device, seed=seed)
    params = dict(model.named_parameters())
    opt_state = adamw.init_state(params)

    start = 0
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        state, last = ckpt.restore(ckpt_dir, {"params": params,
                                              "opt": opt_state})
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(state["params"][name])
        opt_state = state["opt"]
        start = last + 1
        print(f"resumed from step {last}")

    stream = TokenStreamConfig(vocab=cfg.vocab, seq_len=seq_len,
                               global_batch=batch, seed=seed)
    losses = []
    for step in range(start, n_steps):
        tokens, labels = batch_at_step(stream, step)
        metrics = steps.lm_train_step(model, opt_cfg, opt_state, tokens,
                                      labels)
        losses.append(float(metrics["loss"]))
        if step % log_every == 0:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step, {"params": params, "opt": opt_state})
    if ckpt_dir:
        ckpt.save(ckpt_dir, n_steps - 1, {"params": params, "opt": opt_state})
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    t0 = time.time()
    losses = train_lm(args.arch, args.smoke, args.steps, args.ckpt_dir,
                      batch=args.batch, seq_len=args.seq_len,
                      device=args.device)
    print(f"done in {time.time()-t0:.1f}s  first={losses[0]:.3f} "
          f"last={losses[-1]:.3f}")


if __name__ == "__main__":
    main()
