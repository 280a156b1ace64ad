"""Serving launcher (CLI): batched prefill, then a decode loop against the
KV cache, the counterpart of the JAX package's ``launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \\
        --batch 4 --prompt-len 32 --gen 16 [--device cpu] [--no-smoke]

``--smoke`` (the default) serves the registry's reduced config; unlike the
reference's flag (``store_true`` with ``default=True``), ``--no-smoke``
selects the full one.  Parameters are f32, drawn from ``--seed``, as the
reference's ``init_params`` draws them; prompts are uniform token ids from
numpy's generator of the same seed.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.registry import get
from ..models.transformer import TransformerLM
from . import steps


def grow_cache(cache, n_slots: int):
    """``cache`` with its k and v grown to ``n_slots`` positions, the new
    slots zero (the reference pads with ``jnp.pad``'s zeros): a masked
    slot still enters ``p @ v``, so it must hold a finite value."""
    k = cache["k"]
    shape = k.shape[:2] + (n_slots,) + k.shape[3:]
    grown = {}
    for name in ("k", "v"):
        grown[name] = torch.zeros(shape, dtype=k.dtype, device=k.device)
        grown[name][:, :, :k.shape[2]].copy_(cache[name])
    grown["length"] = cache["length"]
    return grown


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, smoke: bool, batch: int, prompt_len: int, gen: int,
          seed: int = 0, device=None, *, model: TransformerLM = None):
    """Prefill ``batch`` seeded prompts of ``prompt_len`` tokens, grow the
    cache to ``prompt_len + gen`` slots, then decode ``gen`` tokens
    greedily.  ``model`` serves in place of a fresh one drawn from
    ``seed`` (its config then stands for the registry's).

    The cache holds every position whatever the arch, as the reference's
    does: for mixtral, whose layers all see a window of 4096, decode masks
    the slots older than the window (``steps.lm_cache_shape`` gives the
    smaller ring a window-bounded server would allocate); for llama4, and
    the other archs' global layers, every slot is attended.  An MoE layer
    routes the whole prompt in one dispatch (its capacity counted over
    batch x prompt_len tokens) and each decode step's batch of tokens in
    another, so near-tie routes may differ between the two.

    Returns {"generated" (batch, gen) int64 numpy, "logits" (gen + 1,
    batch, V) on the model's device (the prefill's, then each decode
    step's), "cache", "prefill_s" (cache growth included), "decode_s",
    "prefill_tok_s", "decode_tok_s"}."""
    entry = get(arch)
    if model is None:
        cfg = entry.smoke_config if smoke else entry.config
        model = TransformerLM(cfg, device=device, seed=seed)
    elif model.cfg.name != entry.config.name:
        raise ValueError(f"a {model.cfg.name} model cannot serve {arch}")
    cfg, dev = model.cfg, model.device
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = steps.lm_prefill_step(model, prompts)
    cache = grow_cache(cache, prompt_len + gen)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out_tokens, all_logits = [], [logits]
    tok = torch.argmax(logits, dim=-1)
    t1 = time.perf_counter()
    for _ in range(gen):
        out_tokens.append(tok)
        logits, cache = steps.lm_decode_step(model, cache, tok)
        all_logits.append(logits)
        tok = torch.argmax(logits, dim=-1)
    _sync(dev)
    t_decode = time.perf_counter() - t1
    generated = (torch.stack(out_tokens, dim=1).cpu().numpy() if gen
                 else np.zeros((batch, 0), np.int64))
    return {"generated": generated, "logits": torch.stack(all_logits),
            "cache": cache, "prefill_s": t_prefill, "decode_s": t_decode,
            "prefill_tok_s": batch * prompt_len / max(t_prefill, 1e-9),
            "decode_tok_s": batch * gen / max(t_decode, 1e-9)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-12b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    r = serve(args.arch, args.smoke, args.batch, args.prompt_len, args.gen,
              seed=args.seed, device=args.device)
    print(f"prefill {r['prefill_s']:.2f}s decode {r['decode_s']:.2f}s "
          f"({r['decode_tok_s']:.1f} tok/s) sample: {r['generated'][0][:8]}")


if __name__ == "__main__":
    main()
