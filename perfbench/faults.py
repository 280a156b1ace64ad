"""Faults planted under the timed path, to show that the comparison which
decides ``correct`` catches them: each is a context manager that patches
the program's step while it is open.

- ``unchanged``: the step returns its state unchanged (training: AdamW
  moves nothing; decode: the new key and value are not kept in the cache);
- ``half_batch``: half of the batch left out (training: the step runs on
  the first half of the rows, the mean taken over them; decode: the first
  half of the rows decode, the other half get copies of their logits);
- ``token``: one token altered where it is produced (decode: the fifth
  step's first row gets the token its logits rate lowest).

The exchange between chips does not exist in a one-chip cell.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

TRAIN = ("unchanged", "half_batch")
DECODE = ("unchanged", "half_batch", "token")
ALTERED_CALL = 5


@contextlib.contextmanager
def _patched(module, name, replacement):
    real = getattr(module, name)
    setattr(module, name, replacement(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _adamw_still(real):
    def apply_updates(cfg, params, grads, state):
        zero = torch.zeros((), device=state["step"].device)
        return state, {"lr": zero, "grad_norm": zero}
    return apply_updates


def _train_half(real):
    def lm_train_step(model, opt_cfg, state, tokens, labels, sctx=None):
        cfg, B = model.cfg, tokens.shape[0]
        model.cfg = dataclasses.replace(
            cfg, n_microbatches=max(1, cfg.n_microbatches // 2))
        try:
            return real(model, opt_cfg, state, tokens[:B // 2],
                        labels[:B // 2], sctx)
        finally:
            model.cfg = cfg
    return lm_train_step


def _decode_still(real):
    def lm_decode_step(model, cache, token, sctx=None):
        S = cache["k"].shape[2]
        slot = (cache["length"][:1] % S).long()
        old = [cache[n].index_select(2, slot) for n in ("k", "v")]
        logits, new = real(model, cache, token, sctx)
        for n, t in zip(("k", "v"), old):
            new[n].index_copy_(2, slot, t)
        return logits, new
    return lm_decode_step


def _decode_half(real):
    def lm_decode_step(model, cache, token, sctx=None):
        h = token.shape[0] // 2
        part = {"k": cache["k"][:, :h], "v": cache["v"][:, :h],
                "length": cache["length"][:h]}
        logits, _ = real(model, part, token[:h], sctx)
        return (torch.cat([logits, logits]),
                {**cache, "length": cache["length"] + 1})
    return lm_decode_step


def _decode_token(real):
    calls = [0]

    def lm_decode_step(model, cache, token, sctx=None):
        logits, new = real(model, cache, token, sctx)
        calls[0] += 1
        if calls[0] == ALTERED_CALL:
            row = logits[0]
            row[row.argmin()] = row.max() + 1
        return logits, new
    return lm_decode_step


def plant(kind: str, loop: str):
    """The fault ``kind`` for a cell whose mix runs ``loop``."""
    from repro_torch.launch import steps
    from repro_torch.optim import adamw

    table = {("train", "unchanged"): (adamw, "apply_updates", _adamw_still),
             ("train", "half_batch"): (steps, "lm_train_step", _train_half),
             ("decode", "unchanged"): (steps, "lm_decode_step",
                                       _decode_still),
             ("decode", "half_batch"): (steps, "lm_decode_step",
                                        _decode_half),
             ("decode", "token"): (steps, "lm_decode_step", _decode_token)}
    if (loop, kind) not in table:
        raise ValueError(f"no fault {kind!r} for a {loop} loop")
    return _patched(*table[loop, kind])
