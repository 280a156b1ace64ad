"""The training loop: ``launch.steps.lm_train_step`` in a closed loop, one
step after another on the same model and AdamW state.

Set-up draws the parameters, the optimizer state and a pool of batches
from the seed, and runs the first ``checked_steps`` steps through the
window's own call on rows that all differ; the readings that ``correct``
compares are taken then: each step's loss, every leaf's first gradient as
AdamW got it (its first moment after one step over 1 - b1) and every
leaf's change after the checked steps (the starting values drawn again).
The same model and state then run the window: ``train_tokens_per_s`` is
every token of every step launched in it over its seconds, ended by a
synchronize.  After the window the program's state is freed and the
reference (``reference.model``, ``reference.adamw``) follows the checked
steps from the same parameters and batches in f32.

Compared, each number that the cell's limits file (``perfbench/limits``)
names, against its limit: ``loss_gap``, the largest relative gap of a
step's loss; ``grad_gap``, the worst leaf's gap of first-gradient norms;
``change_gap``, the worst leaf's gap of change norms, over the leaves
whose first gradient in the reference is at least a thousandth of the
median leaf's (below that, Adam moves a leaf by round-off alone).  Each
leaf's gap is taken against the reference's norm of that leaf or the
median leaf's, whichever is larger.
"""
from __future__ import annotations

import statistics
import time

import torch

from .. import program, traffic, weights
from ..reference import adamw as ref_adamw
from ..reference import model as ref_model
from ..tracing import Recorder
from .common import (Record, check, peak_bytes, release, sync, worst,
                     worst_leaf_gap)

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
MOVING = 1e-3     # a leaf moves where its gradient is this share of the median
AFTER = 2         # steps the window runs at least, after a traced stretch


def build(cell, seed: int, device):
    """The program's model, AdamW config and state, and the batch pool."""
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.optim import adamw

    config, mix = cell.config, cell.mix
    cfg = program.transformer_config(config, mix)
    params = weights.make(config, seed, program.DTYPES[mix["param_dtype"]],
                          device)
    model = TransformerLM(cfg, weights.nest(params), device=device)
    del params
    opt_cfg = adamw.AdamWConfig(**mix["optimizer"])
    state = adamw.init_state(model, opt_cfg)
    tokens, labels = traffic.train_batches(mix, config["vocab_size"], seed,
                                           device)
    return model, opt_cfg, state, tokens, labels


def checked_steps(cell, seed, device, model, opt_cfg, state, tokens, labels):
    """The first steps, through the window's call; the program's
    readings."""
    from repro_torch.launch import steps

    named = dict(model.named_parameters())
    losses, norms = [], None
    for i in range(cell.mix["checked_steps"]):
        out = steps.lm_train_step(model, opt_cfg, state, tokens[i], labels[i])
        losses.append(out["loss"])
        if i == 0:
            first = {n: state["m"][n].float() / (1 - opt_cfg.b1)
                     for n in named}
            norms = dict(zip(named, torch.stack([
                torch.linalg.vector_norm(g) for g in first.values()]).tolist()))
            del first
    change = weights.change_norms(cell.config, seed, named, device)
    return {"losses": [float(x) for x in losses], "grad_norms": norms,
            "change_norms": change}


def reference_readings(cell, seed: int, device, prec: str = "f32"):
    """The reference's readings of the checked steps, from the same
    parameters and batches (``prec="fp8"``: the control)."""
    config, mix = cell.config, cell.mix
    dims = ref_model.Dims.of(config)
    p = {n: t.float().requires_grad_(True) for n, t in weights.make(
        config, seed, program.DTYPES[mix["param_dtype"]], device).items()}
    tokens, labels = traffic.train_batches(mix, config["vocab_size"], seed,
                                           device)
    state = ref_adamw.init(p)
    losses, norms = [], None
    for i in range(mix["checked_steps"]):
        losses.append(ref_model.loss_and_grads(
            p, tokens[i], labels[i], dims, mix.get("microbatches", 1), prec))
        info = ref_adamw.step(mix["optimizer"], p, state)
        if i == 0:
            norms = info["grad_norms"]
    change = weights.change_norms(config, seed, p, device)
    del p, state
    release(device)
    return {"losses": losses, "grad_norms": norms, "change_norms": change}


def control_checks(cell, seed: int, device) -> dict:
    """The control's numbers: the reference in float8 in the program's
    place, against the reference."""
    got = reference_readings(cell, seed, device, "fp8")
    want = reference_readings(cell, seed, device)
    return compare(got, want, cell.limits)


def compare(got: dict, want: dict, limits: dict) -> dict:
    """Each number the limits name, beside its limit."""
    med = statistics.median(want["grad_norms"].values())
    moving = [n for n, g in want["grad_norms"].items() if g >= MOVING * med]
    numbers = {
        "loss_gap": lambda: worst(abs(a - b) / abs(b) for a, b in
                                  zip(got["losses"], want["losses"])),
        "grad_gap": lambda: worst_leaf_gap(got["grad_norms"],
                                           want["grad_norms"]),
        "change_gap": lambda: worst_leaf_gap(got["change_norms"],
                                             want["change_norms"], moving)}
    return {k: check(numbers[k](), limit) for k, limit in limits.items()}


def run(cell, seed: int, seconds: float, trace: bool, device, clock0: float
        ) -> Record:
    from repro_torch.launch import steps

    mix = cell.mix
    model, opt_cfg, state, tokens, labels = build(cell, seed, device)
    got = checked_steps(cell, seed, device, model, opt_cfg, state, tokens,
                        labels)
    pool = tokens.shape[0]
    losses = []

    def one():
        i = (len(losses) + mix["checked_steps"]) % pool
        losses.append(steps.lm_train_step(model, opt_cfg, state, tokens[i],
                                          labels[i])["loss"])

    sync(device)
    setup_s = time.perf_counter() - clock0
    t0 = time.perf_counter()
    rec = None
    if trace:
        rec = Recorder(device)
        rec.run(one, mix["trace_steps"])
    t1, n1 = time.perf_counter(), len(losses)
    while time.perf_counter() < t0 + seconds or len(losses) < n1 + AFTER:
        one()
    sync(device)
    end = time.perf_counter()
    elapsed = end - t0
    n = len(losses)
    failed = sum(int((~torch.isfinite(x)).sum()) for x in losses)
    peak = peak_bytes(device)
    traced = (rec.trace(cell.config, mix, n - n1, end - t1)
              if rec else None)
    del model, opt_cfg, state, tokens, labels, losses, rec
    release(device)
    want = reference_readings(cell, seed, device)
    tokens_per_step = mix["batch"] * mix["seq_len"]
    return Record(setup_s=setup_s,
                  metrics={"train_tokens_per_s": n * tokens_per_step
                           / elapsed},
                  attempted=n, failed=failed, memory_peak_bytes=peak,
                  trace=traced, checks=compare(got, want, cell.limits))
