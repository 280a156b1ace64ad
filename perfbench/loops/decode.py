"""The decode loop: ``launch.steps.lm_decode_step`` in a closed loop, B rows
decoding together through a ring-buffer KV cache, each row's next token
its greedy argmax, fed back on the device with no host read between
steps.

Set-up draws the weights (in the mix's type) and a full cache from the
seed, so every slot of the ring is filled and every step attends
``cache_len`` positions whatever the rate; it runs ``warm_steps`` steps.
The window then runs steps until its seconds are out, a CUDA event
recorded after each: ``decode_tokens_per_s`` is every token of every step
launched in the window over its seconds, ended by a synchronize, and
``decode_itl_p90_ms`` the 90th percentile (nearest rank) of the time
between consecutive steps' events, over every step of the window.

After the window the program's state is freed and the reference
(``reference.model.decode_reference``) replays every step from the first,
fed the served tokens, on the same weights and cache.  Compared, each
against the cell's limit: ``token_gap``, the widest gap by which a
served token's logit lies below the reference's best logit at that step;
``kv_err``, the worst layer's relative error (Frobenius) of the keys, and
of the values, that the program wrote into the cache, against the
reference's.
"""
from __future__ import annotations

import math
import time

import torch

from .. import program, traffic, weights
from ..reference import model as ref_model
from ..tracing import Recorder
from .common import Record, check, peak_bytes, release, sync, worst

AFTER = 2         # steps the window runs at least, after a traced stretch


def build(cell, seed: int, device):
    """The program's model, the first tokens and the cache."""
    from repro_torch.models.transformer import TransformerLM

    config, mix = cell.config, cell.mix
    cfg = program.transformer_config(config, mix)
    dtype = program.DTYPES[mix["weights_dtype"]]
    params = weights.make(config, seed, dtype, device)
    model = TransformerLM(cfg, weights.nest(params), device=device)
    del params
    first, cache = traffic.decode_start(mix, config, seed, dtype, device)
    return model, first, cache


def nearest_rank(values, q: float) -> float:
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


class Decoder:
    """The program's steps, each row's token fed back on the device."""

    def __init__(self, model, first, cache, max_steps: int, device):
        B = first.shape[0]
        self.model, self.cache = model, cache
        self.served = torch.empty((max_steps + 1, B), dtype=torch.long,
                                  device=device)
        self.served[0] = first
        self.bad = torch.zeros((), dtype=torch.long, device=device)
        self.cuda = device.type == "cuda"
        self.marks = ([torch.cuda.Event(enable_timing=True)
                       for _ in range(max_steps + 1)] if self.cuda else None)
        self.host = [time.perf_counter()]
        self.t = 0
        if self.cuda:
            self.marks[0].record()

    def step(self):
        from repro_torch.launch import steps

        if self.t + 1 >= self.served.shape[0]:
            raise RuntimeError("the window ran past the mix's max_steps")
        logits, self.cache = steps.lm_decode_step(self.model, self.cache,
                                                  self.served[self.t])
        self.served[self.t + 1] = logits.argmax(-1)
        self.bad += (~torch.isfinite(logits).all(-1)).sum()
        self.t += 1
        if self.cuda:
            self.marks[self.t].record()
        else:
            self.host.append(time.perf_counter())

    def gaps_ms(self, first: int, last: int):
        """Time between step ``i - 1``'s end and step ``i``'s, i in (first,
        last]."""
        if self.cuda:
            return [self.marks[i - 1].elapsed_time(self.marks[i])
                    for i in range(first + 1, last + 1)]
        return [1e3 * (self.host[i] - self.host[i - 1])
                for i in range(first + 1, last + 1)]


def written(cache, length0: int, n: int):
    """Keys and values of the slots the first ``n`` steps wrote, (L, B, n,
    Hkv, hd)."""
    S = cache["k"].shape[2]
    slots = (length0 + torch.arange(n, device=cache["k"].device)) % S
    return cache["k"][:, :, slots].clone(), cache["v"][:, :, slots].clone()


def reference_readings(cell, seed: int, device, tokens, others=()):
    """The reference's replay of the served ``tokens`` (n + 1, B) from the
    same weights and cache: (gaps (n, B), its decoder, the gaps of each
    of ``others``' top tokens).  ``others`` names precisions of further
    decoders fed beside it (the control: "fp8")."""
    config, mix = cell.config, cell.mix
    dims = ref_model.Dims.of(config)
    dtype = program.DTYPES[mix["weights_dtype"]]
    p = {n: t.float() for n, t in weights.make(config, seed, dtype,
                                               device).items()}
    _, cache = traffic.decode_start(mix, config, seed, dtype, device)
    length0 = int(cache["length"][0])
    n = tokens.shape[0] - 1
    more = [ref_model.RingDecoder(p, cache["k"], cache["v"], length0, dims,
                                  n, prec) for prec in others]
    gaps, dec, other_gaps = ref_model.decode_reference(
        p, cache["k"], cache["v"], length0, tokens, dims, others=more)
    return gaps, dec, other_gaps, more


def kv_error(k, v, dec) -> float:
    """The worst layer's relative error of ``k`` and of ``v`` against the
    keys and values the reference decoder ``dec`` wrote."""
    n = k.shape[2]
    errs = []
    for got, want in ((k, dec.new_k[:, :, :n]), (v, dec.new_v[:, :, :n])):
        for i in range(got.shape[0]):
            w = want[i].float()
            errs.append(float(torch.linalg.vector_norm(got[i].float() - w)
                              / torch.linalg.vector_norm(w)))
    return worst(errs)


def serve(cell, seed: int, seconds: float, trace: bool, device,
          clock0: float) -> dict:
    """Set-up and the window: the program's readings of the run, its served
    tokens (n + 1, B) and the keys and values it wrote; the program's
    state is freed on return."""
    mix = cell.mix
    model, first, cache = build(cell, seed, device)
    length0 = int(cache["length"][0])
    dec = Decoder(model, first, cache, mix["max_steps"], device)
    for _ in range(mix["warm_steps"]):
        dec.step()
    sync(device)
    setup_s = time.perf_counter() - clock0
    warm = dec.t
    t0 = time.perf_counter()
    rec = None
    if trace:
        rec = Recorder(device)
        rec.run(dec.step, mix["trace_steps"])
    t1, n1 = time.perf_counter(), dec.t
    while time.perf_counter() < t0 + seconds or dec.t < n1 + AFTER:
        dec.step()
    sync(device)
    end = time.perf_counter()
    out = {"setup_s": setup_s, "steps": dec.t - warm, "elapsed": end - t0,
           "itl_ms": dec.gaps_ms(warm, dec.t), "peak": peak_bytes(device),
           "trace": (rec.trace(cell.config, mix,
                               dec.t - n1, end - t1) if rec else None),
           "tokens": dec.served[:dec.t + 1].clone(),
           "kv": written(dec.cache, length0, dec.t), "failed": int(dec.bad)}
    del model, first, cache, dec, rec
    release(device)
    return out


def control_checks(cell, seed: int, seconds: float, device) -> dict:
    """The control's numbers: a float8 reference decoder fed the program's
    served tokens beside the f32 one, the gap of its top token and its
    keys' and values' error."""
    s = serve(cell, seed, seconds, False, device, time.perf_counter())
    _, ref, other, more = reference_readings(cell, seed, device,
                                             s["tokens"], others=("fp8",))
    n = s["tokens"].shape[0] - 1
    return {"token_gap": check(float(other[0].max()),
                               cell.limits["token_gap"]),
            "kv_err": check(kv_error(more[0].new_k[:, :, :n],
                                     more[0].new_v[:, :, :n], ref),
                            cell.limits["kv_err"])}


def run(cell, seed: int, seconds: float, trace: bool, device, clock0: float
        ) -> Record:
    s = serve(cell, seed, seconds, trace, device, clock0)
    gaps, ref, _, _ = reference_readings(cell, seed, device, s["tokens"])
    checks = {"token_gap": check(float(gaps.max()), cell.limits["token_gap"]),
              "kv_err": check(kv_error(*s["kv"], ref), cell.limits["kv_err"])}
    B, n = cell.mix["batch"], s["steps"]
    metrics = {"decode_tokens_per_s": n * B / s["elapsed"]}
    if s["itl_ms"]:
        metrics["decode_itl_p90_ms"] = nearest_rank(s["itl_ms"], 0.9)
    return Record(setup_s=s["setup_s"], metrics=metrics, attempted=n * B,
                  failed=s["failed"], memory_peak_bytes=s["peak"],
                  trace=s["trace"], checks=checks)
