"""The benchmark's own yardstick: the chip's peaks and the operations and
bytes a step or a kernel launch needs, computed from shapes alone.

Nothing here reads the program: a later change to a kernel or a model
cannot change what its work is counted as.  Every count is of what the
algorithm needs, not of what an implementation happens to do: model FLOPs
leave recomputation out, and a kernel's bytes count each input read once
and each output written once.
"""
from __future__ import annotations

import dataclasses
import math

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class LmShape:
    """The sizes of a decoder-only LM that its work depends on, read from a
    configuration file's published keys."""
    vocab: int
    n_layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    experts: int
    top_k: int
    window: int
    tied: bool
    qk_norm: bool

    @classmethod
    def of(cls, config: dict) -> "LmShape":
        d, heads = config["hidden_size"], config["num_attention_heads"]
        return cls(vocab=config["vocab_size"],
                   n_layers=config["num_hidden_layers"], d=d, heads=heads,
                   kv_heads=config["num_key_value_heads"],
                   head_dim=config.get("head_dim") or d // heads,
                   d_ff=config["intermediate_size"],
                   experts=config.get("num_local_experts") or 0,
                   top_k=config.get("num_experts_per_tok") or 0,
                   window=config.get("sliding_window") or 0,
                   tied=bool(config.get("tie_word_embeddings")),
                   qk_norm=bool(config.get("qk_norm")))

    def attn_params(self) -> int:
        q = self.heads * self.head_dim
        kv = self.kv_heads * self.head_dim
        return self.d * q + 2 * self.d * kv + q * self.d

    def ffn_params(self, active: bool) -> int:
        """The FFN's matmul weights a token passes through (``active``) or
        that the layer holds; an MoE layer's router included."""
        one = 3 * self.d * self.d_ff
        if not self.experts:
            return one
        return (self.top_k if active else self.experts) * one \
            + self.d * self.experts

    def matmul_params(self, active: bool = True) -> int:
        """Weights that take part in a product for each token: every
        layer's projections and FFN, and the head (the embedding lookup is
        no product)."""
        return self.n_layers * (self.attn_params() + self.ffn_params(active)) \
            + self.d * self.vocab

    def params(self) -> int:
        """Every parameter held: products, the embedding table (shared
        with the head where tied) and the RMSNorm scales."""
        norms = self.n_layers * (2 * self.d
                                 + 2 * self.head_dim * self.qk_norm) + self.d
        table = 0 if self.tied else self.vocab * self.d
        return self.matmul_params(active=False) + table + norms


def causal_pairs(S: int, K: int, window: int = 0) -> int:
    """(query, key) pairs a causal attention of S queries over K keys keeps,
    query i sitting at position i + K - S; ``window`` > 0 keeps only keys
    less than ``window`` positions back."""
    total = 0
    for i in range(S):
        pos = i + K - S
        lo = max(0, pos - window + 1) if window > 0 else 0
        total += pos - lo + 1
    return total


def _pairs(S: int, window: int) -> int:
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return causal_pairs(S, S, window)


def train_step_flops(shape: LmShape, batch: int, seq: int) -> float:
    """Model FLOPs of one training step over ``batch`` sequences of ``seq``
    tokens: 6 a matmul weight a token (forward 2, backward 4), and the
    causal attention's four products forward and eight backward a kept
    pair, head and layer.  Recomputation is not counted."""
    tokens = batch * seq
    attn = 12 * _pairs(seq, shape.window) * shape.head_dim * shape.heads \
        * shape.n_layers * batch
    return 6.0 * shape.matmul_params(active=True) * tokens + attn


FLASH_PRODUCTS = {"fwd": 2, "dq": 3, "dkv": 4}


def flash_launch(kind: str, batch: int, seq: int, heads: int, kv_heads: int,
                 head_dim: int, window: int = 0, elem_bytes: int = 2):
    """(FLOPs, bytes) one flash-attention launch needs on (batch, seq,
    heads, head_dim) queries against as many keys, causal: 2·head_dim a
    kept pair for each of its products (forward QKᵀ and PV; dq: QKᵀ, dO Vᵀ
    and dS K; dk/dv: QKᵀ, dO Vᵀ, Pᵀ dO and dSᵀ Q), and its inputs read and
    outputs written once: q, k, v (and for the backward dO, the rows'
    log-sum-exp and delta, f32) in, the output (and the forward's f32
    log-sum-exp) or the gradients out."""
    pairs = _pairs(seq, window)
    flops = FLASH_PRODUCTS[kind] * 2 * batch * heads * head_dim * pairs
    q = batch * seq * heads * head_dim * elem_bytes
    kv = batch * seq * kv_heads * head_dim * elem_bytes
    rows = batch * heads * seq * 4
    if kind == "fwd":
        data = q + 2 * kv + q + rows
    elif kind == "dq":
        data = q + 2 * kv + q + 2 * rows + q
    else:
        data = q + 2 * kv + q + 2 * rows + 2 * kv
    return float(flops), float(data)


def least_seconds(flops: float, data: float, dtype: str = "bfloat16"):
    """The least time the chip could take: the larger of the operations at
    the peak rate of ``dtype`` and the bytes at the HBM rate."""
    return max(flops / PEAK_FLOPS[dtype], data / HBM_BYTES_PER_S)


def decode_step_work(shape: LmShape, batch: int, cache_len: int,
                     weight_bytes: int = 2, cache_bytes: int = 2):
    """(FLOPs, bytes) of one decode step of ``batch`` rows, each attending
    ``cache_len`` cached positions: 2 a matmul weight a row and the four
    attention products over every attended key; the weights read once
    (the embedding's ``batch`` rows, or the whole table where it is the
    tied head), every attended key and value read once, the new ones and
    the logits written once."""
    attended = min(cache_len, shape.window) if shape.window else cache_len
    kv_row = shape.kv_heads * shape.head_dim * cache_bytes
    flops = 2.0 * shape.matmul_params(active=True) * batch \
        + 4.0 * attended * shape.head_dim * shape.heads * shape.n_layers \
        * batch
    # an MoE step reads every expert some row routes to: all of them
    held = shape.matmul_params(active=not shape.experts)
    norms = shape.params() - shape.matmul_params(active=False) \
        - (0 if shape.tied else shape.vocab * shape.d)
    embed_rows = 0 if shape.tied else batch * shape.d
    data = (held + norms + embed_rows) * weight_bytes \
        + 2 * shape.n_layers * batch * attended * kv_row \
        + 2 * shape.n_layers * batch * kv_row + batch * shape.vocab * 2
    return flops, float(data)


def mfu_share(seconds_needed: float, seconds_taken: float):
    """A share of the chip's roofline, in percent; None where nothing was
    timed."""
    if seconds_taken <= 0 or not math.isfinite(seconds_taken):
        return None
    return 100.0 * seconds_needed / seconds_taken
