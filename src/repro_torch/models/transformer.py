"""The decoder-only LM of the JAX package's ``models/transformer.py``, for
the dense architectures: its forward (logits and loss of one batch) and,
through autograd, its gradients (``launch/steps.py::lm_train_step``).

One config-driven module:
  * dense SwiGLU FFN
  * GQA, optional QKV bias / qk-norm
  * full, sliding-window, or local:global attention patterns
  * one module per layer, looped in Python, so each layer's window is a
    plain ``int``
  * ``remat``: "none"; "full", each layer under non-reentrant activation
    checkpointing (the reference's ``jax.checkpoint``); "dots", selective
    checkpointing that saves the outputs of the plain matmuls
    (``aten.mm``/``addmm``, the reference's
    ``dots_with_no_batch_dims_saveable``) and recomputes the rest

``attention_impl="pallas"`` sends every layer's attention to
``kernels.flash_attention`` (the CUDA kernel on the card, its plain version
on the CPU); ``"xla"`` runs ``layers.attention_xla``.  The reference's
``pallas`` path sees its window as a traced scan value and drops it
(``kernels/flash_attention/ops.py:17``); the port keeps it, so for windowed
configs the port's ``pallas`` path equals the reference's ``xla`` path.

Not in this slice (each raises, naming its ROADMAP queue 1 item): MoE
configs, the chunked XLA attention at
S >= ``CHUNKED_ATTN_THRESHOLD`` and a non-default value of its settings
(``attn_chunk_q``, ``attn_chunk_kv``, ``attn_p_bf16``,
``attn_static_skip``) or of ``moe_local_dispatch``, ``prefill`` and
``decode_step``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..devices import resolve_device
from ..kernels.flash_attention.ops import flash_attention
from .layers import (AttnParamsSpec, attention_xla, attn_qkv, init_attn,
                     init_mlp, make_attention_mask, mlp_swiglu, rms_norm)

# sequences >= this use the chunked (flash-style) XLA attention path
CHUNKED_ATTN_THRESHOLD = 2048

_SERVING = "LM serving (ROADMAP queue 1, item 3)"
_MOE = "MoE LM (ROADMAP queue 1, item 4)"


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    vocab: int
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    max_seq_len: int = 131072
    sliding_window: int = 0            # 0 = full attention
    local_global_ratio: int = 0        # k => k local layers then 1 global
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                  # expert hidden size (if != d_ff)
    moe_shared_expert: bool = False
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    remat: str = "none"                # none | full | dots
    attention_impl: str = "xla"        # xla | pallas
    # perf knobs of the reference's chunked attention and MoE dispatch
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 512
    attn_p_bf16: bool = False          # cast softmax P to bf16 before PV dot
    attn_static_skip: bool = False     # static causal chunk skipping
    moe_local_dispatch: bool = False   # per-dp-shard MoE dispatch
    n_microbatches: int = 1            # gradient accumulation inside the step

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    @property
    def attn_spec(self) -> AttnParamsSpec:
        return AttnParamsSpec(self.d_model, self.n_heads, self.n_kv_heads,
                              self.head_dim, self.qkv_bias, self.qk_norm)

    def layer_windows(self) -> np.ndarray:
        """Per-layer attention window (0 = full)."""
        if self.local_global_ratio > 0:
            r = self.local_global_ratio
            # gemma3 pattern: r local layers, then 1 global
            w = np.full(self.n_layers, self.sliding_window or 1024, np.int32)
            w[r::r + 1] = 0
            return w
        return np.full(self.n_layers, self.sliding_window, np.int32)

    def param_count(self) -> int:
        d, f, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        H, Hkv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * (H * hd) + 2 * d * (Hkv * hd) + (H * hd) * d
        if self.is_moe:
            fe = self.moe_d_ff or f
            ffn = self.moe_experts * 3 * d * fe + d * self.moe_experts
            if self.moe_shared_expert:
                ffn += 3 * d * fe
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        head = 0 if self.tie_embeddings else V * d
        return V * d + L * per_layer + head + d

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed top-k experts)."""
        if not self.is_moe:
            return self.param_count()
        d, V, L = self.d_model, self.vocab, self.n_layers
        H, Hkv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        fe = self.moe_d_ff or self.d_ff
        attn = d * (H * hd) + 2 * d * (Hkv * hd) + (H * hd) * d
        ffn = self.moe_top_k * 3 * d * fe + d * self.moe_experts
        if self.moe_shared_expert:
            ffn += 3 * d * fe
        per_layer = attn + ffn + 2 * d
        head = 0 if self.tie_embeddings else V * d
        return V * d + L * per_layer + head + d


REMAT = ("none", "full", "dots")
# the matmuls "dots" keeps: a 2-D product has no batch dims
_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


# settings that tune code not ported yet; the port reads none of them, so a
# value other than the default raises rather than being ignored
_UNREAD_SETTINGS = {"attn_chunk_q": ("the chunked XLA attention", _SERVING),
                    "attn_chunk_kv": ("the chunked XLA attention", _SERVING),
                    "attn_p_bf16": ("the chunked XLA attention", _SERVING),
                    "attn_static_skip": ("the chunked XLA attention",
                                         _SERVING),
                    "moe_local_dispatch": ("the MoE dispatch", _MOE)}


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: MoE layers are not ported "
                                  f"yet: {_MOE}")
    if cfg.remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {cfg.remat!r}")
    for f in dataclasses.fields(cfg):
        if f.name in _UNREAD_SETTINGS and getattr(cfg, f.name) != f.default:
            what, item = _UNREAD_SETTINGS[f.name]
            raise NotImplementedError(
                f"{f.name}={getattr(cfg, f.name)!r} tunes {what}, not "
                f"ported yet: {item}")
    if cfg.attention_impl not in ("xla", "pallas"):
        raise ValueError(f"attention_impl must be 'xla' or 'pallas', got "
                         f"{cfg.attention_impl!r}")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def init_params(cfg: TransformerConfig, generator: torch.Generator,
                dtype=torch.float32) -> Dict:
    """The reference's parameter shapes and scales, drawn from
    ``generator`` on its device: {"embed", "layers": [per-layer dicts],
    "final_norm", "lm_head" (unless tied)}."""
    _check_supported(cfg)
    dev = generator.device
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                        dtype=dtype, device=dev) * 0.02
    layers = [{"attn": init_attn(generator, cfg.attn_spec, dtype),
               "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, dtype),
               "ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
               "ln2": torch.zeros((cfg.d_model,), dtype=dtype, device=dev)}
              for _ in range(cfg.n_layers)]
    params = {"embed": embed, "layers": layers,
              "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                        device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = torch.randn(
            (cfg.d_model, cfg.vocab), generator=generator, dtype=dtype,
            device=dev) * 0.02
    return params


class Block(nn.Module):
    """One decoder layer's parameters."""

    def __init__(self, p: Dict):
        super().__init__()
        self.attn = nn.ParameterDict({k: nn.Parameter(v)
                                      for k, v in p["attn"].items()})
        self.mlp = nn.ParameterDict({k: nn.Parameter(v)
                                     for k, v in p["mlp"].items()})
        self.ln1 = nn.Parameter(p["ln1"])
        self.ln2 = nn.Parameter(p["ln2"])


class TransformerLM(nn.Module):
    """The dense LM on one device.

    ``params`` is a dict laid out as :func:`init_params` returns it (or as
    ``repro_torch.convert.lm_params_from_reference`` carries it over from
    the JAX package); without it the parameters are drawn from a
    ``torch.Generator`` seeded with ``seed`` on the device, in ``dtype``.
    The module takes the given tensors as its parameters without a copy
    (on their device), so training updates them in place.
    Parameters keep their dtype and are cast to ``cfg.dtype`` at use, so
    their gradients flow back through the casts in the parameters' own
    dtype (f32 by default, as the reference's training keeps them).  The
    module runs on CUDA unless ``device`` asks for the CPU; it raises where
    CUDA is missing.
    """

    def __init__(self, cfg: TransformerConfig, params: Optional[Dict] = None,
                 *, device=None, seed: int = 0, dtype=torch.float32):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        dev = resolve_device(device, "TransformerLM")
        if params is None:
            params = init_params(
                cfg, torch.Generator(device=dev).manual_seed(seed), dtype)
        if len(params["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(params['layers'])} layers of parameters "
                             f"for a {cfg.n_layers}-layer config")
        if cfg.tie_embeddings == ("lm_head" in params):
            raise ValueError("an lm_head is wanted exactly when the config "
                             "does not tie embeddings")
        self.embed = nn.Parameter(params["embed"])
        self.layers = nn.ModuleList(Block(p) for p in params["layers"])
        self.final_norm = nn.Parameter(params["final_norm"])
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(params["lm_head"])
        self.to(dev)
        self.windows = [int(w) for w in cfg.layer_windows()]

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _attention(self, q, k, v, window: int, positions):
        if self.cfg.attention_impl == "pallas":
            return flash_attention(q, k, v, causal=True, window=window)
        mask = make_attention_mask(positions, positions, window, causal=True)
        return attention_xla(q, k, v, mask[:, None, None, :, :])

    def _layer(self, layer: Block, window: int, x, positions):
        """One decoder layer: x (B, S, d) -> x (B, S, d)."""
        B, S, _ = x.shape
        h = rms_norm(x, layer.ln1)
        q, k, v = attn_qkv(layer.attn, h, self.cfg.attn_spec, positions,
                           self.cfg.rope_theta)
        attn_out = self._attention(q, k, v, window, positions)
        x = x + attn_out.reshape(B, S, -1) @ layer.attn["wo"].to(x.dtype)
        h2 = rms_norm(x, layer.ln2)
        return x + mlp_swiglu(layer.mlp, h2)

    def forward(self, tokens):
        """tokens: (B, S) -> (logits (B, S, V) in ``cfg.dtype``, aux_loss)."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        B, S = tokens.shape
        if cfg.attention_impl == "xla" and S >= CHUNKED_ATTN_THRESHOLD:
            raise NotImplementedError(
                f"attention_impl='xla' at S {S} >= {CHUNKED_ATTN_THRESHOLD} "
                f"takes the chunked XLA attention, not ported yet: "
                f"{_SERVING}")
        x = self.embed[tokens].to(cfg.dtype)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=self.device).expand(B, S)
        for layer, window in zip(self.layers, self.windows):
            if cfg.remat == "none":
                x = self._layer(layer, window, x, positions)
            elif cfg.remat == "full":
                x = checkpoint(self._layer, layer, window, x, positions,
                               use_reentrant=False)
            else:
                x = checkpoint(self._layer, layer, window, x, positions,
                               use_reentrant=False,
                               context_fn=functools.partial(
                                   create_selective_checkpoint_contexts,
                                   _dots_policy))
        x = rms_norm(x, self.final_norm)
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        logits = x @ head.to(cfg.dtype)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=self.device)

    def loss_fn(self, tokens, labels, aux_weight: float = 0.01):
        """(loss, {"nll", "aux"}) of next-token prediction on one batch."""
        logits, aux = self(tokens)
        return lm_loss(logits, aux, labels, aux_weight)

    def prefill(self, tokens):
        raise NotImplementedError(f"prefill belongs to {_SERVING}")

    def decode_step(self, cache, token):
        raise NotImplementedError(f"decode_step belongs to {_SERVING}")


# rows of logits taken to f32 at once by the loss (2^26 elements, 256 MiB)
LOSS_CHUNK_ELEMENTS = 1 << 26


class _NextTokenNLL(torch.autograd.Function):
    """mean(logsumexp(logits) - logits[label]) over every position, in f32,
    a few rows at a time: neither the f32 logits nor their f32 gradient is
    ever whole.  The gradient, (softmax - onehot) / N, is written in the
    logits' own type, as autograd through the reference's ``astype(f32)``
    would cast it.  For qwen3-4b at S 4096 this keeps some 7 GiB of f32
    logit-sized tensors out of the training step's peak."""

    @staticmethod
    def forward(ctx, logits, labels):
        V = logits.shape[-1]
        flat, lab = logits.reshape(-1, V), labels.reshape(-1)
        rows = max(1, LOSS_CHUNK_ELEMENTS // V)
        logz = torch.empty(flat.shape[0], dtype=torch.float32,
                           device=logits.device)
        gold = torch.empty_like(logz)
        for r in range(0, flat.shape[0], rows):
            x = flat[r:r + rows].float()
            logz[r:r + rows] = torch.logsumexp(x, dim=-1)
            gold[r:r + rows] = torch.gather(x, -1, lab[r:r + rows, None])[:, 0]
        ctx.save_for_backward(logits, labels, logz)
        return (logz - gold).mean()

    @staticmethod
    def backward(ctx, g):
        logits, labels, logz = ctx.saved_tensors
        V = logits.shape[-1]
        flat, lab = logits.reshape(-1, V), labels.reshape(-1)
        rows = max(1, LOSS_CHUNK_ELEMENTS // V)
        scale = g / flat.shape[0]
        grad = torch.empty_like(flat)
        for r in range(0, flat.shape[0], rows):
            p = torch.exp(flat[r:r + rows].float() - logz[r:r + rows, None])
            p.scatter_add_(-1, lab[r:r + rows, None],
                           torch.full_like(p[:, :1], -1.0))
            grad[r:r + rows] = p.mul_(scale)
        return grad.reshape(logits.shape), None


def lm_loss(logits: torch.Tensor, aux: torch.Tensor, labels,
            aux_weight: float = 0.01):
    """The reference ``loss_fn``'s loss from ``forward``'s outputs: mean
    next-token NLL in f32, plus ``aux_weight * aux``."""
    labels = torch.as_tensor(labels, device=logits.device).long()
    nll = _NextTokenNLL.apply(logits, labels)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}
