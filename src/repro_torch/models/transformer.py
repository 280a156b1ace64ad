"""The decoder-only LM of the JAX package's ``models/transformer.py``, for
the dense architectures: its forward (logits and loss of one batch).

One config-driven module:
  * dense SwiGLU FFN
  * GQA, optional QKV bias / qk-norm
  * full, sliding-window, or local:global attention patterns
  * one module per layer, looped in Python, so each layer's window is a
    plain ``int``

``attention_impl="pallas"`` sends every layer's attention to
``kernels.flash_attention`` (the CUDA kernel on the card, its plain version
on the CPU); ``"xla"`` runs ``layers.attention_xla``.  The reference's
``pallas`` path sees its window as a traced scan value and drops it
(``kernels/flash_attention/ops.py:17``); the port keeps it, so for windowed
configs the port's ``pallas`` path equals the reference's ``xla`` path.

Not in this slice (each raises, naming its ROADMAP queue 1 item): MoE
configs, ``remat``, ``n_microbatches > 1``, the chunked XLA attention at
S >= ``CHUNKED_ATTN_THRESHOLD`` and a non-default value of its settings
(``attn_chunk_q``, ``attn_chunk_kv``, ``attn_p_bf16``,
``attn_static_skip``) or of ``moe_local_dispatch``, ``prefill`` and
``decode_step``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..kernels.flash_attention.ops import flash_attention
from .layers import (AttnParamsSpec, attention_xla, attn_qkv, init_attn,
                     init_mlp, make_attention_mask, mlp_swiglu, rms_norm)

# sequences >= this use the chunked (flash-style) XLA attention path
CHUNKED_ATTN_THRESHOLD = 2048

_TRAINING = "LM training (ROADMAP queue 1, item 1)"
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
    if cfg.remat != "none":
        raise NotImplementedError(f"remat={cfg.remat!r} belongs to "
                                  f"{_TRAINING}")
    if cfg.n_microbatches != 1:
        raise NotImplementedError(f"n_microbatches={cfg.n_microbatches} "
                                  f"belongs to {_TRAINING}")
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


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "TransformerLM runs on CUDA and no CUDA device is available; "
            "pass device='cpu' to run on the host")
    return dev


def _frozen(t: torch.Tensor) -> nn.Parameter:
    # the forward has no backward kernel yet: parameters carry no grad
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One decoder layer's parameters."""

    def __init__(self, p: Dict):
        super().__init__()
        self.attn = nn.ParameterDict({k: _frozen(v)
                                      for k, v in p["attn"].items()})
        self.mlp = nn.ParameterDict({k: _frozen(v)
                                     for k, v in p["mlp"].items()})
        self.ln1 = _frozen(p["ln1"])
        self.ln2 = _frozen(p["ln2"])


class TransformerLM(nn.Module):
    """The dense LM on one device.

    ``params`` is a dict laid out as :func:`init_params` returns it (or as
    ``repro_torch.convert.lm_params_from_reference`` carries it over from
    the JAX package); without it the parameters are drawn from a
    ``torch.Generator`` seeded with ``seed`` on the device, in ``dtype``.
    Parameters keep their dtype and are cast to ``cfg.dtype`` at use.  The
    module runs on CUDA unless ``device`` asks for the CPU; it raises where
    CUDA is missing.
    """

    def __init__(self, cfg: TransformerConfig, params: Optional[Dict] = None,
                 *, device=None, seed: int = 0, dtype=torch.float32):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        dev = _resolve_device(device)
        if params is None:
            params = init_params(
                cfg, torch.Generator(device=dev).manual_seed(seed), dtype)
        if len(params["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(params['layers'])} layers of parameters "
                             f"for a {cfg.n_layers}-layer config")
        if cfg.tie_embeddings == ("lm_head" in params):
            raise ValueError("an lm_head is wanted exactly when the config "
                             "does not tie embeddings")
        self.embed = _frozen(params["embed"])
        self.layers = nn.ModuleList(Block(p) for p in params["layers"])
        self.final_norm = _frozen(params["final_norm"])
        if not cfg.tie_embeddings:
            self.lm_head = _frozen(params["lm_head"])
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
        spec = cfg.attn_spec
        for layer, window in zip(self.layers, self.windows):
            h = rms_norm(x, layer.ln1)
            q, k, v = attn_qkv(layer.attn, h, spec, positions,
                               cfg.rope_theta)
            attn_out = self._attention(q, k, v, window, positions)
            x = x + attn_out.reshape(B, S, -1) @ layer.attn["wo"].to(x.dtype)
            h2 = rms_norm(x, layer.ln2)
            x = x + mlp_swiglu(layer.mlp, h2)
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


def lm_loss(logits: torch.Tensor, aux: torch.Tensor, labels,
            aux_weight: float = 0.01):
    """The reference ``loss_fn``'s loss from ``forward``'s outputs: mean
    next-token NLL in f32, plus ``aux_weight * aux``."""
    labels = torch.as_tensor(labels, device=logits.device).long()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (logz - gold).mean()
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}
