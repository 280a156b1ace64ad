"""The decoder-only LM of the JAX package's ``models/transformer.py``, for
all five architectures: its forward (logits and loss of one batch), its
gradients through autograd (``launch/steps.py::lm_train_step``), and its
serving path: ``prefill`` (the KV cache and the last position's logits)
and ``decode_step`` (one token against a ring-buffer KV cache).

One config-driven module:
  * dense SwiGLU FFN, or MoE (``models/moe.py``: top-1 with a shared
    expert for llama4, top-2 for mixtral); ``forward`` returns the sum of
    the layers' load-balancing losses as its aux
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
on the CPU); ``"xla"`` runs ``layers.attention_xla`` below
``CHUNKED_ATTN_THRESHOLD`` and ``layers.attention_xla_chunked`` (tuned by
``attn_chunk_q``, ``attn_chunk_kv``, ``attn_p_bf16`` and
``attn_static_skip``) from it on.  The reference's ``pallas`` path sees
its window as a traced scan value and drops it
(``kernels/flash_attention/ops.py:17``); the port keeps it, so for windowed
configs the port's ``pallas`` path equals the reference's ``xla`` path.
``prefill`` takes the ``xla`` branches whatever ``attention_impl`` is, as
the reference's does.

An MoE layer routes and dispatches all the tokens of its call at once, the
capacity counted over them (a microbatch's in training, the whole prompt's
in ``prefill``, the batch's one token each in ``decode_step``).

Sharding: ``forward``, ``loss_fn``, ``prefill`` and ``decode_step`` take
a :class:`ShardCtx` (``sctx``; defined in ``repro_torch.placement``,
which the GNNs and SASRec share, and re-exported here), the reference's
GSPMD hints as DTensor redistributions.  Under it the parameters are
DTensors placed by ``launch.sharding.lm_param_shardings``
(``launch.steps.place_lm``), the batch is a DTensor of rows split over
the data axes (each data rank keeps its contiguous block of the global
batch it is given), and ``sctx.cs`` places the activations where the
reference constrains them.  The training forward and ``prefill`` keep
the reference's placements: every weight stays in its own, and each
product runs on the rank's block of it as a ``local_map`` region whose
collectives (``ShardCtx.reduce``, ``reduce_grad``, ``gather``,
``to_d_blocks``) carry the backward too.  A data axis that splits a
weight is gathered (FSDP, as GSPMD gathers the reference's) and its
gradient reduce-scattered back; the model axis never is: the attention
projections and the dense SwiGLU are column- or row-parallel on the f
(or heads) block, their partial sums all-reduced over the model axis
(:func:`_projections`, :func:`_sharded_mlp`); the embedding is a
vocab-parallel masked lookup and the head a product on the rank's
vocabulary block (:func:`_sharded_lookup`; a tied table's gradient sums
both uses in its placement); an MoE layer runs on each rank's expert
blocks (:meth:`TransformerLM._sharded_moe`): the global dispatch trades
the rank's tokens for every token's block of d (an all-to-all over the
data axes) and routes all of them, the experts never moving, and
``moe_local_dispatch`` routes each data rank's own shard with its own
capacity, the experts' d gathered, their f on the model axis.  Norms and
residuals run on DTensors; RoPE, the attention (the flash kernels or the
chunked attention, on a batch shard and a head shard: where the heads do
not split over the model axis, on the axis's share of kv-head groups and
rows) and the loss run on each rank's local shard under ``local_map``.
``decode_step`` under a context is weight-stationary too, as GSPMD runs
the reference's ``decode_step`` (which reads no context) on its placed
parameters and KV cache: every rank computes on its own shards of both
(the cache in ``launch.sharding.kv_cache_shardings``' placements, rows
or, for one long stream, slots over the data axes and head_dim over the
model axis) and only activations move.  Without a context every path is
the one-device model, unchanged; a ``moe_local_dispatch`` config without
one dispatches globally, as the reference does.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..devices import (is_dtensor, randn, resolve_device, seeded_generator,
                       whole)
from ..kernels.flash_attention.ops import flash_attention
from ..placement import (ShardCtx, all_reduce, dtensor_types, mesh_axes,
                         shard_axes)
from .layers import (AttnParamsSpec, apply_rope, attention_decode_block,
                     attention_xla, attention_xla_chunked, attn_project,
                     attn_qkv, init_attn, init_mlp, make_attention_mask,
                     mlp_swiglu, mlp_swiglu_block, rms_norm)
from .moe import (MoeSpec, init_moe, moe_apply, moe_apply_block,
                  moe_apply_local)

# sequences >= this use the chunked (flash-style) XLA attention path
CHUNKED_ATTN_THRESHOLD = 2048


def _dtensor_types():
    return dtensor_types()[:3]


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
    def static_window(self):
        """The window when every layer has the same one, else None."""
        return (self.sliding_window
                if self.sliding_window > 0 and self.local_global_ratio == 0
                else None)

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    @property
    def attn_spec(self) -> AttnParamsSpec:
        return AttnParamsSpec(self.d_model, self.n_heads, self.n_kv_heads,
                              self.head_dim, self.qkv_bias, self.qk_norm)

    @property
    def moe_spec(self) -> MoeSpec:
        return MoeSpec(self.d_model, self.moe_d_ff or self.d_ff,
                       self.moe_experts, self.moe_top_k,
                       shared_expert=self.moe_shared_expert)

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


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {cfg.remat!r}")
    if cfg.attention_impl not in ("xla", "pallas"):
        raise ValueError(f"attention_impl must be 'xla' or 'pallas', got "
                         f"{cfg.attention_impl!r}")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def init_params(cfg: TransformerConfig, generator: torch.Generator,
                dtype=torch.float32) -> Dict:
    """The reference's parameter shapes and scales, drawn from
    ``generator`` on its device: {"embed", "layers": [per-layer dicts:
    "attn", "mlp" (dense) or "moe" (MoE: ``moe.init_moe``), "ln1",
    "ln2"], "final_norm", "lm_head" (unless tied)}."""
    _check_supported(cfg)
    dev = generator.device
    embed = randn((cfg.vocab, cfg.d_model), generator, dtype) * 0.02

    def ffn():
        if cfg.is_moe:
            return {"moe": init_moe(generator, cfg.moe_spec, dtype)}
        return {"mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, dtype)}

    layers = [{"attn": init_attn(generator, cfg.attn_spec, dtype), **ffn(),
               "ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
               "ln2": torch.zeros((cfg.d_model,), dtype=dtype, device=dev)}
              for _ in range(cfg.n_layers)]
    params = {"embed": embed, "layers": layers,
              "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                        device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = randn((cfg.d_model, cfg.vocab), generator,
                                  dtype) * 0.02
    return params


def _params(p: Dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in p.items()})


class MoeParams(nn.Module):
    """One MoE layer's parameters, read by ``moe_apply`` as a dict:
    "router", "w_gate", "w_up", "w_down" and, with a shared expert,
    "shared" {"w_gate", "w_up", "w_down"}."""

    def __init__(self, p: Dict):
        super().__init__()
        for k, v in p.items():
            setattr(self, k, _params(v) if isinstance(v, dict)
                    else nn.Parameter(v))

    def __getitem__(self, key):
        return getattr(self, key)

    def keys(self):
        return ([n for n, _ in self.named_parameters(recurse=False)]
                + [n for n, _ in self.named_children()])


class Block(nn.Module):
    """One decoder layer's parameters: "attn", "mlp" or "moe", "ln1",
    "ln2"."""

    def __init__(self, p: Dict):
        super().__init__()
        self.attn = _params(p["attn"])
        if "moe" in p:
            self.moe = MoeParams(p["moe"])
        else:
            self.mlp = _params(p["mlp"])
        self.ln1 = nn.Parameter(p["ln1"])
        self.ln2 = nn.Parameter(p["ln2"])


class TransformerLM(nn.Module):
    """The LM, dense or MoE, on one device.

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
                cfg, seeded_generator(dev, seed), dtype)
        if len(params["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(params['layers'])} layers of parameters "
                             f"for a {cfg.n_layers}-layer config")
        if cfg.tie_embeddings == ("lm_head" in params):
            raise ValueError("an lm_head is wanted exactly when the config "
                             "does not tie embeddings")
        ffn = "moe" if cfg.is_moe else "mlp"
        if any(ffn not in p for p in params["layers"]):
            raise ValueError(f"{cfg.name} wants an {ffn!r} in every layer")
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
        return self._xla_attention(q, k, v, window, positions)

    def _xla_attention(self, q, k, v, window: int, positions):
        """The reference's xla branches: chunked from
        ``CHUNKED_ATTN_THRESHOLD`` on, masked below."""
        cfg = self.cfg
        if q.shape[1] >= CHUNKED_ATTN_THRESHOLD:
            return attention_xla_chunked(
                q, k, v, positions, positions, window=window, causal=True,
                chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
                p_bf16=cfg.attn_p_bf16,
                static_positions=cfg.attn_static_skip,
                static_window=cfg.static_window)
        mask = make_attention_mask(positions, positions, window, causal=True)
        return attention_xla(q, k, v, mask[:, None, None, :, :])

    def _ffn(self, layer: Block, h, sctx: Optional[ShardCtx] = None):
        """The layer's FFN on its normed input: (out, aux f32 or None)."""
        if self.cfg.is_moe:
            if sctx is not None:
                return self._sharded_moe(layer.moe, h, sctx)
            return moe_apply(layer.moe, h, self.cfg.moe_spec)
        if sctx is not None:
            return _sharded_mlp(layer.mlp, h, sctx), None
        return mlp_swiglu(layer.mlp, h), None

    def _sharded_moe(self, moe, h, sctx: ShardCtx):
        """An MoE layer on a DTensor ``h`` (rows over the data axes) under
        ``sctx``, in the reference's placements: a region on each rank's
        rows and expert blocks.  The experts' d stays split over the data
        axes and their f over the model axis.

        Global dispatch: the rank's (T/P, d) tokens are traded for every
        token's block of d, (T, d/P) (an all-to-all over the data axes);
        ``moe.moe_apply_block`` routes all T on all-reduced logits and
        runs the experts on the rank's (d/P, f/M) blocks, which never
        move; the output is traded back; a shared expert runs on the
        rank's rows (``mlp_swiglu_block``, its weights' d gathered).
        Where the rows do not split, every rank runs the global dispatch
        on its d block of all the tokens, as the sharded decode does
        (:func:`_moe_whole_rows`).  ``moe_local_dispatch``:
        ``moe.moe_apply_local`` on the rank's tokens, its shards (the
        reference's data shards) each routed and dispatched with its own
        capacity, the experts' d gathered over the data axes (their
        gradients reduce-scattered back), f on the model axis; the aux
        loss is the shards' mean.  Each reduces the f blocks' partial
        sums over the model axis once, the shared expert's with them."""
        spec, mesh = self.cfg.moe_spec, sctx.mesh
        h_pl = sctx.placements(h.shape, sctx.dp, None, None)
        rows = shard_axes(h_pl, mesh, 0)
        d_axes = shard_axes(moe["w_gate"].placements, mesh, 1)
        f_axes = shard_axes(moe["w_gate"].placements, mesh, 2)
        names = ("router", "w_gate", "w_up", "w_down")
        weights = [moe[k] for k in names]
        if spec.shared_expert:
            weights += [moe["shared"][k] for k in names[1:]]
        local = self.cfg.moe_local_dispatch
        if not local and rows and tuple(rows) != tuple(d_axes):
            raise ValueError(f"the global dispatch trades tokens split over "
                             f"{rows} for d split over {d_axes}")
        n_rows = int(np.prod([mesh_axes(mesh)[a] for a in rows]))

        def fn(xl, *wl):
            Bl, S, d = xl.shape
            xt = xl.reshape(Bl * S, d)
            if local:
                wl = [_fsdp(sctx, v, w, rows, xl.dtype)
                      for v, w in zip(wl, weights)]
            p = dict(zip(names, wl))
            if spec.shared_expert:
                p["shared"] = dict(zip(names[1:], wl[4:]))
            if local:
                out, aux = moe_apply_local(
                    p, xt, spec, sctx.dp_size // n_rows, sctx, f_axes)
                out, aux = sctx.reduce(out, f_axes), aux / n_rows
            elif not rows:
                out, aux = _moe_whole_rows(p, xt, spec, sctx, d_axes, f_axes)
            else:
                out, aux = moe_apply_block(p, sctx.to_d_blocks(xt, d_axes),
                                           spec, sctx, d_axes, f_axes)
                out = sctx.to_row_blocks(out, d_axes)
                if spec.shared_expert:   # on the rows, its weights' d
                    shared = {k: _fsdp(sctx, v, w, rows, xl.dtype)
                              for (k, v), w in zip(p["shared"].items(),
                                                   weights[4:])}
                    out = out + mlp_swiglu_block(
                        shared, sctx.reduce_grad(xt, f_axes), sctx, (),
                        f_axes, reduce_f=False)
                out = sctx.reduce(out, f_axes)
            return out.reshape(Bl, S, d), aux

        aux_pl = sctx.grad_placements(h_pl) if local else sctx.placements(())
        return _region(sctx, fn, [h_pl, aux_pl], h, h_pl, weights)

    def _rope(self, sctx: ShardCtx, t):
        """RoPE on a (B, S, heads, hd) DTensor, on each rank's rows."""
        S, theta = t.shape[1], self.cfg.rope_theta

        def fn(tl):
            pos = torch.arange(S, dtype=torch.int32,
                               device=tl.device).expand(tl.shape[0], S)
            return apply_rope(tl, pos, theta)

        return sctx.local(fn, [t.placements], [t.placements])(t)

    def _sharded_attention(self, sctx: ShardCtx, q, k, v, window: int,
                           attention):
        """``attention`` on each rank's batch shard and head shard.
        Where q's heads split over the model axis and k, v's do not (Hkv
        does not divide), a rank reads the kv heads its query heads
        group into, and their gradients are partial sums over the axis.
        Where q's heads do not split either (H does not divide), the
        model axis's ranks share the work by kv-head groups and rows
        (:func:`_attention_split`): each computes its block into zeros,
        and the output and the inputs' gradients are partial sums over
        the axis (whole on every rank where neither splits)."""
        Partial = _dtensor_types()[1]
        q_pl, kv_pl = tuple(q.placements), tuple(k.placements)
        H, Hkv = q.shape[2], k.shape[2]
        G, S = H // Hkv, q.shape[1]
        m = list(mesh_axes(sctx.mesh)).index(sctx.model)
        M = sctx.mesh.size(m)
        q_split, kv_split = q_pl[m].is_shard(), kv_pl[m].is_shard()
        q_grad, kv_grad, out_pl = q_pl, kv_pl, q_pl
        part = None
        if q_split and not kv_split:
            r = sctx.mesh.get_local_rank(sctx.model)
            Hl = H // M
            lo, hi = r * Hl // G, ((r + 1) * Hl - 1) // G + 1
            if Hl % (hi - lo):
                raise ValueError(f"{Hl} query heads a rank do not group "
                                 f"into {hi - lo} kv heads")
            kv_grad = kv_pl[:m] + (Partial(),) + kv_pl[m + 1:]
        elif not q_split and not kv_split and M > 1:
            rows = math.prod(sctx.mesh.size(i) for i, p in enumerate(q_pl)
                             if p.is_shard(0))
            part = _attention_split(M, Hkv, q.shape[0] // rows,
                                    sctx.mesh.get_local_rank(sctx.model))
        if part is not None:
            q_grad, kv_grad, out_pl = (pl[:m] + (Partial(),) + pl[m + 1:]
                                       for pl in (q_pl, kv_pl, q_pl))

        def fn(ql, kl, vl):
            if q_split and not kv_split:
                kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
            if part is None:
                pos = torch.arange(S, dtype=torch.int32,
                                   device=ql.device).expand(ql.shape[0], S)
                return attention(ql, kl, vl, window, pos)
            rs, kvh = part
            qh = slice(kvh.start * G, kvh.stop * G)
            out = ql.new_zeros(ql.shape)
            if rs.stop > rs.start:
                a = ql[rs][:, :, qh].contiguous()
                pos = torch.arange(S, dtype=torch.int32,
                                   device=ql.device).expand(a.shape[0], S)
                out[rs, :, qh] = attention(
                    a, kl[rs][:, :, kvh].contiguous(),
                    vl[rs][:, :, kvh].contiguous(), window, pos)
            return out

        return sctx.local(fn, [out_pl], [q_pl, kv_pl, kv_pl],
                          [q_grad, kv_grad, kv_grad])(q, k, v)

    def _layer(self, layer: Block, window: int, x, positions,
               attention=None, sctx: Optional[ShardCtx] = None):
        """One decoder layer: x (B, S, d) -> (x (B, S, d), aux, k, v), aux
        the MoE load-balancing loss (None for a dense layer), k and v (B,
        S, Hkv, hd) the layer's rotated keys and values.  Under ``sctx``
        x is a DTensor and so are the four results."""
        B, S, _ = x.shape
        attention = attention or self._attention
        h = rms_norm(x, layer.ln1)
        if sctx is None:
            q, k, v = attn_qkv(layer.attn, h, self.cfg.attn_spec, positions,
                               self.cfg.rope_theta)
            attn_out = attention(q, k, v, window, positions)
            x = x + attn_out.reshape(B, S, -1) @ layer.attn["wo"].to(x.dtype)
            out, aux = self._ffn(layer, rms_norm(x, layer.ln2))
            return x + out, aux, k, v
        dp, mdl = sctx.dp, sctx.model

        def heads_cs(t, heads):
            # a projection whose heads do not split over the model axis
            # is gathered whole on it before it splits into heads
            if heads % mesh_axes(sctx.mesh)[mdl]:
                return sctx.cs(t, dp, None, None)
            return t

        q, k, v = attn_project(layer.attn, h, self.cfg.attn_spec, heads_cs,
                               functools.partial(_projections, sctx))
        q = self._rope(sctx, sctx.cs(q, dp, None, mdl, None))
        k = self._rope(sctx, sctx.cs(k, dp, None, mdl, None))
        v = sctx.cs(v, dp, None, mdl, None)
        attn_out = self._sharded_attention(sctx, q, k, v, window, attention)
        attn_flat = sctx.cs(attn_out.reshape(B, S, -1), dp, None, mdl)
        x = x + _projections(sctx, attn_flat, [layer.attn["wo"]])[0]
        out, aux = self._ffn(layer, rms_norm(x, layer.ln2), sctx)
        return sctx.cs(x + out, dp, None, None), aux, k, v

    def _block(self, layer: Block, window: int, x, positions, sctx=None):
        return self._layer(layer, window, x, positions, sctx=sctx)[:2]

    def _embed(self, tokens, sctx: Optional[ShardCtx] = None):
        """(x (B, S, d) in ``cfg.dtype``, positions (B, S) int32; None
        under ``sctx``, where each rank makes its own rows').  Under
        ``sctx`` a vocab-parallel masked lookup on each rank's block of
        the table (:func:`_sharded_lookup`)."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        if sctx is not None:
            return _sharded_lookup(self.embed, sctx.batch(tokens),
                                   self.cfg.dtype, sctx), None
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=self.device).expand(B, S)
        return self.embed[tokens].to(self.cfg.dtype), positions

    def _logits(self, x, sctx: Optional[ShardCtx] = None):
        """Logits of the last hidden states; under ``sctx`` the head's
        product on each rank's (d, vocabulary) block, the vocabulary split
        over the model axis (the tied table used transposed)."""
        x = rms_norm(x, self.final_norm)
        tied = self.cfg.tie_embeddings
        head = self.embed if tied else self.lm_head
        if sctx is None:
            return x @ (head.T if tied else head).to(self.cfg.dtype)
        return _projections(sctx, x, [head], transposed=tied)[0]

    def forward(self, tokens, sctx: Optional[ShardCtx] = None):
        """tokens: (B, S) -> (logits (B, S, V) in ``cfg.dtype``, aux_loss:
        the sum over layers of the MoE load-balancing losses, f32; 0 for a
        dense config).  Under ``sctx`` both are DTensors, the logits split
        over the batch and the vocabulary, the aux replicated; every
        product and its backward run on the rank's weight blocks (the
        module's docstring)."""
        cfg = self.cfg
        x, positions = self._embed(tokens, sctx)
        auxs = []
        for layer, window in zip(self.layers, self.windows):
            if cfg.remat == "none":
                x, aux = self._block(layer, window, x, positions, sctx)
            elif cfg.remat == "full":
                x, aux = checkpoint(self._block, layer, window, x, positions,
                                    sctx, use_reentrant=False)
            else:
                x, aux = checkpoint(self._block, layer, window, x, positions,
                                    sctx, use_reentrant=False,
                                    context_fn=functools.partial(
                                        create_selective_checkpoint_contexts,
                                        _dots_policy))
            if aux is not None:
                auxs.append(aux if sctx is None else sctx.replicate(aux))
        if auxs:
            aux = torch.stack(auxs).sum()
        else:
            aux = torch.zeros((), dtype=torch.float32, device=self.device)
            if sctx is not None:
                aux = _dtensor_types()[0].from_local(
                    aux, sctx.mesh, sctx.placements(()), run_check=False)
        return self._logits(x, sctx), aux

    def loss_fn(self, tokens, labels, aux_weight: float = 0.01,
                sctx: Optional[ShardCtx] = None):
        """(loss, {"nll", "aux"}) of next-token prediction on one batch
        (under ``sctx`` replicated DTensors)."""
        logits, aux = self(tokens, sctx)
        return lm_loss(logits, aux, labels, aux_weight, sctx=sctx)

    @torch.no_grad()
    def prefill(self, tokens, sctx: Optional[ShardCtx] = None):
        """tokens: (B, S) -> (last logits (B, V) in ``cfg.dtype``, cache
        {"k", "v": (L, B, S, Hkv, hd) in ``cfg.dtype``, "length": (B,)
        int32, all S}).  Attention takes the reference's xla branches
        (chunked at S >= ``CHUNKED_ATTN_THRESHOLD``, masked below) whatever
        ``attention_impl`` is.  Under ``sctx`` the logits and the cache's
        k and v are DTensors (rows over the data axes, kv heads over the
        model axis where they divide), computed by the training forward's
        regions on the rank's weight blocks."""
        cfg = self.cfg
        x, positions = self._embed(tokens, sctx)
        B, S = x.shape[:2]
        if sctx is not None:
            ks, vs = [], []
            for layer, window in zip(self.layers, self.windows):
                x, _, k, v = self._layer(layer, window, x, None,
                                         attention=self._xla_attention,
                                         sctx=sctx)
                ks.append(k)
                vs.append(v)
            return self._logits(x[:, -1], sctx), {
                "k": torch.stack(ks), "v": torch.stack(vs),
                "length": torch.full((B,), S, dtype=torch.int32,
                                     device=self.device)}
        shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
        ks = torch.empty(shape, dtype=cfg.dtype, device=self.device)
        vs = torch.empty_like(ks)
        for i, (layer, window) in enumerate(zip(self.layers, self.windows)):
            x, _, k, v = self._layer(layer, window, x, positions,
                                     attention=self._xla_attention)
            ks[i].copy_(k)
            vs[i].copy_(v)
            del k, v
        logits = self._logits(x[:, -1])
        return logits, {"k": ks, "v": vs,
                        "length": torch.full((B,), S, dtype=torch.int32,
                                             device=self.device)}

    @torch.no_grad()
    def decode_step(self, cache, token, sctx: Optional[ShardCtx] = None):
        """One decode step: token (B,) against ``cache`` (k/v (L, B, S,
        Hkv, hd), S the allocated length, and ``length`` (B,) int32, the
        tokens so far) -> (logits (B, V) in ``cfg.dtype``, {"k", "v",
        "length": length + 1}).

        The cache is a ring buffer: the new key and value go to slot
        ``length[0] % S`` (every row decodes in step), written in place
        into ``cache``'s own k and v (the counterpart of the reference's
        donated buffer, with no host read of the slot), and slot i holds
        absolute position ``cur - cur % S + i`` up to the slot just
        written, ``cur - cur % S - S + i`` past it.  A slot is attended
        when its position lies in [0, cur] and, for a windowed layer,
        within the window.

        Under ``sctx`` (the parameters placed by ``launch.steps.place_lm``,
        the cache's k and v DTensors that split only its rows, slots and
        head_dim, as ``launch.steps.place_cache`` places them) the step is
        weight-stationary (:meth:`_decode_sharded`): no parameter or cache
        shard leaves its rank, only activations move, and each rank
        computes its own block of the work.  The logits come back as a
        DTensor (rows over the data axes, the vocabulary over the model
        axis), the cache in the placements it came in; a cache in any
        other placement raises ``ValueError``
        (``launch.steps.lm_decode_step`` holds it to
        ``kv_cache_shardings``' placements)."""
        if sctx is not None:
            return self._decode_sharded(cache, token, sctx)
        cfg = self.cfg
        kc, vc, length = cache["k"], cache["v"], cache["length"]
        L, B, S = kc.shape[:3]
        token = torch.as_tensor(token, device=self.device).long()
        x = self.embed[token].to(cfg.dtype)[:, None, :]            # (B, 1, d)
        pos = length[:, None]                                      # (B, 1)
        slot, valid, diff = _ring(length, S, slice(0, S), slice(None))
        for i, (layer, window) in enumerate(zip(self.layers, self.windows)):
            h = rms_norm(x, layer.ln1)
            q, k_new, v_new = attn_qkv(layer.attn, h, cfg.attn_spec, pos,
                                       cfg.rope_theta)
            kc[i].index_copy_(1, slot, k_new.to(kc.dtype))
            vc[i].index_copy_(1, slot, v_new.to(vc.dtype))
            mask = valid & (diff < window) if window > 0 else valid
            attn_out = attention_xla(q, kc[i], vc[i],
                                     mask[:, None, None, :, :])
            x = x + attn_out.reshape(B, 1, -1) @ layer.attn["wo"].to(x.dtype)
            x = x + self._ffn(layer, rms_norm(x, layer.ln2))[0]
        return self._logits(x[:, 0]), {"k": kc, "v": vc,
                                       "length": length + 1}

    # ------------------------------------------------ the sharded decode
    def _decode_sharded(self, cache, token, sctx: ShardCtx):
        """``decode_step`` under ``sctx``, the reference's GSPMD decode with
        its placements kept, on each rank's local shards.

        The activations of the B tokens, (B, d) a few KB a row, are whole
        on every rank.  A projection is column- or row-parallel on the
        rank's block of its weight: its product on the rank's block of
        the contracted dimension is a partial sum, all-reduced over the
        axes that split that dimension, then gathered whole over those
        that split the other (:func:`_product`).  The embedding is a
        masked lookup on the rank's vocabulary rows, all-reduced over the
        model axis; the logits a product on the rank's (d, vocabulary)
        block of the head, reduce-scattered into rows over the data axes.
        Attention (``attention_decode_block``) runs on the rank's rows
        (or, for a single long stream, its slots) and head_dim block of
        the cache, q, k and v whole first, so qk-norm and RoPE see the
        whole head_dim: the partial scores are all-reduced over the model
        axis, a split sequence's softmax is split-K over the data axis,
        and an axis the cache is replicated over (a long stream's pod
        axis) splits the kv heads.  An MoE layer dispatches globally, as
        the reference's decode does, on each rank's expert blocks
        (``moe.moe_apply_block``).  The new key and value are written in
        place into the rank's cache block, on a split sequence only by
        the data rank that owns slot ``length[0] % S`` (the others write
        back what the slot held; nothing is read on the host).  A
        dimension whose axis fell back to replicated is whole on every
        rank of that axis, which computes it whole."""
        DTensor = _dtensor_types()[0]
        cfg, mesh = self.cfg, sctx.mesh
        if not is_dtensor(self.embed) or self.embed.device_mesh != mesh:
            raise ValueError("the parameters are not placed on the "
                             "context's mesh: call launch.steps.place_lm "
                             "once before the steps")
        kd, vd, length = cache["k"], cache["v"], cache["length"]
        L, B, S, Hkv, hd = kd.shape
        pl = tuple(kd.placements) if is_dtensor(kd) else None
        if pl is None or not is_dtensor(vd) or tuple(vd.placements) != pl \
                or {kd.device_mesh, vd.device_mesh} != {mesh} \
                or any(not p.is_replicate() and not any(
                    p.is_shard(d) for d in (1, 2, 4)) for p in pl):
            raise ValueError(
                "the cache's k and v must be DTensors on the context's mesh "
                "in one placement that splits only the rows, the slots and "
                "head_dim (launch.steps.place_cache), not "
                f"{pl or 'a plain tensor'}")
        kc, vc = kd.to_local(), vd.to_local()
        length_l = _replicated_local(length, "the cache's length")
        token = (whole(token) if is_dtensor(token) else torch.as_tensor(
            token, device=self.device)).long()
        row_axes = shard_axes(pl, mesh, 1)
        seq_axes = shard_axes(pl, mesh, 2)
        hd_axes = shard_axes(pl, mesh, 4)
        # the axes the cache is replicated over (a long stream's pod axis)
        # split its kv heads for the attention, where they divide
        head_axes, n = [], 1
        for a, size in mesh_axes(mesh).items():
            if a not in row_axes + seq_axes + hd_axes \
                    and Hkv % (n * size) == 0:
                head_axes.append(a)
                n *= size
        rows, slots = sctx.block(B, row_axes), sctx.block(S, seq_axes)
        hd_block = sctx.block(hd, hd_axes)
        kv_heads = sctx.block(Hkv, head_axes)
        G = cfg.n_heads // Hkv
        q_heads = slice(kv_heads.start * G, kv_heads.stop * G)
        S_l = slots.stop - slots.start

        pos = length_l[:, None]                                    # (B, 1)
        slot, valid, diff = _ring(length_l, S, slots, rows)
        owner = None
        if seq_axes:
            local = slot - slots.start
            owner = (local >= 0) & (local < S_l)
            slot = local.clamp(0, S_l - 1)

        def write(block, new):
            new = new[rows][..., hd_block].to(block.dtype)
            if owner is not None:
                new = torch.where(owner, new, block.index_select(1, slot))
            block.index_copy_(1, slot, new)

        def reduce_hd(t):
            return sctx.reduce(t, hd_axes)

        reduce_seq = None
        if seq_axes:
            def reduce_seq(t, op):
                return sctx.reduce(t, seq_axes, op)

        x = self._embed_block(token, sctx)[:, None, :]              # (B, 1, d)
        for i, (layer, window) in enumerate(zip(self.layers, self.windows)):
            h = rms_norm(x, _replicated_local(layer.ln1, "ln1"))
            q, k_new, v_new = self._qkv_whole(layer.attn, h, pos, sctx)
            write(kc[i], k_new)
            write(vc[i], v_new)
            mask = valid & (diff < window) if window > 0 else valid
            out = attention_decode_block(
                q[rows][:, :, q_heads], kc[i][:, :, kv_heads],
                vc[i][:, :, kv_heads], mask, hd_block, reduce_hd, reduce_seq)
            out = sctx.gather(sctx.gather(sctx.gather(
                out, head_axes, 2), hd_axes, -1), row_axes, 0)
            x = x + _product(out.reshape(B, 1, -1), layer.attn["wo"], sctx)
            x = x + self._ffn_block(
                layer, rms_norm(x, _replicated_local(layer.ln2, "ln2")),
                sctx)
        logits = self._logits_block(x[:, 0], sctx)
        if is_dtensor(length):
            length = DTensor.from_local(length_l + 1, mesh,
                                        length.placements, run_check=False)
        else:
            length = length + 1
        return logits, {"k": kd, "v": vd, "length": length}

    def _embed_block(self, token, sctx: ShardCtx):
        """(B, d) embeddings whole on every rank: each rank looks up the
        tokens in its vocabulary rows (zeros for the others' tokens), the
        sum over the model axis is the lookup, then the d blocks are
        gathered."""
        table, mesh = self.embed, sctx.mesh
        local = table.to_local()
        idx = token - sctx.block(
            table.shape[0], shard_axes(table.placements, mesh, 0)).start
        mine = (idx >= 0) & (idx < local.shape[0])
        rows = local[idx.clamp(0, local.shape[0] - 1)].to(self.cfg.dtype)
        x = sctx.reduce(torch.where(mine[:, None], rows, 0.0),
                        shard_axes(table.placements, mesh, 0))
        return sctx.gather(x, shard_axes(table.placements, mesh, 1), -1)

    def _qkv_whole(self, attn, h, pos, sctx: ShardCtx):
        """``attn_qkv`` on the rank's weight blocks: q (B, 1, H, hd), k and
        v (B, 1, Hkv, hd) whole on every rank, biased, qk-normed and
        rotated."""
        spec, B = self.cfg.attn_spec, h.shape[0]
        out = []
        for w, b, heads in (("wq", "bq", spec.n_heads),
                            ("wk", "bk", spec.n_kv_heads),
                            ("wv", "bv", spec.n_kv_heads)):
            y = _product(h, attn[w], sctx)
            if spec.qkv_bias:
                y = y + _replicated_local(attn[b], b).to(h.dtype)
            out.append(y.reshape(B, 1, heads, spec.head_dim))
        q, k, v = out
        if spec.qk_norm:
            q = rms_norm(q, _replicated_local(attn["q_norm"], "q_norm"))
            k = rms_norm(k, _replicated_local(attn["k_norm"], "k_norm"))
        theta = self.cfg.rope_theta
        return apply_rope(q, pos, theta), apply_rope(k, pos, theta), v

    def _ffn_block(self, layer: Block, h, sctx: ShardCtx):
        """The layer's FFN on its normed input (whole on every rank), on
        the rank's (d, f) blocks of its weights; the output gathered
        whole."""
        mesh = sctx.mesh
        if self.cfg.is_moe:
            moe = layer.moe
            d_axes = shard_axes(moe["w_gate"].placements, mesh, 1)
            f_axes = shard_axes(moe["w_gate"].placements, mesh, 2)
            need = {"w_gate": ((), d_axes, f_axes),
                    "w_up": ((), d_axes, f_axes),
                    "w_down": ((), f_axes, d_axes), "router": (d_axes, ())}
            local = {k: _blocks(moe[k], want, sctx, k)
                     for k, want in need.items()}
            if self.cfg.moe_spec.shared_expert:
                local["shared"] = _mlp_blocks(moe["shared"], d_axes, f_axes,
                                              sctx)
            out = _moe_whole_rows(local, h.reshape(-1, h.shape[-1]),
                                  self.cfg.moe_spec, sctx, d_axes, f_axes)[0]
            return out.reshape(h.shape)
        mlp = layer.mlp
        d_axes = shard_axes(mlp["w_gate"].placements, mesh, 0)
        f_axes = shard_axes(mlp["w_gate"].placements, mesh, 1)
        out = mlp_swiglu_block(_mlp_blocks(mlp, d_axes, f_axes, sctx),
                               h[..., sctx.block(h.shape[-1], d_axes)],
                               sctx, d_axes, f_axes)
        return sctx.gather(out, d_axes, -1)

    def _logits_block(self, x, sctx: ShardCtx):
        """(B, V) logits of the last hidden states (whole on every rank)
        from the rank's (d, vocabulary) block of the head, as a DTensor in
        ``_logits``' placements: the partial sums over the d blocks are
        reduce-scattered into the rows' blocks (all-reduced where the rows
        do not split)."""
        DTensor = _dtensor_types()[0]
        mesh = sctx.mesh
        x = rms_norm(x, _replicated_local(self.final_norm, "final_norm"))
        if self.cfg.tie_embeddings:
            head, dims = self.embed, (1, 0)
        else:
            head, dims = self.lm_head, (0, 1)
        d_axes = shard_axes(head.placements, mesh, dims[0])
        v_axes = shard_axes(head.placements, mesh, dims[1])
        local = head.to_local()
        if self.cfg.tie_embeddings:
            local = local.T
        part = x[:, sctx.block(x.shape[-1], d_axes)] @ local.to(
            self.cfg.dtype)
        B, V = x.shape[0], head.shape[dims[1]]
        pl = sctx.placements((B, V), sctx.dp, sctx.model)
        if shard_axes(pl, mesh, 1) != v_axes:
            raise ValueError(f"the head's vocabulary is split over {v_axes},"
                             f" the logits' over {shard_axes(pl, mesh, 1)}")
        row_axes = shard_axes(pl, mesh, 0)
        for a in mesh_axes(mesh):
            if a in d_axes and a in row_axes:
                part = sctx.scatter(part, (a,), 0)
            elif a in d_axes:
                part = sctx.reduce(part, (a,))
            elif a in row_axes:
                n = part.shape[0] // mesh_axes(mesh)[a]
                r = mesh.get_local_rank(a)
                part = part[r * n:(r + 1) * n]
        return DTensor.from_local(part, mesh, pl, run_check=False,
                                  shape=(B, V), stride=(V, 1))


def _attention_split(M: int, Hkv: int, rows: int, r: int):
    """(rows, kv heads) slices of the attention that rank ``r`` of an
    ``M``-rank model axis computes where the query heads do not split
    over the axis: the kv heads (with their query groups) split into the
    most parts h of M that divide Hkv, the rows into the most parts of
    M / h that divide ``rows``; a rank past those parts computes nothing
    (empty slices).  None where neither splits."""
    h = max(n for n in range(1, min(M, Hkv) + 1)
            if M % n == 0 and Hkv % n == 0)
    parts = max(n for n in range(1, M // h + 1)
                if (M // h) % n == 0 and rows % n == 0)
    if h * parts == 1:
        return None
    i, j = divmod(r, h)
    if i >= parts:
        return slice(0, 0), slice(0, 0)
    nr, nh = rows // parts, Hkv // h
    return slice(i * nr, (i + 1) * nr), slice(j * nh, (j + 1) * nh)


def _ring(length, S: int, slots: slice, rows: slice):
    """The ring buffer's rule for the cache's slots ``slots`` of the rows
    ``rows``: (the new token's slot ``length[0] % S`` (1,), valid (b, 1,
    n), diff (b, 1, n)).  Slot i holds absolute position ``cur - cur % S +
    i`` up to the slot just written, ``cur - cur % S - S + i`` past it; it
    is valid when that lies in [0, cur], and ``diff`` is the row's position
    less it, which a windowed layer bounds."""
    pos = length[rows, None]                                     # (b, 1)
    cur = length[0]
    base = cur - cur % S
    k_pos = torch.arange(slots.start, slots.stop, dtype=length.dtype,
                         device=length.device)
    abs_pos = torch.where(k_pos <= cur % S, base + k_pos,
                          base - S + k_pos).expand(pos.shape[0], -1)
    valid = ((abs_pos >= 0) & (abs_pos <= cur))[:, None, :]
    diff = pos[:, :, None] - abs_pos[:, None, :]
    return (cur % S).long().reshape(1), valid, diff


def _replicated_local(p, what: str):
    """A replicated DTensor's (or a plain tensor's) whole value on this
    rank."""
    if not is_dtensor(p):
        return p
    if not all(pl.is_replicate() for pl in p.placements):
        raise ValueError(f"{what} must be replicated, not {p.placements}")
    return p.to_local()


def _blocks(p, axes, sctx: ShardCtx, what: str):
    """This rank's block of DTensor parameter ``p``, which must split each
    dimension over ``axes[dim]``."""
    got = tuple(shard_axes(p.placements, sctx.mesh, d)
                for d in range(p.dim()))
    if got != tuple(axes):
        raise ValueError(f"{what} is split over {got}, the sharded decode "
                         f"wants {tuple(axes)}")
    return p.to_local()


def _mlp_blocks(mlp, d_axes, f_axes, sctx: ShardCtx):
    return {"w_gate": _blocks(mlp["w_gate"], (d_axes, f_axes), sctx,
                              "w_gate"),
            "w_up": _blocks(mlp["w_up"], (d_axes, f_axes), sctx, "w_up"),
            "w_down": _blocks(mlp["w_down"], (f_axes, d_axes), sctx,
                              "w_down")}


def _product(x, w, sctx: ShardCtx):
    """x (..., n) (whole on every rank) @ w (n, m), a DTensor, on the
    rank's block of w: its n block of x times its block, all-reduced over
    the axes that split n, then gathered whole over those that split m.
    A column-parallel projection (w split over m) and a row-parallel one
    (over n) alike."""
    mesh = sctx.mesh
    n_axes = shard_axes(w.placements, mesh, 0)
    y = x[..., sctx.block(x.shape[-1], n_axes)] @ w.to_local().to(x.dtype)
    return sctx.gather(sctx.reduce(y, n_axes),
                       shard_axes(w.placements, mesh, 1), -1)


def _moe_whole_rows(p, xt, spec: MoeSpec, sctx: ShardCtx, d_axes, f_axes):
    """The global dispatch of tokens whole on every rank, ``xt`` (T, d), on
    the rank's blocks ``p`` of the weights (``moe.moe_apply_block``'s, a
    shared expert's under "shared"): the routed and the shared experts on
    the rank's d block of the tokens, the f blocks' partial sums
    all-reduced over ``f_axes``, the d blocks gathered.  (out (T, d), aux
    f32): the sharded decode's MoE, and the sharded train step's and
    prefill's where the rows do not split."""
    xb = xt[:, sctx.block(xt.shape[-1], d_axes)]
    out, aux = moe_apply_block(p, xb, spec, sctx, d_axes, f_axes)
    if "shared" in p:
        out = out + mlp_swiglu_block(p["shared"],
                                     sctx.reduce_grad(xb, f_axes), sctx,
                                     d_axes, f_axes, reduce_f=False)
    return sctx.gather(sctx.reduce(out, f_axes), d_axes, 1, summed=()), aux


# ------------------------------- the sharded train and prefill regions
# Each runs on a rank's local shards (``ShardCtx.local``): the activations'
# rows over the data axes, every weight in its own placements.  A data
# axis that splits a weight is gathered (FSDP, as GSPMD gathers the
# reference's), the model axis never: each product runs on the rank's
# block of f (or heads, or vocabulary), its partial sums all-reduced over
# the model axis, and its backward stays on the same blocks.
def _fsdp(sctx: ShardCtx, local, param, rows, dtype):
    """``local``, the rank's block of parameter ``param``, in ``dtype`` and
    gathered whole over the data axes that split it; its gradient is
    reduce-scattered back over those of them in ``rows`` (the axes that
    split the activations' rows, where each rank's gradient is a partial
    sum) and taken as this rank's block over the others.  A split over the
    model axis stays."""
    t = local.to(dtype)
    for dim in range(param.dim()):
        axes = [a for a in shard_axes(param.placements, sctx.mesh, dim)
                if a != sctx.model]
        t = sctx.gather(t, axes, dim, summed=rows)
    return t


def _grad_pl(sctx: ShardCtx, param, rows) -> tuple:
    """The placements of a region's gradient of ``param``: its own, but a
    partial sum over a mesh axis that splits the rows (``rows``) and not
    the parameter."""
    Partial = _dtensor_types()[1]
    return tuple(Partial() if p.is_replicate() and a in rows else p
                 for a, p in zip(mesh_axes(sctx.mesh), param.placements))


def _region(sctx: ShardCtx, fn, outs, x, x_pl, weights):
    """``fn(x_local, *weight_locals)`` as a ``local_map`` region: x
    redistributed to ``x_pl`` (its gradient there too), each weight in its
    own placements (its gradient in :func:`_grad_pl`'s), ``outs`` the
    placements of each output."""
    rows = shard_axes(x_pl, sctx.mesh, 0)
    return sctx.local(fn, outs, [x_pl] + [w.placements for w in weights],
                      [x_pl] + [_grad_pl(sctx, w, rows)
                                for w in weights])(x, *weights)


def _projections(sctx: ShardCtx, x, weights, transposed: bool = False):
    """[x @ w for w in ``weights``] on a DTensor x (..., n), rows over the
    data axes, each w an (n, m) parameter ((m, n), used transposed, where
    ``transposed``), in one region on the rank's weight blocks: a weight
    whose m splits over the model axis is column-parallel (x whole on the
    axis, its gradient all-reduced over it once for all such products);
    one whose n does is row-parallel (x's n split alike, the partial
    products all-reduced over the axis).  The data axes' blocks are
    gathered (:func:`_fsdp`).  No rank computes a product whole."""
    mesh, model = sctx.mesh, sctx.model
    n_dim, m_dim = (1, 0) if transposed else (0, 1)
    row = {model in shard_axes(w.placements, mesh, n_dim) for w in weights}
    if len(row) != 1:
        raise ValueError("row- and column-parallel weights in one region")
    row = row.pop()
    lead = [None] * (x.dim() - 2)
    x_pl = sctx.placements(x.shape, sctx.dp, *lead, model if row else None)
    rows = shard_axes(x_pl, mesh, 0)
    column = [model in shard_axes(w.placements, mesh, m_dim)
              for w in weights]
    outs = [sctx.placements(x.shape[:-1] + (w.shape[m_dim],), sctx.dp,
                            *lead, model if c else None)
            for w, c in zip(weights, column)]

    def fn(xl, *wl):
        xf, ys = None, []
        for w, b, c in zip(weights, wl, column):
            b = _fsdp(sctx, b, w, rows, xl.dtype)
            if c and xf is None:
                xf = sctx.reduce_grad(xl, (model,))
            y = (xf if c else xl) @ (b.T if transposed else b)
            ys.append(sctx.reduce(y, (model,)) if row else y)
        return ys if len(ys) > 1 else ys[0]

    out = _region(sctx, fn, outs, x, x_pl, weights)
    return list(out) if len(weights) > 1 else [out]


def _sharded_mlp(mlp, h, sctx: ShardCtx):
    """The dense SwiGLU on a DTensor ``h`` (rows over the data axes) in one
    region: ``mlp_swiglu_block`` on the rank's f block of each weight, its
    d gathered (:func:`_fsdp`), down's partial sums all-reduced over the
    model axis and the input's gradient likewise."""
    mesh = sctx.mesh
    h_pl = sctx.placements(h.shape, sctx.dp, None, None)
    rows = shard_axes(h_pl, mesh, 0)
    f_axes = shard_axes(mlp["w_gate"].placements, mesh, 1)
    names = ("w_gate", "w_up", "w_down")
    weights = [mlp[k] for k in names]

    def fn(xl, *wl):
        p = {k: _fsdp(sctx, b, w, rows, xl.dtype)
             for k, b, w in zip(names, wl, weights)}
        return mlp_swiglu_block(p, sctx.reduce_grad(xl, f_axes), sctx, (),
                                f_axes)

    return _region(sctx, fn, [h_pl], h, h_pl, weights)


def _sharded_lookup(table, tok, dtype, sctx: ShardCtx):
    """(B, S, d) embeddings in ``dtype`` of ``tok`` (a DTensor of rows over
    the data axes), vocab-parallel: each rank looks its tokens up in its
    vocabulary rows of the table, their d gathered over the data axes
    (in the table's dtype, as the plain lookup reads them; the gradient
    reduce-scattered back), zeros for the other ranks' tokens, and the
    sum over the model axis is the lookup.  No rank holds the whole table
    or its whole gradient."""
    mesh, V = sctx.mesh, table.shape[0]
    tok_pl = tuple(tok.placements)
    rows = shard_axes(tok_pl, mesh, 0)
    v_axes = shard_axes(table.placements, mesh, 0)
    x_pl = sctx.placements(tuple(tok.shape) + (table.shape[1],), sctx.dp,
                           None, None)

    def fn(t, ids):
        t = _fsdp(sctx, t, table, rows, t.dtype)
        if not v_axes:
            return t[ids].to(dtype)
        idx = ids - sctx.block(V, v_axes).start
        mine = (idx >= 0) & (idx < t.shape[0])
        x = torch.where(mine[..., None], t[idx.clamp(0, t.shape[0] - 1)],
                        0.0).to(dtype)
        return sctx.reduce(x, v_axes)

    return sctx.local(fn, [x_pl], [table.placements, tok_pl],
                      [_grad_pl(sctx, table, rows), tok_pl])(table, tok)


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


class _VocabShardNLL(torch.autograd.Function):
    """:class:`_NextTokenNLL` of logits whose vocabulary is split over a
    group (this rank's slice starting at ``v0``), as GSPMD computes the
    reference's ``logsumexp`` and ``take_along_axis`` on vocab-split
    logits: the row maxima, the sums of exponentials and the gold logits
    are each all-reduced over the group, and each rank's gradient is its
    own slice of (softmax - onehot) / N.  The whole vocabulary is never
    gathered."""

    @staticmethod
    def forward(ctx, logits, labels, group, v0):
        Vl = logits.shape[-1]
        flat, lab = logits.reshape(-1, Vl), labels.reshape(-1) - v0
        mine = (lab >= 0) & (lab < Vl)
        idx = torch.where(mine, lab, 0)[:, None]
        rows = max(1, LOSS_CHUNK_ELEMENTS // Vl)
        top = torch.empty(flat.shape[0], dtype=torch.float32,
                          device=logits.device)
        for r in range(0, flat.shape[0], rows):
            top[r:r + rows] = flat[r:r + rows].float().amax(-1)
        top = all_reduce(top, "max", group)
        sums, gold = torch.empty_like(top), torch.empty_like(top)
        for r in range(0, flat.shape[0], rows):
            x = flat[r:r + rows].float()
            sums[r:r + rows] = torch.exp(x - top[r:r + rows, None]).sum(-1)
            gold[r:r + rows] = torch.gather(x, -1, idx[r:r + rows])[:, 0]
        gold = all_reduce(torch.where(mine, gold, 0.0), "sum", group)
        logz = top + torch.log(all_reduce(sums, "sum", group))
        ctx.save_for_backward(logits, idx, mine, logz)
        return (logz - gold).mean()

    @staticmethod
    def backward(ctx, g):
        logits, idx, mine, logz = ctx.saved_tensors
        Vl = logits.shape[-1]
        flat = logits.reshape(-1, Vl)
        rows = max(1, LOSS_CHUNK_ELEMENTS // Vl)
        scale = g / flat.shape[0]
        grad = torch.empty_like(flat)
        for r in range(0, flat.shape[0], rows):
            p = torch.exp(flat[r:r + rows].float() - logz[r:r + rows, None])
            p.scatter_add_(-1, idx[r:r + rows],
                           -mine[r:r + rows, None].float())
            grad[r:r + rows] = p.mul_(scale)
        return grad.reshape(logits.shape), None, None, None


def lm_loss(logits: torch.Tensor, aux: torch.Tensor, labels,
            aux_weight: float = 0.01, sctx: Optional[ShardCtx] = None):
    """The reference ``loss_fn``'s loss from ``forward``'s outputs: mean
    next-token NLL in f32, plus ``aux_weight * aux``.  Under ``sctx`` each
    rank takes the NLL of its rows, weighted by its share of the batch,
    and the sum over the data axes is replicated: the loss and its parts
    are replicated DTensors.  Logits whose vocabulary splits over more
    than one rank of the model axis stay split (:class:`_VocabShardNLL`);
    others are gathered over the vocabulary first."""
    labels = torch.as_tensor(labels, device=logits.device).long()
    if sctx is None:
        nll = _NextTokenNLL.apply(logits, labels)
        return nll + aux_weight * aux, {"nll": nll, "aux": aux}
    labels = sctx.batch(labels)
    B, V = logits.shape[0], logits.shape[-1]
    m = list(mesh_axes(sctx.mesh)).index(sctx.model)
    split = sctx.mesh.size(m) > 1 and logits.placements[m].is_shard(2)
    if split:
        group = sctx.mesh.get_group(sctx.model)
        v0 = sctx.mesh.get_local_rank(sctx.model) * (V // sctx.mesh.size(m))
    else:
        logits = sctx.cs(logits, sctx.dp, None, None)
    pl, lpl = tuple(logits.placements), tuple(labels.placements)

    def fn(lg, lb):
        nll = (_VocabShardNLL.apply(lg, lb, group, v0) if split
               else _NextTokenNLL.apply(lg, lb))
        return nll * (lg.shape[0] / B)

    nll = sctx.local(fn, [sctx.grad_placements(lpl)], [pl, lpl])(logits,
                                                                  labels)
    nll = sctx.replicate(nll)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}
