"""SASRec (Kang & McAuley, arXiv:1808.09781), sasrec config: embed_dim 50,
2 blocks, 1 head, seq_len 50; the JAX package's ``models/sasrec.py`` as an
``nn.Module``.

The 1M x 50 item table is the hot path.  Every read of it (the history,
the candidates, the positive and negative next items) is the DHT's dedup
gather, :func:`core.dht.dedup_gather`: the Hopper ``dht_gather`` kernel on
the card, its plain version on the CPU, with an ``index_add_`` backward
into a dense table gradient.  Attention is ``models.layers.attention_xla``,
plain torch, as the JAX package computes it outside any Pallas kernel:
its -1e30 mask value gives the fully masked rows of a padded prefix a
uniform softmax, as in JAX, where SDPA or the flash kernel would give NaN
or zeros.  Retrieval against the whole table is one ``torch.matmul``, the
plain large product that the JAX package leaves to XLA.

Sharding: ``encode``, ``score_candidates``, ``retrieval_scores`` and
``loss_fn`` take a :class:`~repro_torch.placement.ShardCtx` (``sctx``).
Under it the item table's rows lie over the model axis and the other
parameters are replicated (``launch.sharding.rec_param_shardings``,
placed once by ``launch.steps.place_rec``); a (B, ...) batch given as a
global tensor is split over the data axes, each data rank its contiguous
block, or replicated where B does not divide (``ShardCtx.batch``).  Every
read of the table is ``dedup_gather``'s region (the kernel on this
rank's slice, the rows all-reduced over the model axis); the blocks run on
each rank's batch rows in a region of their own; retrieval multiplies
the user states by this rank's slice of the table, so its (B, n_items)
scores stay split over the model axis on the item dimension (and over the
data axes on B where it divides), never gathered; the loss's two sums
are all-reduced.  The steps run these under ``ShardCtx.implicit()``
(forward and backward), as a caller driving them by hand must.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..core.dht import dedup_gather
from ..devices import is_dtensor, seeded_generator, randn, resolve_device
from ..placement import dtensor_types
from .layers import attention_xla, make_attention_mask

BLOCK_WEIGHTS = ("wq", "wk", "wv", "wo", "ffn_w1", "ffn_w2")


@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    name: str = "sasrec"
    n_items: int = 1_000_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    dropout: float = 0.0
    dtype: torch.dtype = torch.float32


def init_params(cfg: SASRecConfig, generator: torch.Generator):
    """The reference's parameter shapes and scales, drawn from
    ``generator`` on its device: "item_embed" (n_items, d) and "pos_embed"
    (seq_len, d) ~ N(0, 0.02^2); per block six (d, d) weights ~ N(0, 1/d)
    and the zero scales "ln1", "ln2"."""
    dev, d = generator.device, cfg.embed_dim

    def normal(shape, scale):
        return randn(shape, generator, cfg.dtype) * scale

    s = 1.0 / math.sqrt(d)
    return {"item_embed": normal((cfg.n_items, d), 0.02),
            "pos_embed": normal((cfg.seq_len, d), 0.02),
            "blocks": [{**{k: normal((d, d), s) for k in BLOCK_WEIGHTS},
                        "ln1": torch.zeros((d,), dtype=cfg.dtype, device=dev),
                        "ln2": torch.zeros((d,), dtype=cfg.dtype, device=dev)}
                       for _ in range(cfg.n_blocks)]}


def _ln(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * (1.0 + scale)


class SASRec(nn.Module):
    """SASRec on one device.

    ``params`` is laid out as :func:`init_params` returns it (or as
    ``repro_torch.convert.rec_params_from_reference`` carries it over from
    the JAX package); without it the parameters are drawn from a
    ``torch.Generator`` seeded with ``seed`` on the device.  The module
    takes the given tensors as its parameters without a copy (on their
    device), so training updates them in place.  It runs on CUDA unless
    ``device`` asks for the CPU, and raises where CUDA is missing.
    """

    def __init__(self, cfg: SASRecConfig, params=None, *, device=None,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device, "SASRec")
        if params is None:
            params = init_params(cfg, seeded_generator(dev, seed))
        if len(params["blocks"]) != cfg.n_blocks:
            raise ValueError(f"{len(params['blocks'])} blocks of parameters "
                             f"for a {cfg.n_blocks}-block config")
        self.item_embed = nn.Parameter(params["item_embed"])
        self.pos_embed = nn.Parameter(params["pos_embed"])
        self.blocks = nn.ModuleList(
            nn.ParameterDict({k: nn.Parameter(t) for k, t in blk.items()})
            for blk in params["blocks"])
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.item_embed.device

    def _ids(self, ids, sctx=None) -> torch.Tensor:
        if is_dtensor(ids):
            return ids.to(torch.int32)
        ids = torch.as_tensor(ids, device=self.device).to(torch.int32)
        return ids if sctx is None else sctx.batch(ids)

    def encode(self, item_seq, sctx=None) -> torch.Tensor:
        """item_seq: (B, S) int ids, 0 = padding -> position-wise user
        states (B, S, d), zero at padding positions."""
        item_seq = self._ids(item_seq, sctx)
        x = dedup_gather(self.item_embed, item_seq, sctx).to(self.cfg.dtype)
        weights = [self.pos_embed] + [blk[k] for blk in self.blocks
                                      for k in BLOCK_WEIGHTS + ("ln1", "ln2")]
        if sctx is None:
            return self._blocks(x, item_seq, *weights)
        pl = tuple(x.placements)
        rep = [sctx.replicated_pl] * len(weights)
        return sctx.local(self._blocks, [pl], [pl, item_seq.placements, *rep],
                          [pl, item_seq.placements,
                           *[sctx.grad_placements(pl)] * len(weights)])(
                              x, item_seq, *weights)

    def _blocks(self, x, item_seq, pos_embed, *block_weights):
        """The position embedding and the blocks on (B, S, d) rows
        (``encode``'s; under a context one rank's rows)."""
        cfg = self.cfg
        B, S = item_seq.shape
        d, H = cfg.embed_dim, cfg.n_heads
        x = x * math.sqrt(d) + pos_embed[None, :S].to(cfg.dtype)
        pos = torch.arange(S, device=x.device)
        pad = item_seq > 0
        mask = make_attention_mask(pos, pos, causal=True)[None] \
            & pad[:, None, :]
        per = len(BLOCK_WEIGHTS) + 2
        for i in range(cfg.n_blocks):
            blk = dict(zip(BLOCK_WEIGHTS + ("ln1", "ln2"),
                           block_weights[i * per:(i + 1) * per]))
            h = _ln(x, blk["ln1"])
            q = (h @ blk["wq"]).reshape(B, S, H, d // H)
            k = (h @ blk["wk"]).reshape(B, S, H, d // H)
            v = (h @ blk["wv"]).reshape(B, S, H, d // H)
            o = attention_xla(q, k, v, mask[:, None, None, :, :])
            x = x + o.reshape(B, S, d) @ blk["wo"]
            h2 = _ln(x, blk["ln2"])
            x = x + torch.relu(h2 @ blk["ffn_w1"]) @ blk["ffn_w2"]
        return torch.where(pad[..., None], x, 0.0)

    def score_candidates(self, user_state: torch.Tensor,
                         candidates, sctx=None) -> torch.Tensor:
        """user_state: (B, d); candidates: (B, C) item ids -> scores
        (B, C)."""
        candidates = self._ids(candidates, sctx)
        emb = dedup_gather(self.item_embed, candidates, sctx).to(
            user_state.dtype)
        return torch.einsum("bd,bcd->bc", user_state, emb)

    def retrieval_scores(self, user_state: torch.Tensor,
                         sctx=None) -> torch.Tensor:
        """user_state: (B, d) -> scores against the whole item table
        (B, n_items); under ``sctx`` split over the model axis on the
        item dimension (see the module's docstring)."""
        if sctx is None:
            return user_state @ self.item_embed.to(user_state.dtype).T
        _, _, Replicate, Shard = dtensor_types()
        u_pl, t_pl = tuple(user_state.placements), self.item_embed.placements
        out_pl = tuple(Shard(1) if t.is_shard() else
                       Shard(0) if u.is_shard() else Replicate()
                       for u, t in zip(u_pl, t_pl))
        return sctx.local(lambda u, t: u @ t.to(u.dtype).T, [out_pl],
                          [u_pl, t_pl])(user_state, self.item_embed)

    def loss_fn(self, item_seq, pos_items, neg_items, sctx=None):
        """Sequence-to-next training: the BPR loss at every valid position,
        in f32, as ``log1p(exp(-(pos - neg)))`` (the reference's form, not
        ``softplus``).  All three (B, S).  Returns (loss, {"bpr": loss})."""
        states = self.encode(item_seq, sctx)
        pos_items = self._ids(pos_items, sctx)
        pe = dedup_gather(self.item_embed, pos_items, sctx).to(states.dtype)
        ne = dedup_gather(self.item_embed, self._ids(neg_items, sctx),
                          sctx).to(states.dtype)
        pos_logit = (states * pe).sum(-1)
        neg_logit = (states * ne).sum(-1)
        valid = (pos_items > 0).float()
        lp = torch.log1p(torch.exp(-(pos_logit - neg_logit).float()))
        total, count = (lp * valid).sum(), valid.sum()
        if sctx is not None:
            total, count = sctx.replicate(total), sctx.replicate(count)
        loss = total / torch.clamp(count, min=1.0)
        return loss, {"bpr": loss}
