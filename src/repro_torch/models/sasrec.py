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
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..core.dht import dedup_gather
from ..devices import seeded_generator, randn, resolve_device
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

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(ids, device=self.device).to(torch.int32)

    def encode(self, item_seq) -> torch.Tensor:
        """item_seq: (B, S) int ids, 0 = padding -> position-wise user
        states (B, S, d), zero at padding positions."""
        cfg = self.cfg
        item_seq = self._ids(item_seq)
        B, S = item_seq.shape
        d, H = cfg.embed_dim, cfg.n_heads
        x = dedup_gather(self.item_embed, item_seq).to(cfg.dtype)
        x = x * math.sqrt(d) + self.pos_embed[None, :S].to(cfg.dtype)
        pos = torch.arange(S, device=self.device)
        pad = item_seq > 0
        mask = make_attention_mask(pos, pos, causal=True)[None] \
            & pad[:, None, :]
        for blk in self.blocks:
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
                         candidates) -> torch.Tensor:
        """user_state: (B, d); candidates: (B, C) item ids -> scores
        (B, C)."""
        candidates = self._ids(candidates)
        emb = dedup_gather(self.item_embed, candidates).to(user_state.dtype)
        return torch.einsum("bd,bcd->bc", user_state, emb)

    def retrieval_scores(self, user_state: torch.Tensor) -> torch.Tensor:
        """user_state: (B, d) -> scores against the whole item table
        (B, n_items)."""
        return user_state @ self.item_embed.to(user_state.dtype).T

    def loss_fn(self, item_seq, pos_items, neg_items):
        """Sequence-to-next training: the BPR loss at every valid position,
        in f32, as ``log1p(exp(-(pos - neg)))`` (the reference's form, not
        ``softplus``).  All three (B, S).  Returns (loss, {"bpr": loss})."""
        states = self.encode(item_seq)
        pos_items = self._ids(pos_items)
        pe = dedup_gather(self.item_embed, pos_items).to(states.dtype)
        ne = dedup_gather(self.item_embed, neg_items).to(states.dtype)
        pos_logit = (states * pe).sum(-1)
        neg_logit = (states * ne).sum(-1)
        valid = (pos_items > 0).float()
        lp = torch.log1p(torch.exp(-(pos_logit - neg_logit).float()))
        loss = (lp * valid).sum() / torch.clamp(valid.sum(), min=1.0)
        return loss, {"bpr": loss}
