"""The parameters the benchmark hands to the program and to the reference:
drawn on the device from the seed, in the type they are trained or served
in, a few large draws and no host copy.

Leaves are named as ``nn.Module.named_parameters`` names the program's
LM (``embed``, ``layers.{i}.attn.wq``, ``layers.{i}.moe.w_gate``,
``final_norm``, ...).  They fall into groups, the embedding, each layer and
the head, and each group is one draw of a generator seeded from (seed,
group): a group can be drawn again alone, bit for bit, where a reading
needs the starting values back (``group_leaves``).  Products are normal
with std 1/sqrt(fan in), the embedding and head 0.02; the RMSNorm scales
start at 0 (a factor of 1).
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], float]


def derive(seed: int, *keys) -> int:
    """A 63-bit generator seed from the run's seed and the keys."""
    text = ":".join(str(k) for k in (seed,) + keys)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def generator(device, seed: int, *keys) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *keys))


def groups(config: dict) -> List[List[Leaf]]:
    """The drawn leaves, by group: (name, shape, std)."""
    d, V = config["hidden_size"], config["vocab_size"]
    H, Hkv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config.get("head_dim") or d // H
    f = config["intermediate_size"]
    E = config.get("num_local_experts") or 0
    out = [[("embed", (V, d), 0.02)]]
    for i in range(config["num_hidden_layers"]):
        p = f"layers.{i}."
        layer = [(p + "attn.wq", (d, H * hd), d ** -0.5),
                 (p + "attn.wk", (d, Hkv * hd), d ** -0.5),
                 (p + "attn.wv", (d, Hkv * hd), d ** -0.5),
                 (p + "attn.wo", (H * hd, d), (H * hd) ** -0.5)]
        if E:
            layer += [(p + "moe.router", (d, E), d ** -0.5),
                      (p + "moe.w_gate", (E, d, f), d ** -0.5),
                      (p + "moe.w_up", (E, d, f), d ** -0.5),
                      (p + "moe.w_down", (E, f, d), f ** -0.5)]
        else:
            layer += [(p + "mlp.w_gate", (d, f), d ** -0.5),
                      (p + "mlp.w_up", (d, f), d ** -0.5),
                      (p + "mlp.w_down", (f, d), f ** -0.5)]
        out.append(layer)
    if not config.get("tie_word_embeddings"):
        out.append([("lm_head", (d, V), 0.02)])
    return out


def zero_leaves(config: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """The leaves that start at 0: RMSNorm scales (and biases)."""
    d = config["hidden_size"]
    H, Hkv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config.get("head_dim") or d // H
    out = []
    for i in range(config["num_hidden_layers"]):
        p = f"layers.{i}."
        if config.get("attention_bias"):
            out += [(p + "attn.bq", (H * hd,)), (p + "attn.bk", (Hkv * hd,)),
                    (p + "attn.bv", (Hkv * hd,))]
        if config.get("qk_norm"):
            out += [(p + "attn.q_norm", (hd,)), (p + "attn.k_norm", (hd,))]
        out += [(p + "ln1", (d,)), (p + "ln2", (d,))]
    return out + [("final_norm", (d,))]


def group_leaves(config: dict, seed: int, g: int, dtype, device
                 ) -> Dict[str, torch.Tensor]:
    """Group ``g``'s leaves: one draw, cut into views and scaled."""
    leaves = groups(config)[g]
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    flat = torch.randn(sum(sizes), dtype=dtype, device=device,
                       generator=generator(device, seed, "weights", g))
    out = {}
    for (name, shape, std), part in zip(leaves, flat.split(sizes)):
        out[name] = part.view(shape).mul_(std)
    return out


def make(config: dict, seed: int, dtype, device) -> Dict[str, torch.Tensor]:
    """Every leaf of the model, flat by name."""
    out = {}
    for g in range(len(groups(config))):
        out.update(group_leaves(config, seed, g, dtype, device))
    for name, shape in zero_leaves(config):
        out[name] = torch.zeros(shape, dtype=dtype, device=device)
    return out


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """The flat leaves in the program's ``init_params`` layout: {"embed",
    "layers": [{"attn": {...}, "mlp" or "moe": {...}, "ln1", "ln2"}],
    "final_norm", "lm_head"}."""
    out = {"layers": []}
    for name, t in flat.items():
        parts = name.split(".")
        if parts[0] != "layers":
            out[parts[0]] = t
            continue
        i = int(parts[1])
        while len(out["layers"]) <= i:
            out["layers"].append({})
        node = out["layers"][i]
        for key in parts[2:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = t
    return out


@torch.no_grad()
def change_norms(config: dict, seed: int, params: Dict[str, torch.Tensor],
                 device) -> Dict[str, float]:
    """Each leaf's distance from its starting value, ‖p - p0‖, the
    starting values drawn again group by group (f32)."""
    norms = {}
    for g in range(len(groups(config))):
        start = group_leaves(config, seed, g, torch.float32, device)
        for name, p0 in start.items():
            norms[name] = torch.linalg.vector_norm(params[name].float() - p0)
        del start
    for name, _ in zero_leaves(config):
        norms[name] = torch.linalg.vector_norm(params[name].float())
    vals = torch.stack([norms[n] for n in norms]).tolist()
    return dict(zip(norms, vals))
