"""The system under test as the benchmark builds it: the configuration
file and the traffic mix turned into the program's ``TransformerConfig``.
Everything the program derives from the parameters and inputs it is
handed is its own; the benchmark only names sizes and switches here."""
from __future__ import annotations

import torch

# what the program's LM fixes in code, which a configuration file has to
# state as it is run
FIXED = {"rms_norm_eps": 1e-06, "hidden_act": "silu"}
FIXED_MOE = {"router_aux_loss_coef": 0.01, "capacity_factor": 1.25}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def transformer_config(config: dict, mix: dict):
    """The program's ``TransformerConfig`` for ``config`` (published keys,
    as run) under traffic ``mix`` (compute type, recomputation, attention
    path, microbatches).  Raises where the file states a value the
    program cannot run."""
    from repro_torch.models.transformer import TransformerConfig

    moe = bool(config.get("num_local_experts"))
    fixed = {**FIXED, **(FIXED_MOE if moe else {})}
    wrong = {k: (config.get(k), v) for k, v in fixed.items()
             if config.get(k) != v}
    if wrong:
        raise ValueError(f"the program runs these as fixed (file, program): "
                         f"{wrong}")
    d, heads = config["hidden_size"], config["num_attention_heads"]
    return TransformerConfig(
        name=config["model_type"], vocab=config["vocab_size"],
        n_layers=config["num_hidden_layers"], d_model=d, n_heads=heads,
        n_kv_heads=config["num_key_value_heads"],
        head_dim=config.get("head_dim") or d // heads,
        d_ff=config["intermediate_size"],
        max_seq_len=config["max_position_embeddings"],
        sliding_window=config.get("sliding_window") or 0,
        qk_norm=bool(config.get("qk_norm")),
        qkv_bias=bool(config.get("attention_bias")),
        rope_theta=float(config["rope_theta"]),
        moe_experts=config.get("num_local_experts") or 0,
        moe_top_k=config.get("num_experts_per_tok") or 0,
        moe_d_ff=config["intermediate_size"] if moe else 0,
        tie_embeddings=bool(config.get("tie_word_embeddings")),
        dtype=DTYPES[mix.get("compute_dtype", "bfloat16")],
        remat=mix.get("remat", "none"),
        attention_impl=mix.get("attention_impl", "xla"),
        n_microbatches=mix.get("microbatches", 1))
