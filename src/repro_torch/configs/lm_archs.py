"""The five assigned LM architectures (exact configs from the brief)."""
from __future__ import annotations

from ..models.transformer import TransformerConfig

# [hf:google/gemma-3-1b-pt-family; 5:1 local:global, 128k context]
GEMMA3_12B = TransformerConfig(
    name="gemma3-12b", vocab=262144, n_layers=48, d_model=3840,
    n_heads=16, n_kv_heads=8, head_dim=256, d_ff=15360,
    max_seq_len=131072, sliding_window=1024, local_global_ratio=5,
    qk_norm=True, rope_theta=1_000_000.0, tie_embeddings=True)

# [hf:Qwen/Qwen2.5 family; GQA + QKV bias]
QWEN2_5_32B = TransformerConfig(
    name="qwen2.5-32b", vocab=152064, n_layers=64, d_model=5120,
    n_heads=40, n_kv_heads=8, head_dim=128, d_ff=27648,
    max_seq_len=131072, qkv_bias=True, rope_theta=1_000_000.0)

# [hf:Qwen/Qwen3 family; qk_norm + GQA]
QWEN3_4B = TransformerConfig(
    name="qwen3-4b", vocab=151936, n_layers=36, d_model=2560,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=9728,
    max_seq_len=131072, qk_norm=True, rope_theta=1_000_000.0)

# [hf:meta-llama/Llama-4-Scout-17B-16E; MoE 16e top-1 + shared expert]
LLAMA4_SCOUT = TransformerConfig(
    name="llama4-scout-17b-a16e", vocab=202048, n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192,
    max_seq_len=131072, moe_experts=16, moe_top_k=1, moe_d_ff=8192,
    moe_shared_expert=True, rope_theta=500_000.0)

# [arXiv:2401.04088; 8 experts top-2, SWA]
MIXTRAL_8X22B = TransformerConfig(
    name="mixtral-8x22b", vocab=32768, n_layers=56, d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=16384,
    max_seq_len=65536, sliding_window=4096, moe_experts=8, moe_top_k=2,
    moe_d_ff=16384, rope_theta=1_000_000.0)


def smoke(cfg: TransformerConfig) -> TransformerConfig:
    """Reduced same-family config for CPU smoke tests."""
    import dataclasses
    return dataclasses.replace(
        cfg,
        vocab=512, n_layers=4 if cfg.local_global_ratio == 0 else 6,
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, max_seq_len=256,
        sliding_window=16 if cfg.sliding_window else 0,
        moe_experts=4 if cfg.moe_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_experts else 0,
        moe_d_ff=64 if cfg.moe_experts else 0,
        local_global_ratio=2 if cfg.local_global_ratio else 0)
