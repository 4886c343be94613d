"""qwen3-moe-235b-a22b [moe] — Qwen3-235B-A22B family.

94L d_model=4096 64H (GQA kv=4) d_ff_expert=1536 vocab=151936, MoE 128
experts top-8, head_dim=128 (per HF config). [hf:Qwen/Qwen3-30B-A3B]
Simplification noted in DESIGN.md: Qwen3's qk-norm is omitted.
"""

from ..models.config import ModelConfig, MoEConfig

ID = "qwen3-moe-235b-a22b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID,
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,
        d_ff=1536,
        vocab=151936,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
        block_pattern=("attn",),
        mlp="swiglu",
        rope_theta=1000000.0,
        tie_embeddings=False,
        family="moe",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        head_dim=8,
        d_ff=32,
        vocab=512,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                      capacity_factor=8.0),
        block_pattern=("attn",),
        mlp="swiglu",
        tie_embeddings=False,
        family="moe",
    )
