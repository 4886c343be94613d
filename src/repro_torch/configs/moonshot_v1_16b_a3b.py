"""moonshot-v1-16b-a3b [moe] — Kimi/Moonlight-16B-A3B.

48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64 experts
top-6 (+2 shared, Moonlight-style). [hf:moonshotai/Moonlight-16B-A3B]
"""

from ..models.config import ModelConfig, MoEConfig

ID = "moonshot-v1-16b-a3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID,
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab=163840,
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
        block_pattern=("attn",),
        mlp="swiglu",
        rope_theta=50000.0,
        tie_embeddings=False,
        family="moe",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=48,
        vocab=512,
        # capacity_factor 8: no token dropping at smoke-test batch sizes, so
        # prefill+decode exactly matches the full forward pass.
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=48, n_shared=1,
                      capacity_factor=8.0),
        block_pattern=("attn",),
        mlp="swiglu",
        tie_embeddings=False,
        family="moe",
    )
