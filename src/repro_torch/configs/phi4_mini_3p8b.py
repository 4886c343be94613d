"""phi4-mini-3.8b [dense] — RoPE + SwiGLU + GQA.

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064. [arXiv:2412.08905]
Note: 24 heads do not divide the 16-way model axis; the sharding rules fall
back to embed-dim (row-parallel) sharding for attention (DESIGN.md §5).
"""

from ..models.config import ModelConfig

ID = "phi4-mini-3.8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID,
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab=200064,
        block_pattern=("attn",),
        mlp="swiglu",
        tie_embeddings=True,
        family="dense",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke",
        n_layers=2,
        d_model=48,
        n_heads=6,
        n_kv_heads=2,
        head_dim=8,
        d_ff=128,
        vocab=512,
        block_pattern=("attn",),
        mlp="swiglu",
        tie_embeddings=True,
        family="dense",
    )
