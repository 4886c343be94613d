"""granite-20b [dense] — IBM Granite 20B code model, MQA.

52L d_model=6144 48H (GQA kv=1 = MQA) d_ff=24576 (4d, GELU) vocab=49152.
[arXiv:2405.04324]  Spec says llama-arch; we keep RoPE + the published
4d GELU MLP (documented in DESIGN.md).
"""

from ..models.config import ModelConfig

ID = "granite-20b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID,
        n_layers=52,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        head_dim=128,
        d_ff=24576,
        vocab=49152,
        block_pattern=("attn",),
        mlp="gelu",
        tie_embeddings=False,
        family="dense",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=256,
        vocab=512,
        block_pattern=("attn",),
        mlp="gelu",
        tie_embeddings=False,
        family="dense",
    )
