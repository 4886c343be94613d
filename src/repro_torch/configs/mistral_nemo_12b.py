"""mistral-nemo-12b [dense] — 128k-context dense GQA model.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128,
rope theta 1e6 for 128k ctx. [hf:mistralai/Mistral-Nemo-Base-2407]
"""

from ..models.config import ModelConfig

ID = "mistral-nemo-12b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID,
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=131072,
        block_pattern=("attn",),
        mlp="swiglu",
        rope_theta=1000000.0,
        tie_embeddings=False,
        family="dense",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        block_pattern=("attn",),
        mlp="swiglu",
        tie_embeddings=False,
        family="dense",
    )
