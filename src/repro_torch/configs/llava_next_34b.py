"""llava-next-34b [vlm] — Yi-34B-class decoder backbone, vision STUB.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.  The anyres vision
tower + projector are stubbed: input_specs() provides precomputed
(B, n_patches=2880, 7168) patch embeddings prepended to the token stream.
[hf:llava-hf/llava-v1.6-*; backbone per Yi-34B]
Note: 56 heads do not divide the 16-way model axis; sharding falls back to
embed-dim (row-parallel) for attention (DESIGN.md §5).
"""

from ..models.config import ModelConfig

ID = "llava-next-34b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID,
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab=64000,
        block_pattern=("attn",),
        mlp="swiglu",
        rope_theta=5000000.0,
        frontend="vision_stub",
        n_patches=2880,
        tie_embeddings=False,
        family="vlm",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        head_dim=8,
        d_ff=128,
        vocab=512,
        block_pattern=("attn",),
        mlp="swiglu",
        frontend="vision_stub",
        n_patches=8,
        tie_embeddings=False,
        family="vlm",
    )
