"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, ~1:2 ratio.

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000, lru_width=2560,
window=2048 local attention, GeGLU MLP, gemma norm conventions.  The
repeating unit is a 13-block pattern (x2 groups = 26 layers) placing
attention every third block, 8 attention layers total — matching the
published 1:2 placement. [arXiv:2402.19427]

Bounded window + O(1) recurrent state -> runs the long_500k shape.
"""

from ..models.config import ModelConfig

ID = "recurrentgemma-2b"

_PATTERN = (
    "rglru", "rglru", "attn_local",
    "rglru", "rglru", "attn_local",
    "rglru", "rglru", "attn_local",
    "rglru", "rglru", "attn_local",
    "rglru",
)


def config() -> ModelConfig:
    return ModelConfig(
        name=ID,
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab=256000,
        block_pattern=_PATTERN,
        window=2048,
        lru_width=2560,
        conv_width=4,
        mlp="geglu",
        rms_scale_plus_one=True,
        embed_scale=True,
        tie_embeddings=True,
        family="hybrid",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke",
        n_layers=6,
        d_model=64,
        n_heads=2,
        n_kv_heads=1,
        head_dim=32,
        d_ff=128,
        vocab=512,
        block_pattern=("rglru", "rglru", "attn_local"),
        window=8,
        lru_width=64,
        conv_width=4,
        mlp="geglu",
        rms_scale_plus_one=True,
        embed_scale=True,
        tie_embeddings=True,
        family="hybrid",
    )
