"""gemma2-27b [dense] — local+global alternating attention, logit softcaps.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000, head_dim=128,
window=4096 on local layers, attn softcap 50, final softcap 30, post-block
RMSNorms, (1+w) RMSNorm scales, sqrt(d) embedding scale. [arXiv:2408.00118]
"""

from ..models.config import ModelConfig

ID = "gemma2-27b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID,
        n_layers=46,
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=36864,
        vocab=256000,
        block_pattern=("attn_local", "attn_global"),
        window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        mlp="geglu",
        post_block_norm=True,
        rms_scale_plus_one=True,
        embed_scale=True,
        tie_embeddings=True,
        family="dense",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        block_pattern=("attn_local", "attn_global"),
        window=8,
        attn_softcap=50.0,
        final_softcap=30.0,
        mlp="geglu",
        post_block_norm=True,
        rms_scale_plus_one=True,
        embed_scale=True,
        tie_embeddings=True,
        family="dense",
    )
