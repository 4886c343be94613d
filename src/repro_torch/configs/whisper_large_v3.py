"""whisper-large-v3 [audio] — encoder-decoder backbone, conv frontend STUB.

32L decoder + 32L encoder, d_model=1280 20H (kv=20) d_ff=5120 vocab=51866,
LayerNorm + GELU + biases, sinusoidal positions (no RoPE).  The mel/conv
frontend is a stub: input_specs() provides precomputed (B, 1500, 1280)
frame embeddings per the assignment. [arXiv:2212.04356]
"""

from ..models.config import ModelConfig

ID = "whisper-large-v3"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID,
        n_layers=32,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        head_dim=64,
        d_ff=5120,
        vocab=51866,
        block_pattern=("attn",),
        mlp="gelu",
        norm="layernorm",
        attn_bias=True,
        enc_dec=True,
        n_enc_layers=32,
        enc_frames=1500,
        frontend="audio_stub",
        tie_embeddings=True,
        family="audio",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=512,
        block_pattern=("attn",),
        mlp="gelu",
        norm="layernorm",
        attn_bias=True,
        enc_dec=True,
        n_enc_layers=2,
        enc_frames=16,
        frontend="audio_stub",
        tie_embeddings=True,
        family="audio",
    )
