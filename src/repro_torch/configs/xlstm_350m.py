"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (attention-free).

24L d_model=1024 4H d_ff=0 vocab=50304, alternating mLSTM/sLSTM blocks.
Recurrent state is O(1) in sequence length -> runs the long_500k shape.
[arXiv:2405.04517]
"""

from ..models.config import ModelConfig

ID = "xlstm-350m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID,
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        head_dim=256,
        d_ff=0,
        vocab=50304,
        block_pattern=("mlstm", "slstm"),
        mlstm_proj_factor=2.0,
        tie_embeddings=False,
        family="ssm",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=0,
        vocab=512,
        block_pattern=("mlstm", "slstm"),
        mlstm_proj_factor=2.0,
        tie_embeddings=False,
        family="ssm",
    )
