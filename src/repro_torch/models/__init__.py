"""The LM stack of the port: every arch of the registry (decoder-only
attention, RG-LRU and xLSTM mixers, MoE, whisper's encoder-decoder) for
serving and training.  Attention runs on the flash-attention CUDA kernel
on the card."""

from .config import ModelConfig, MoEConfig  # noqa: F401
from .model import Model, build_model, cross_entropy  # noqa: F401
