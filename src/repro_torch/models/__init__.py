"""The LM stack of the port (slice C1: decoder-only attention models for
serving).  Attention runs on the flash-attention CUDA kernel on the card."""

from .config import ModelConfig, MoEConfig  # noqa: F401
from .model import Model, build_model, cross_entropy  # noqa: F401
