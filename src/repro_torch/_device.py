"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when a CUDA device is asked for and none is present,
    so nothing quietly runs on the CPU."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the port on the CPU"
        )
    return dev


def full_fp32_matmuls(device: torch.device) -> None:
    """On a CUDA device, make fp32 matrix products run in full fp32 (no
    TF32), as the reference's fp32 configs compute; the LM forward refuses
    to run an fp32 model on the card otherwise."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
