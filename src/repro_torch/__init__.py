"""PyTorch/CUDA port of the C3P reproduction (see ``src/repro`` for the JAX
reference it is checked against).

The port runs on an NVIDIA card by default: every entry point takes a
``device`` and resolves it through :func:`repro_torch._device.resolve`, which
raises when CUDA is asked for and absent.  ``device="cpu"`` runs the same
code with each kernel's plain PyTorch version.

Slice 1 covers one C3P task end to end: the CCP control plane
(:mod:`repro_torch.core.engine`) and the fountain-coded data plane
(:mod:`repro_torch.core.coded_matmul`) with its fused coded-matmul CUDA
kernel (:mod:`repro_torch.kernels.coded_matmul`).
"""
