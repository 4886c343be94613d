"""The paper's primary contribution: Computation Control Protocol (CCP) —
fountain-coded cooperative computation with dynamic, heterogeneity-aware
task allocation — ported to PyTorch.

Simulation entry point: :class:`repro_torch.core.engine.Engine`; coded
matmul: :mod:`repro_torch.core.coded_matmul` (imported on its own, as it
pulls in the kernels)."""

from . import ccp, engine, fountain, policies, simulator, theory  # noqa: F401
