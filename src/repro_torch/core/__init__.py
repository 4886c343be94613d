"""The paper's primary contribution: Computation Control Protocol (CCP) —
fountain-coded cooperative computation with dynamic, heterogeneity-aware
task allocation — ported to PyTorch.

Simulation entry point: :class:`repro_torch.core.engine.Engine` (``run``,
and ``run_fleet`` for tenants sharing one pool); coded
matmul: :mod:`repro_torch.core.coded_matmul` (imported on its own, as it
pulls in the kernels); coded data-parallel gradients:
:mod:`repro_torch.core.gradient_coding`."""

from . import ccp, decode, engine, fleet, fountain, gradient_coding, policies, simulator, theory, transport  # noqa: F401,E501
