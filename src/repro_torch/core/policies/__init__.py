"""Offloading policies of the port's engine (see :mod:`.base`).

Ported: ``ccp`` (Algorithm 1) and ``best`` (oracle TTI).  The reference's
other policies are listed in ``base.NOT_PORTED`` with their ROADMAP slice.
"""

from .base import RING, Policy, StepCtx, get, names, register  # noqa: F401

# Importing the modules registers the built-ins.
from . import best, ccp  # noqa: F401, E402
from .best import BestPolicy  # noqa: F401
from .ccp import CCPPolicy  # noqa: F401

__all__ = ["RING", "Policy", "StepCtx", "get", "names", "register",
           "CCPPolicy", "BestPolicy"]
