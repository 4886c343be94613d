"""Offloading policies of the port's engine (see :mod:`.base`).

Ported: ``ccp`` (Algorithm 1), ``best`` (oracle TTI), ``naive`` and
``naive_oracle`` (stop-and-wait, eq. 16), ``rateless_ccp`` (Algorithm 1
with the decoder in the loop), the block baselines ``uncoded_mean``,
``uncoded_mu`` and ``hcmm``, and the churn policies ``adaptive_rate``
(measured-loss code-rate adaptation) and ``adaptive_rate_fb`` (the same,
stopping on decode success), and ``tfrc_ccp`` (RFC 5348 equation-based
pacing for the transport layer's delayed, lossy feedback).  Every policy
the reference registers is ported.
"""

from .base import RING, Policy, StepCtx, get, names, register  # noqa: F401

# Importing the modules registers the built-ins.
from . import adaptive_rate, best, ccp, hcmm, naive, rateless, tfrc, uncoded  # noqa: F401, E402
from .adaptive_rate import AdaptiveRatePolicy  # noqa: F401
from .best import BestPolicy  # noqa: F401
from .ccp import CCPPolicy  # noqa: F401
from .hcmm import HCMMPolicy  # noqa: F401
from .naive import NaivePolicy  # noqa: F401
from .rateless import RatelessCCPPolicy  # noqa: F401
from .tfrc import TFRCCCPPolicy  # noqa: F401
from .uncoded import UncodedPolicy  # noqa: F401

__all__ = ["RING", "Policy", "StepCtx", "get", "names", "register",
           "AdaptiveRatePolicy", "CCPPolicy", "BestPolicy", "HCMMPolicy", "NaivePolicy",
           "RatelessCCPPolicy", "TFRCCCPPolicy", "UncodedPolicy"]
