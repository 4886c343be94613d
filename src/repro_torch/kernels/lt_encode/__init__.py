from .kernel import lt_encode_cuda  # noqa: F401
from .ops import lt_encode, lt_encode_code  # noqa: F401
