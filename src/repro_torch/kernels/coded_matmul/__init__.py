from .kernel import coded_matmul_cuda  # noqa: F401
from .ops import coded_matmul, coded_matmul_code  # noqa: F401
from .ref import coded_matmul_ref, lt_encode_ref  # noqa: F401
