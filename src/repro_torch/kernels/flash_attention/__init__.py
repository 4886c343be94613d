from .kernel import flash_attention_cuda  # noqa: F401
from .ops import attention_flops, flash_attention  # noqa: F401
from .ref import attention_chunked, attention_ref  # noqa: F401
