from .autograd import FlashAttentionFn  # noqa: F401
from .kernel import flash_attention_bwd_cuda, flash_attention_cuda  # noqa: F401
from .ops import attention_flops, flash_attention  # noqa: F401
from .ref import (attention_bwd_ref, attention_chunked, attention_lse_ref,  # noqa: F401
                  attention_ref)
