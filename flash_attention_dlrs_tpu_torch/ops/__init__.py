from .decode import (
    paged_decode_attention,
    paged_reference_attention,
    paged_verify_attention,
)
from .flash_attention import (
    flash_attention,
    flash_attention_backward,
    flash_attention_forward,
)
from .reference import (
    alibi_slopes_for,
    reference_attention,
    reference_attention_grads,
)

__all__ = [
    "alibi_slopes_for",
    "flash_attention",
    "flash_attention_backward",
    "flash_attention_forward",
    "paged_decode_attention",
    "paged_reference_attention",
    "paged_verify_attention",
    "reference_attention",
    "reference_attention_grads",
]
