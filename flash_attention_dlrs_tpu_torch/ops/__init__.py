from .decode import (
    paged_decode_attention,
    paged_decode_plain,
    paged_reference_attention,
    paged_verify_attention,
    paged_verify_plain,
    quantize_kv_pages,
    tuned_pages_per_block,
)
from .flash_attention import (
    SegmentIds,
    flash_attention,
    flash_attention_backward,
    flash_attention_forward,
    tuned_block_sizes,
)
from .reference import (
    alibi_slopes_for,
    reference_attention,
    reference_attention_grads,
)

__all__ = [
    "SegmentIds",
    "alibi_slopes_for",
    "flash_attention",
    "flash_attention_backward",
    "flash_attention_forward",
    "paged_decode_attention",
    "paged_decode_plain",
    "paged_reference_attention",
    "paged_verify_attention",
    "paged_verify_plain",
    "quantize_kv_pages",
    "reference_attention",
    "reference_attention_grads",
    "tuned_block_sizes",
    "tuned_pages_per_block",
]
