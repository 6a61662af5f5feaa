"""flash_attention_dlrs_tpu_torch — the PyTorch / CUDA port of flash_attention_dlrs_tpu.

A second package beside the JAX one, which stays the reference.  It serves
the paged GQA decoder and trains it end to end on an NVIDIA H100: the
attention forward, its deterministic backward and the paged decode attention
are hand-written CUDA kernels for sm_90a (``csrc/``), built with nvcc on
first use and bound with ctypes; everything around them is PyTorch.  The op
API takes packed sequences (:class:`SegmentIds`) and fp8 V, and :mod:`.nn`
is the ``jax.nn.dot_product_attention`` adapter.  :class:`BlockSizes`
pins the kernels' tiles and :mod:`.tuning` times them (``tune=True``),
against :mod:`.geometry`'s model of the card.  :mod:`.parallel` scales
out over ``torch.distributed``: process meshes, ring and zigzag context
parallelism, sharded attention and paged decode, dp × tp training and
tensor-parallel serving.  Every kernel has a plain PyTorch version that CPU
tensors take.  Entry points run on the card unless the caller asks for the
CPU.
"""

from . import nn, parallel
from .geometry import HopperGeometry, current_geometry
from .ops import (
    SegmentIds,
    alibi_slopes_for,
    flash_attention,
    flash_attention_backward,
    flash_attention_forward,
    reference_attention,
    reference_attention_grads,
)
from .tuning import BlockSizes, default_block_sizes

__version__ = "0.1.0"

__all__ = [
    "BlockSizes",
    "HopperGeometry",
    "SegmentIds",
    "alibi_slopes_for",
    "current_geometry",
    "default_block_sizes",
    "flash_attention",
    "flash_attention_backward",
    "flash_attention_forward",
    "nn",
    "parallel",
    "reference_attention",
    "reference_attention_grads",
    "__version__",
]
