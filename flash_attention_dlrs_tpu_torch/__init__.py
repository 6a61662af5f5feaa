"""flash_attention_dlrs_tpu_torch — the PyTorch / CUDA port of flash_attention_dlrs_tpu.

A second package beside the JAX one, which stays the reference.  It serves
the paged GQA decoder and trains it end to end on an NVIDIA H100: the
attention forward, its deterministic backward and the paged decode attention
are hand-written CUDA kernels for sm_90a (``csrc/``), built with nvcc on
first use and bound with ctypes; everything around them is PyTorch.  Every
kernel has a plain PyTorch version that CPU tensors take.  Entry points run
on the card unless the caller asks for the CPU.  See ROADMAP.md for what is
not ported yet.
"""

from .ops import (
    alibi_slopes_for,
    flash_attention,
    flash_attention_backward,
    flash_attention_forward,
    reference_attention,
    reference_attention_grads,
)

__version__ = "0.1.0"

__all__ = [
    "alibi_slopes_for",
    "flash_attention",
    "flash_attention_backward",
    "flash_attention_forward",
    "reference_attention",
    "reference_attention_grads",
    "__version__",
]
