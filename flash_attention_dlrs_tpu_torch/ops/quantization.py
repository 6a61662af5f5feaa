"""Quantization, PyTorch port of ``flash_attention_dlrs_tpu/ops/quantization.py``.

int8 / fp8 (e4m3fn, e5m2) payloads with one fp32 scale per trailing-axis
row (one per token for KV caches, one per output channel for weights), and
int4 packed two per byte.  Scaling is symmetric, so dequantizing is one
multiply.  Payloads, packed bytes and scales are bit-equal to the JAX
package's: rounding is half-to-even in both (``torch.round``), and the int4
split-half packing is the same storage format, byte for byte.
"""

from __future__ import annotations

import dataclasses

import torch

# Supported payload dtypes and their largest representable magnitude.
_QMAX = {
    torch.int8: 127.0,
    torch.float8_e4m3fn: 448.0,
    torch.float8_e5m2: 57344.0,
}


def qmax_for(dtype) -> float:
    return _QMAX[dtype]


@dataclasses.dataclass
class QuantizedTensor:
    """Payload + per-row scales; logically ``values * scales``.

    values: [..., rows, cols] in int8/fp8.
    scales: [..., rows, 1] in fp32 (broadcasts over the trailing axis).
    """

    values: torch.Tensor
    scales: torch.Tensor

    @property
    def shape(self):
        return tuple(self.values.shape)

    @property
    def dtype(self):
        return self.values.dtype

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.values.float() * self.scales).to(dtype)


def _scale(amax, qmax: float):
    return torch.where(amax == 0.0, torch.ones_like(amax), amax / qmax)


def quantize(x: torch.Tensor, dtype=torch.int8, *, axis: int = -1) -> QuantizedTensor:
    """Symmetric per-row quantization along ``axis`` (the contracted axis
    stays full precision via the scale)."""
    x = x.float()
    qmax = qmax_for(dtype)
    scale = _scale(x.abs().amax(dim=axis, keepdim=True), qmax)
    q = x / scale
    if dtype == torch.int8:
        q = torch.round(q)
    q = torch.clamp(q, -qmax, qmax)
    return QuantizedTensor(values=q.to(dtype), scales=scale)


# ---------------------------------------------------------------------------
# INT4 (packed two per byte)
# ---------------------------------------------------------------------------

INT4_QMAX = 7.0  # symmetric int4 range [-8, 7]; ±7 keeps the scale symmetric


def unpack_int4_rows(packed: torch.Tensor) -> torch.Tensor:
    """[..., R/2, C] int8 -> [..., R, C] int32 values in [-8, 7].

    Split-half convention (see :class:`Int4QuantizedTensor`): byte row r
    holds logical row r in its low nibble and logical row r + R/2 in its
    high nibble."""
    xi = packed.to(torch.int32)
    low = (xi << 28) >> 28  # sign-extend the low nibble
    high = xi >> 4  # arithmetic shift sign-extends the high nibble
    return torch.cat([low, high], dim=-2)


def pack_int4_rows(values: torch.Tensor) -> torch.Tensor:
    """[..., R, C] ints in [-8, 7] -> [..., R/2, C] int8 (inverse of
    :func:`unpack_int4_rows`)."""
    r = values.shape[-2]
    if r % 2:
        raise ValueError(f"row axis must be even to pack int4, got {r}")
    vi = values.to(torch.int32)
    low = vi[..., : r // 2, :] & 0xF
    high = (vi[..., r // 2:, :] & 0xF) << 4
    # bytes 0..255 as int8: the two's-complement wrap the JAX cast makes
    return (low | high).to(torch.uint8).view(torch.int8)


@dataclasses.dataclass
class Int4QuantizedTensor:
    """INT4 payload packed two per byte + per-row fp32 scales.

    Logically ``unpack(values) * scales`` for a [..., rows, cols] tensor;
    ``values`` is [..., rows/2, cols] int8 in the split-half packing of
    :func:`pack_int4_rows`, ``scales`` [..., rows, 1] fp32, one per LOGICAL
    row."""

    values: torch.Tensor  # [..., rows/2, cols] int8, packed
    scales: torch.Tensor  # [..., rows, 1] fp32

    @property
    def shape(self):  # the LOGICAL shape
        s = list(self.values.shape)
        s[-2] *= 2
        return tuple(s)

    @property
    def dtype(self):
        return self.values.dtype

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        vals = unpack_int4_rows(self.values).float()
        return (vals * self.scales).to(dtype)


def quantize_int4_values(x: torch.Tensor):
    """Per-row symmetric int4 along the trailing axis, unpacked: (int32
    values in [-8, 7], fp32 scales [..., 1])."""
    x = x.float()
    scale = _scale(x.abs().amax(dim=-1, keepdim=True), INT4_QMAX)
    q = torch.clamp(torch.round(x / scale), -8, INT4_QMAX)
    return q.to(torch.int32), scale


def quantize_int4(x: torch.Tensor, *, axis: int = -1) -> Int4QuantizedTensor:
    """Symmetric per-row int4 quantization along ``axis`` (must be the
    trailing axis), packed two per byte along the row axis (-2)."""
    if axis not in (-1, x.ndim - 1):
        raise ValueError("quantize_int4 scales along the trailing axis only")
    if x.shape[-2] % 2:
        raise ValueError(f"row axis must be even to pack int4, got {x.shape[-2]}")
    q, scale = quantize_int4_values(x)
    return Int4QuantizedTensor(values=pack_int4_rows(q), scales=scale)


# ---------------------------------------------------------------------------
# Weight-only INT8 projections
# ---------------------------------------------------------------------------


def quantize_weight(w: torch.Tensor, dtype=torch.int8) -> QuantizedTensor:
    """Per-output-channel symmetric quantization of a [in, out] weight."""
    wq = quantize(w.T, dtype=dtype, axis=-1)  # [out, in]: rows = out channels
    return QuantizedTensor(values=wq.values.T, scales=wq.scales.T)  # [1, out]


def int8_matmul(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """x [.., in] @ quantized weight [in, out], per-channel scales folded
    into the fp32 product.  The payload is cast to x's dtype (exact for
    int8 and fp8 in bf16, fp16 and fp32) and the product accumulates in
    fp32, as the JAX package's ``preferred_element_type=float32`` dot."""
    acc = torch.matmul(x.float(), w.values.to(x.dtype).float())
    return (acc * w.scales).to(x.dtype)


def fp8_to_f32_int(x: torch.Tensor) -> torch.Tensor:
    """fp8 -> fp32 by integer bit surgery: widen the byte, move sign,
    exponent and mantissa to their fp32 places and rebias the exponent.
    Denormals flush to zero.  The JAX package uses it on TPUs without an
    fp8 datapath; the port's kernels convert natively and keep this only
    to match the JAX function."""
    if x.dtype == torch.float8_e4m3fn:
        man_bits, bias = 3, 7
    elif x.dtype == torch.float8_e5m2:
        man_bits, bias = 2, 15
    else:
        raise NotImplementedError(f"not an fp8 dtype: {x.dtype}")
    u = x.view(torch.uint8).to(torch.int32)
    sign = (u & 0x80) << 24
    expman = u & 0x7F
    bits = sign | ((expman << (23 - man_bits)) + ((127 - bias) << 23))
    bits = torch.where(expman < (1 << man_bits), sign, bits)
    return bits.view(torch.float32)
