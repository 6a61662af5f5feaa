"""The PyTorch port's quantization module against the JAX package's.

Same seeded numpy inputs through both: int8 / fp8 payloads and scales,
int4 packed bytes and scales are bit-equal (rounding is half-to-even on
both sides, and the int4 split-half packing is one storage format);
dequantization, ``fp8_to_f32_int`` and ``int8_matmul`` agree to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_dlrs_tpu.ops import decode as jdec
from flash_attention_dlrs_tpu.ops import quantization as jq
from flash_attention_dlrs_tpu_torch.ops import decode as tdec
from flash_attention_dlrs_tpu_torch.ops import quantization as tq

PAYLOADS = {
    "int8": (jnp.int8, torch.int8),
    "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
    "e5m2": (jnp.float8_e5m2, torch.float8_e5m2),
}


def _x(seed, shape, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * scale
    x[..., 0, :] = 0.0  # an all-zero row: scale 1
    return x


def _bytes(a):
    return np.asarray(a).view(np.uint8)


@pytest.mark.parametrize("kind", sorted(PAYLOADS))
@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_bit_equal_to_jax(kind, axis):
    jd, td = PAYLOADS[kind]
    x = _x(len(kind) + axis, (6, 5, 40), scale=3.0)
    want = jq.quantize(jnp.asarray(x), dtype=jd, axis=axis)
    got = tq.quantize(torch.from_numpy(x), dtype=td, axis=axis)
    assert got.values.dtype == td and got.shape == want.shape == x.shape
    np.testing.assert_array_equal(got.values.view(torch.uint8).numpy(),
                                  _bytes(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    np.testing.assert_allclose(got.dequantize().numpy(),
                               np.asarray(want.dequantize()), rtol=1e-6, atol=0)


def test_quantize_rounds_half_to_even_like_jax():
    # x / scale lands exactly on .5 steps: 127 * [0.5, 1.5, 2.5] / 127
    x = np.asarray([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]], np.float32)
    want = jq.quantize(jnp.asarray(x))
    got = tq.quantize(torch.from_numpy(x))
    assert got.values.tolist() == np.asarray(want.values).tolist() == [
        [127, 0, 2, 2, 0, -2]]


@pytest.mark.parametrize("shape", [(3, 16, 8), (2, 4, 64, 32)])
def test_int4_quantize_packs_the_jax_bytes(shape):
    x = _x(shape[-1], shape, scale=2.0)
    want = jq.quantize_int4(jnp.asarray(x))
    got = tq.quantize_int4(torch.from_numpy(x))
    assert got.values.dtype == torch.int8 and got.shape == want.shape == shape
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    np.testing.assert_allclose(got.dequantize().numpy(),
                               np.asarray(want.dequantize()), rtol=1e-6, atol=0)


def test_int4_pack_unpack_round_trip_matches_jax():
    vals = np.random.default_rng(0).integers(-8, 8, (3, 16, 8)).astype(np.int32)
    want = jq.pack_int4_rows(jnp.asarray(vals))
    got = tq.pack_int4_rows(torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tq.unpack_int4_rows(got).numpy(), vals)
    np.testing.assert_array_equal(
        tq.unpack_int4_rows(got).numpy(), np.asarray(jq.unpack_int4_rows(want)))
    with pytest.raises(ValueError, match="even"):
        tq.pack_int4_rows(torch.zeros((3, 5, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="trailing"):
        tq.quantize_int4(torch.zeros((4, 4)), axis=0)


@pytest.mark.parametrize("kind", ["e4m3", "e5m2"])
def test_fp8_to_f32_int_matches_jax_on_every_byte(kind):
    jd, td = PAYLOADS[kind]
    raw = np.arange(256, dtype=np.uint8)
    want = np.asarray(jq.fp8_to_f32_int(jnp.asarray(raw).view(jd)))
    got = tq.fp8_to_f32_int(torch.from_numpy(raw).view(td)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # and it is the native cast wherever that is finite and normal
    native = torch.from_numpy(raw).view(td).float().numpy()
    normal = np.isfinite(native) & (got != 0)
    np.testing.assert_allclose(got[normal], native[normal], rtol=1e-6, atol=0)
    with pytest.raises(NotImplementedError):
        tq.fp8_to_f32_int(torch.zeros(2, dtype=torch.int8))


@pytest.mark.parametrize("kind", sorted(PAYLOADS))
def test_fp8_payloads_through_bit_surgery_and_int8_matmul(kind):
    jd, td = PAYLOADS[kind]
    w = _x(7, (48, 24), scale=0.5)
    x = _x(8, (5, 48))
    wj, wt = jq.quantize_weight(jnp.asarray(w), jd), tq.quantize_weight(
        torch.from_numpy(w), td)
    assert wt.values.shape == (48, 24) and wt.scales.shape == (1, 24)
    np.testing.assert_array_equal(wt.values.view(torch.uint8).numpy(),
                                  _bytes(wj.values))
    np.testing.assert_array_equal(wt.scales.numpy(), np.asarray(wj.scales))
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), wj))
    got = tq.int8_matmul(torch.from_numpy(x), wt).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    if kind != "int8":
        np.testing.assert_allclose(
            tq.fp8_to_f32_int(wt.values).numpy(),
            np.asarray(jq.fp8_to_f32_int(wj.values)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["int8", "int4", "e4m3", "e5m2"])
def test_quantize_kv_pages_matches_jax(kind):
    jd, td = PAYLOADS.get(kind, ("int4", "int4"))
    pages = _x(9, (2, 3, 16, 32))
    want = jdec.quantize_kv_pages(jnp.asarray(pages), jd)
    got = tdec.quantize_kv_pages(torch.from_numpy(pages), td)
    assert type(got).__name__ == type(want).__name__
    np.testing.assert_array_equal(got.values.view(torch.uint8).numpy(),
                                  _bytes(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))


def test_qmax_for_matches_jax():
    for jd, td in PAYLOADS.values():
        assert tq.qmax_for(td) == jq.qmax_for(jd)
    assert tq.INT4_QMAX == jq.INT4_QMAX
