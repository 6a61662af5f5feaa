// Page-pool formats shared by the paged attention kernels (paged_decode.cu,
// paged_verify.cu), sm_90a.
//
// A pool is [Hkv, P, stored_rows, D] of one kind (the codes of
// ops/decode.py POOL_KINDS): float32, bfloat16 and float16 hold values;
// int8, packed int4 and fp8 (e4m3fn, e5m2) hold payloads whose per-token
// fp32 scales sit in a [Hkv, P, page_size] array beside the pool.  int4
// packs two tokens per byte in the split-half layout of
// ops/quantization.py pack_int4_rows: byte row r of a page holds token r in
// its low nibble and token r + page_size/2 in its high nibble, so an int4
// page stores page_size/2 rows while its scales keep the logical
// page_size.  Token t of a sequence lives in pool page table[t / page_size]
// at logical offset t % page_size.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum PoolKind { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3, kI4 = 4, kE4M3 = 5, kE5M2 = 6 };

__host__ __device__ constexpr bool is_quantized(int kind) { return kind >= kI8; }

// Bytes one stored element takes (int4: one byte holds the same column of
// two tokens).
__host__ __device__ constexpr int stored_bytes(int kind) {
  return kind == kF32 ? 4 : (kind <= kF16 ? 2 : 1);
}

// Where logical token `o` of pool page `page` (kv head `kvh`) is stored:
// the element offset of its stored row and, for int4, whether it is the
// high nibble of that row.
struct TokenAddr {
  size_t row;
  int hi;
};

__device__ __forceinline__ TokenAddr token_addr(int kind, int kvh, int page,
                                                int o, int P, int page_size,
                                                int D) {
  if (kind == kI4) {
    const int half = page_size / 2;
    const int hi = o >= half ? 1 : 0;
    return {((size_t(kvh) * P + page) * half + (o - hi * half)) * D, hi};
  }
  return {((size_t(kvh) * P + page) * page_size + o) * D, 0};
}

__device__ __forceinline__ size_t scale_index(int kvh, int page, int o, int P,
                                              int page_size) {
  return (size_t(kvh) * P + page) * page_size + o;
}

// Sign-extended nibble of a stored int4 byte.
__device__ __forceinline__ int int4_value(uint32_t byte, int hi) {
  return hi ? (int(int8_t(byte)) >> 4) : (int(int8_t(byte << 4)) >> 4);
}

// The four elements of one stored word of a 1-byte kind (element c + j in
// byte j), as fp32: one switch per word, fp8 through the paired hardware
// conversion to half.
__device__ __forceinline__ void word_values(int kind, uint32_t w, int hi,
                                            float (&f)[4]) {
  switch (kind) {
    case kI8:
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] = float(int8_t(w >> (8 * j)));
      break;
    case kI4:
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] = float(int4_value((w >> (8 * j)) & 0xFFu, hi));
      break;
    default: {
      const __nv_fp8_interpretation_t fmt = kind == kE4M3 ? __NV_E4M3 : __NV_E5M2;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
            static_cast<__nv_fp8x2_storage_t>(w >> (16 * j)), fmt);
        const float2 v = __half22float2(__half2(h));
        f[2 * j] = v.x;
        f[2 * j + 1] = v.y;
      }
    }
  }
}

// A 16-byte chunk of a stored row as its 16 / stored_bytes(kind) values in
// fp32 (exact for every kind): value kinds element by element, 1-byte kinds
// a word at a time.
__device__ __forceinline__ void chunk_values(int kind, const uint4& raw, int hi,
                                             float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  switch (kind) {
    case kF32:
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i] = __uint_as_float(w[i]);
      break;
    case kBF16:
#pragma unroll
      for (int i = 0; i < 8; ++i)
        out[i] = __bfloat162float(__ushort_as_bfloat16(uint16_t(w[i / 2] >> (16 * (i % 2)))));
      break;
    case kF16:
#pragma unroll
      for (int i = 0; i < 8; ++i)
        out[i] = __half2float(__ushort_as_half(uint16_t(w[i / 2] >> (16 * (i % 2)))));
      break;
    default:
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float f[4];
        word_values(kind, w[j], hi, f);
#pragma unroll
        for (int i = 0; i < 4; ++i) out[4 * j + i] = f[i];
      }
  }
}

// Four int8/int4 elements of a stored word as packed signed bytes, the
// operand layout of __dp4a (element c + j in byte j).
__device__ __forceinline__ uint32_t s8x4(int kind, uint32_t w, int hi) {
  if (kind == kI8) return w;
  uint32_t out = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out |= (uint32_t(int4_value((w >> (8 * j)) & 0xFFu, hi)) & 0xFFu) << (8 * j);
  return out;
}

// Round to the q/O dtype (0 = float32, 1 = bfloat16, 2 = float16) and back.
__device__ __forceinline__ float round_to(float x, int dt) {
  switch (dt) {
    case 0: return x;
    case 1: return __bfloat162float(__float2bfloat16_rn(x));
    default: return __half2float(__float2half_rn(x));
  }
}

}  // namespace
