// Pieces shared by the attention kernels (attn_fwd*.cu, attn_bwd*.cu,
// paged_verify.cuh), sm_90a.
//
// The masking rule of the JAX package (bottom-right causal alignment,
// sliding window on the causal band, ragged KV tail), the ALiBi,
// attention-dropout and segment-id arguments and the dropout mask, the
// pack of two fp32 values to a 16-bit pair the wgmma kernels share, and
// the fp8-V conversions.  Each source that includes this file is its own
// library (_cuda.py hashes the headers with it).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ops/fwd_kernel.py DEFAULT_MASK_VALUE: the lse of a row that sees no key.
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Whether q row `row` sees key `col`: row i sits at kv position i + Nkv - Nq.
__device__ __forceinline__ bool visible(int row, int col, int Nq, int Nkv,
                                        int causal, int window) {
  const int pos = row + Nkv - Nq;
  bool ok = col < Nkv;
  if (causal) {
    ok = ok && col <= pos;
    if (window > 0) ok = ok && (pos - col) < window;
  }
  return ok;
}

// Whether every (row, col) of the tile [m0, m0 + M) x [n0, n0 + N) is
// visible, so the mask can be skipped.  Never true under segment ids, whose
// test is per element (callers write `!SEG && tile_unmasked(...)`), as in
// the JAX kernel ("with segments every block masks").
template <int M, int N>
__device__ __forceinline__ bool tile_unmasked(int m0, int n0, int Nq, int Nkv,
                                              int causal, int window) {
  const int q_off = Nkv - Nq;
  bool full = n0 + N <= Nkv;
  if (causal) {
    full = full && n0 + N - 1 <= m0 + q_off;
    if (window > 0) full = full && (m0 + M - 1 + q_off) - n0 < window;
  }
  return full;
}

// ALiBi, attention dropout and segment ids of one attention call
// (ops/fwd_kernel.py mod_args).  The bias is the true -m_h * (q_pos - col),
// added after the softcap and before the mask; with segment ids, q row i
// sees key j only where q_seg[b, i] == kv_seg[b, j] (and the causal /
// window rule holds).
struct Mods {
  const float* slopes;  // [Hq] natural-base ALiBi slopes, or null
  float rate;           // dropout rate; 0 = no dropout
  float keep_scale;     // 1 / (1 - rate), rounded once from double
  uint32_t seed;
  const int* q_seg;     // [B, Nq] int32 segment ids, or null
  const int* kv_seg;    // [B, Nkv] int32 segment ids, or null
};

// The segment id of position i of batch row b of a [B, N] id array; 0 past
// N (those positions are masked by bounds).
__device__ __forceinline__ int seg_id(const int* ids, int b, int N, int i) {
  return i < N ? ids[size_t(b) * N + i] : 0;
}

// Wellons' lowbias32 mixer: the JAX package's int32 version bit for bit
// (wrapping multiplies, logical shifts).
__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// The dropout stream of (batch b, q head h): lowbias32(seed ^ (b*65599 + h)).
__device__ __forceinline__ uint32_t dropout_stream(uint32_t seed, int b, int h) {
  return lowbias32(seed ^ uint32_t(b * 65599 + h));
}

// The keep/scale factor of element (local q row, kv column), as
// ops/fwd_kernel.py dropout_keep_mask: keep_scale where the 24 low bits of
// lowbias32(row ^ lowbias32(col + stream)), times 2^-24, reach the rate.
__device__ __forceinline__ float dropout_factor(uint32_t stream, int row, int col,
                                                const Mods& md) {
  const uint32_t bits = lowbias32(uint32_t(row) ^ lowbias32(uint32_t(col) + stream));
  return float(bits & 0xFFFFFFu) * 5.9604644775390625e-8f >= md.rate ? md.keep_scale
                                                                     : 0.f;
}

// Calls fn(alibi, drop, seg) with std::true_type / std::false_type for the
// modes the call asks for: the kernels take ALiBi, dropout and segment ids
// as template flags, so a call without them runs code compiled without them
// (runtime branches in the unrolled tile loops cost registers, and 14-40%
// of the mode-free kernels' time on the H100).  SEG is fixed per source:
// attn_fwd*.cu / attn_bwd*.cu instantiate the kernels without segments and
// their *_seg.cu twins with them, so the halves compile side by side; a call
// whose q ids disagree with SEG is refused (kv_seg is read only where keys
// exist: it may be null when Nkv = 0).
template <bool SEG, typename Fn>
int dispatch_mods(const Mods& md, Fn&& fn) {
  if ((md.q_seg != nullptr) != SEG) return int(cudaErrorInvalidValue);
  const std::integral_constant<bool, SEG> seg{};
  const bool alibi = md.slopes != nullptr, drop = md.rate > 0.f;
  if (alibi && drop) return fn(std::true_type{}, std::true_type{}, seg);
  if (alibi) return fn(std::true_type{}, std::false_type{}, seg);
  if (drop) return fn(std::false_type{}, std::true_type{}, seg);
  return fn(std::false_type{}, std::false_type{}, seg);
}

struct TileRange {
  int lo, hi;  // tiles [lo, hi)
};

// KV tiles of N keys that q rows [m0, m0 + M) can see.
template <int M, int N>
__device__ __forceinline__ TileRange kv_tiles(int m0, int Nq, int Nkv,
                                              int causal, int window) {
  const int q_off = Nkv - Nq;
  const int row_hi = min(m0 + M, Nq);  // exclusive
  int col_hi = Nkv, col_lo = 0;
  if (causal) {
    col_hi = min(Nkv, row_hi + q_off);
    if (window > 0) col_lo = max(0, m0 + q_off - window + 1);
  }
  return {col_lo / N, col_hi > 0 ? (col_hi + N - 1) / N : 0};
}

// q tiles of STEP rows that see keys [n0, n0 + KEYS): the transpose of
// kv_tiles.  Causal: rows from the diagonal on (row + Nkv - Nq >= n0);
// window: rows whose band still reaches the tile's last key.
template <int STEP, int KEYS>
__device__ __forceinline__ TileRange q_tiles(int n0, int Nq, int Nkv, int causal,
                                             int window) {
  const int q_off = Nkv - Nq;
  int row_lo = 0, row_hi = Nq;
  if (causal) {
    row_lo = max(0, n0 - q_off);
    if (window > 0) row_hi = min(Nq, n0 + KEYS - 1 - q_off + window);
  }
  if (row_lo >= row_hi) return {0, 0};
  return {row_lo / STEP, (row_hi + STEP - 1) / STEP};
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// A pair of fp32 values rounded to T (bf16 / fp16) and packed in 32 bits,
// the element order of the tensor cores' 16-bit fragments.
template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <> struct Mma<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// V of the forward kernel in fp8 (ops/fwd_kernel.py V_KINDS): 0 = V has
// q's type, 1 = float8_e4m3fn, 2 = float8_e5m2.  Both fp8 formats convert
// exactly into fp16, bf16 and fp32; the payloads must be finite (the JAX
// contract, fwd_kernel.py:70-73).
constexpr int kVSame = 0, kVE4M3 = 1, kVE5M2 = 2;

__device__ __forceinline__ __nv_fp8_interpretation_t fp8_format(int v_kind) {
  return v_kind == kVE5M2 ? __NV_E5M2 : __NV_E4M3;
}

__device__ __forceinline__ float fp8_to_float(uint8_t x, int v_kind) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x, fp8_format(v_kind))));
}

// Two fp8 values (the first in the low byte) as a packed pair of T, by the
// paired hardware conversion to half.
template <typename T>
__device__ __forceinline__ uint32_t fp8x2_to(uint32_t x, int v_kind);

template <>
__device__ __forceinline__ uint32_t fp8x2_to<__half>(uint32_t x, int v_kind) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(x & 0xFFFFu), fp8_format(v_kind));
  return uint32_t(h.x) | (uint32_t(h.y) << 16);
}

template <>
__device__ __forceinline__ uint32_t fp8x2_to<__nv_bfloat16>(uint32_t x, int v_kind) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(x & 0xFFFFu), fp8_format(v_kind));
  const float2 f = __half22float2(__half2(h));
  __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<uint32_t*>(&b);
}

}  // namespace
