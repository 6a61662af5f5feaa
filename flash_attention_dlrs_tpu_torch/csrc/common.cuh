// Pieces shared by the attention kernels (attn_fwd.cu, attn_bwd.cu), sm_90a.
//
// The masking rule of the JAX package (bottom-right causal alignment,
// sliding window on the causal band, ragged KV tail), the tensor-core
// fragment helpers (mma.sync.m16n8k16 with fp32 accumulate, ldmatrix) and
// the 16-byte tile staging.  Each source that includes this file is its own
// library (_cuda.py hashes the headers with it).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// visible, so the mask can be skipped.
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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <> struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// Fragment addresses for a warp's 16 x 16 A operand at rows [r0, r0 + 16),
// columns [c0, c0 + 16) of a [.][S] shared tile (row-major A).
template <int S, typename T>
__device__ __forceinline__ const T* a_frag(const T* tile, int r0, int c0, int lane) {
  return tile + (r0 + lane % 16) * S + c0 + (lane / 16) * 8;
}

// B operands of two n-tiles (n rows [n0, n0 + 16) of the tile), k columns
// [c0, c0 + 16): the tile holds B transposed (rows = n), as K does in Q K^T.
template <int S, typename T>
__device__ __forceinline__ const T* b_frag(const T* tile, int n0, int c0, int lane) {
  return tile + (n0 + lane % 8 + (lane / 16) * 8) * S + c0 + ((lane / 8) % 2) * 8;
}

// B operands of two n-tiles from a tile holding B as stored (rows = k, the
// k rows [k0, k0 + 16), n columns [n0, n0 + 16)), loaded transposed, as V
// is in P V.
template <int S, typename T>
__device__ __forceinline__ const T* bt_frag(const T* tile, int k0, int n0, int lane) {
  return tile + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * S + n0 + (lane / 16) * 8;
}

// Rows [r0, r0 + ROWS) of a [N, D] matrix into a [ROWS][S] shared tile, zero
// beyond N, 16 bytes per load, all loads issued before the first store.
template <typename T, int D, int S, int ROWS, int THREADS>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, int r0, int N,
                                           int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;  // 16-byte chunks per row
  static_assert(ROWS * CPR % THREADS == 0, "tile must split evenly");
  constexpr int ITERS = ROWS * CPR / THREADS;
  uint4 buf[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int idx = tid + it * THREADS;
    const int r = idx / CPR, c = (idx % CPR) * VEC;
    buf[it] = r0 + r < N
                  ? *reinterpret_cast<const uint4*>(src + size_t(r0 + r) * D + c)
                  : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int idx = tid + it * THREADS;
    const int r = idx / CPR, c = (idx % CPR) * VEC;
    *reinterpret_cast<uint4*>(dst + r * S + c) = buf[it];
  }
}

}  // namespace
