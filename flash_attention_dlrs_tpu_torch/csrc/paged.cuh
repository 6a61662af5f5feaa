// Page-pool formats shared by the paged attention kernels (paged_decode.cuh,
// paged_verify.cuh and wide.cuh's), sm_90a, and what they share beyond
// them: stored words converted to fp32, the asynchronous copies that stage
// pages (1-D bulk copies and 16-byte cp.async, both completing on an
// mbarrier), the layout of key splits and their merge inside a launch.
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
//
// Key splits.  A call may cut each sequence's page table into `splits`
// runs of pages_per_split = ceil(pages_per_seq / splits) whole pages (the
// host's planner, ops/decode.py decode_splits, picks the count from static
// shapes).  Each split's CTA writes its rows' attention normalized over its
// own keys, in fp32, and the natural-base lse of those keys, or an lse of
// -inf when it sees none; the splits of each row are then merged in split
// order by lse weight (ops/decode.py combine_partials; merge_rows below,
// paged_verify.cuh paged_verify_combine_kernel), so a call is
// bitwise repeatable and no atomics touch O.

#pragma once

#include "sm90.cuh"

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

// Byte j of `x` (an unsigned offset u) as the fp32 2^23 + u, minus `bias`:
// one byte permute and one add an element, exact, where an int-to-float
// conversion runs at a quarter of the rate.
__device__ __forceinline__ float biased_byte(uint32_t x, int j, float bias) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u | j)) - bias;
}

// The int4 nibbles (`hi`: the high ones) of a stored word as unsigned
// offsets v + 8, one a byte.
__device__ __forceinline__ uint32_t int4_offsets(uint32_t w, int hi) {
  return ((w >> (4 * hi)) & 0x0F0F0F0Fu) ^ 0x08080808u;
}

// The four elements of one stored word of a 1-byte kind (element c + j in
// byte j), as fp32: one switch per word, fp8 through the paired hardware
// conversion to half.
__device__ __forceinline__ void word_values(int kind, uint32_t w, int hi,
                                            float (&f)[4]) {
  switch (kind) {
    case kI8:  // v + 128 in each byte, as 2^23 + v + 128
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] = biased_byte(w ^ 0x80808080u, j, 8388736.f);
      break;
    case kI4:
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] = biased_byte(int4_offsets(w, hi), j, 8388616.f);
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
  return __vsub4(int4_offsets(w, hi), 0x08080808u);  // bytewise, two's complement
}

// dtype codes of q and O: 0 = float32, 1 = bfloat16, 2 = float16
__device__ __forceinline__ float load_as_float(const void* p, size_t i, int dt) {
  switch (dt) {
    case 0: return static_cast<const float*>(p)[i];
    case 1: return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    default: return __half2float(static_cast<const __half*>(p)[i]);
  }
}

__device__ __forceinline__ void store_as(void* p, size_t i, int dt, float x) {
  switch (dt) {
    case 0: static_cast<float*>(p)[i] = x; break;
    case 1: static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x); break;
    default: static_cast<__half*>(p)[i] = __float2half_rn(x); break;
  }
}

// Round to the q/O dtype (0 = float32, 1 = bfloat16, 2 = float16) and back.
__device__ __forceinline__ float round_to(float x, int dt) {
  switch (dt) {
    case 0: return x;
    case 1: return __bfloat162float(__float2bfloat16_rn(x));
    default: return __half2float(__float2half_rn(x));
  }
}

// The elements of N stored words of a row (a lane's share of it, element c +
// j of a 1-byte kind in byte j of a word) as fp32, exact for every kind;
// `hi` picks an int4 byte's high nibble.  paged_decode.cuh and wide.cuh's
// decode read rows this way.
template <int KIND, int N>
__device__ __forceinline__ void row_values(const uint32_t (&w)[N], int hi, float* out) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (KIND == kF32) {
      out[i] = __uint_as_float(w[i]);
    } else if constexpr (KIND == kBF16) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    } else if constexpr (KIND == kF16) {
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    } else {
      float f[4];
      word_values(KIND, w[i], hi, f);
#pragma unroll
      for (int j = 0; j < 4; ++j) out[4 * i + j] = f[j];
    }
  }
}

// ---------------------------------------------------------------------------
// The merge of a split call
// ---------------------------------------------------------------------------

// Counts this CTA in `counter`, the count of the CTAs of one group (the
// CTAs whose splits cover the same rows), once every thread has written its
// share of the CTA's partial; true in the group's last CTA, which resets the
// counter to 0 for the next call and then sees every other CTA's partial.
__device__ __forceinline__ bool last_of_group(unsigned* counter, int splits) {
  __shared__ int last;
  __threadfence();  // this thread's partial writes, before the count
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1u) == unsigned(splits - 1);
    if (last) {
      *counter = 0u;
      __threadfence();  // the other CTAs' partials, before the reads below
    }
  }
  __syncthreads();
  return last;
}

// The group's merge, by its last CTA: `n` rows (row_of(i) the index of row
// i in O, part_o [splits, rows, D] and part_lse [splits, rows]), O = sum_s
// w_s O_s / sum_s w_s with w_s = exp(lse_s - max lse), summed in split
// order; a partial of lse -inf weighs exactly 0 (its O is never used).  A
// row no split saw gets O = 0 and lse kMaskValue.  lse may be null.  First
// one warp a row takes the row's maximum and weights (a lane a split, all
// loads at once) into `scratch` (splits * n + n floats of shared memory),
// then each thread sums four columns of a row, several splits' loads in
// flight at once.
template <typename RowOf>
__device__ __forceinline__ void merge_rows(const float* part_o, const float* part_lse,
                                           int splits, size_t rows, int n, int D,
                                           RowOf row_of, void* o, int o_dtype, float* lse,
                                           float* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  float* w = scratch;                // [splits][n]: 0 where a split saw nothing
  float* row_max = scratch + splits * n;  // [n]
  for (int r = warp; r < n; r += warps) {
    const size_t row = row_of(r);
    float mx = -INFINITY;
    for (int s = lane; s < splits; s += 32) mx = fmaxf(mx, __ldcg(part_lse + s * rows + row));
#pragma unroll
    for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    for (int s = lane; s < splits; s += 32) {
      const float ls = __ldcg(part_lse + s * rows + row);
      w[s * n + r] = ls != -INFINITY ? expf(ls - mx) : 0.f;
    }
    if (lane == 0) row_max[r] = mx;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n * (D / 4); i += blockDim.x) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const size_t row = row_of(r);
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, w_sum = 0.f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {
      const float ws = w[s * n + r];
      const float4 os = __ldcg(reinterpret_cast<const float4*>(part_o + (s * rows + row) * D + c));
      w_sum += ws;
      if (ws != 0.f) {
        acc[0] = fmaf(ws, os.x, acc[0]);
        acc[1] = fmaf(ws, os.y, acc[1]);
        acc[2] = fmaf(ws, os.z, acc[2]);
        acc[3] = fmaf(ws, os.w, acc[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_as(o, row * D + c + j, o_dtype, w_sum > 0.f ? acc[j] / w_sum : 0.f);
    if (lse != nullptr && c == 0) lse[row] = w_sum > 0.f ? row_max[r] + logf(w_sum) : kMaskValue;
  }
}

// ---------------------------------------------------------------------------
// Asynchronous copies into shared memory (global addresses 16-byte aligned)
// ---------------------------------------------------------------------------

// One contiguous run of `bytes` (a multiple of 16) by the bulk copy engine;
// completes `bytes` of the mbarrier's expected transaction count.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes, of which the first `src_bytes` (0 or 16) are read and the rest
// zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// One arrival on the mbarrier once this thread's earlier cp.asyncs have
// landed (counted against the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

}  // namespace
