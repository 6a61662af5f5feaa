// Paged decode attention for Hopper, sm_90a.
//
// Replaces the single-token path of the TPU kernel
//   flash_attention_dlrs_tpu/ops/decode.py  _decode_kernel  (via _paged_decode,
//   paged_decode_attention)
// for every pool kind of paged.cuh: float32 / bfloat16 / float16 values and
// int8 / packed int4 / fp8 (e4m3fn, e5m2) payloads with per-token scales,
// with ALiBi.  Its multi-token verify mode is paged_verify.cu.
//
// Computes, for each sequence b and q head h,
//   O[b, h] = softmax(S[b, h, :len]) V[b, :len]
// where K/V rows are gathered through the page table.  q is [B, Hq, d];
// lengths [B] int32 (clamped to pages_per_seq * page_size); page_table
// [B, pages_per_seq] int32.  Optionally writes the natural-base logsumexp
// per (b, h).  A sequence of length 0 gets O = 0 and lse = DEFAULT_MASK_VALUE.
// q and O may be fp32, bf16 or fp16; all arithmetic is fp32.  The scores:
//  * value pools: S = scale * q . k (+ softcap), and P V in fp32;
//  * quantized pools, the TPU kernel's arithmetic: q is pre-scaled in its
//    own dtype (the caller passes sm_scale rounded to it); the K scale
//    multiplies S and the V scale P, and P * v_scale is rounded to q's dtype
//    before P V; the payloads themselves are never scaled.
//    - int8 / int4 K take the integer route: each q row is quantized once to
//      int8 as rint(q * (127 / max|q|)) (round half to even, the division
//      first, as the TPU kernel orders it), the score is an exact __dp4a
//      dot over d, times max|q| * (1/127), times the K scale;
//    - fp8 K converts natively (cuda_fp8.h; exact in fp32) into an fp32 dot.
//  Softcap applies after the scales, then ALiBi's true bias
//  -m_h * (len - 1 - pos) (the single query sits at len - 1), never inside
//  the integer dot; the lse is then the true one (the wrapper publishes it
//  shifted by +m_h * (len - 1), the JAX convention).  The TPU kernel added
//  the separable +m_h * pos instead; the true form costs the same FMA here
//  and keeps the scores small.
//
// Bound on this card.  Decode is bound by bytes: every step reads each live
// K/V row once (2 * len * d * bytes per kv head, plus 8 bytes of scales per
// token when quantized) and does only 2 flops per byte of bf16 K/V.  The
// floor is those bytes over 3.35 TB/s: int8 halves bf16's, int4 quarters it.
// What the design does about it: one CTA per (b, kv head) serves all Hq/Hkv
// q heads of its GQA group, so each K/V row is read from device memory once
// per step, not once per q head; a 64-token tile of K and V is staged with
// 16-byte loads that are all issued before any is consumed, so a tile costs
// about one memory round trip; int8/int4 K stay 8-bit in shared memory and
// the scores run on __dp4a, four products an instruction.  int4 reads each
// stored byte row once per token it holds (twice per page, the second from
// L2).  It does not carry over the TPU's cross-cell DMA hand-off, which
// relied on a strictly sequential grid; CUDA blocks run in no order.  With
// only B*Hkv CTAs the card is under-filled at small batch: a split-KV
// version with a combine pass is the next step (ROADMAP queue 2).
//
// Layout: blockDim = d threads (64 or 128).  Per tile of 64 tokens: all
// threads stage K and V rows in shared memory (V as fp32; K as fp32, or as
// packed int8 words on the integer route), each (head, token) score is a
// dot over d by one thread, one warp per head runs the online softmax update
// (exact running max), and thread c accumulates output column c of every
// head of the group.

#include <math.h>

#include "paged.cuh"

namespace {

constexpr int TILE = 64;  // tokens staged in shared memory per step
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

// dtype codes of q and O: 0 = float32, 1 = bfloat16, 2 = float16
__device__ __forceinline__ float load_f(const void* p, size_t i, int dt) {
  switch (dt) {
    case 0: return static_cast<const float*>(p)[i];
    case 1: return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    default: return __half2float(static_cast<const __half*>(p)[i]);
  }
}

__device__ __forceinline__ void store_f(void* p, size_t i, int dt, float x) {
  switch (dt) {
    case 0: static_cast<float*>(p)[i] = x; break;
    case 1: static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x); break;
    default: static_cast<__half*>(p)[i] = __float2half_rn(x); break;
  }
}

template <int D>
__host__ __device__ size_t smem_floats(int G) {
  // sQ [G][D], sQi [G][D/4] words, sK [TILE][D+1], sV [TILE][D],
  // sS [G][TILE], sAcc [G][D], sM/sL/sAlpha/sQc [G], sKs/sVs [TILE];
  // rounded up to keep the offsets after it 8-byte aligned.
  const size_t f = size_t(G) * D + size_t(G) * (D / 4) + size_t(TILE) * (D + 1) +
                   size_t(TILE) * D + size_t(G) * TILE + size_t(G) * D +
                   4 * size_t(G) + 2 * size_t(TILE);
  return (f + 1) & ~size_t(1);
}

template <int D>
size_t smem_bytes(int G) {
  return smem_floats<D>(G) * sizeof(float) + TILE * (sizeof(size_t) + sizeof(int));
}

template <int KIND, int D>
__global__ void __launch_bounds__(D)
paged_decode_kernel(const void* __restrict__ q, int q_dtype,
                    const void* __restrict__ k_pages,
                    const void* __restrict__ v_pages,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ lengths,
                    const int* __restrict__ page_table, void* __restrict__ o,
                    float* __restrict__ lse, int Hq, int Hkv, int P,
                    int page_size, int pages_per_seq, float sm_scale,
                    float softcap, const float* __restrict__ slopes) {
  constexpr bool QUANT = is_quantized(KIND);
  constexpr bool INT_ROUTE = KIND == kI8 || KIND == kI4;
  constexpr int EB = stored_bytes(KIND);
  constexpr int VEC = 16 / EB;               // elements per 16-byte chunk
  constexpr int CPR = D / VEC;               // 16-byte chunks per row
  constexpr int ITERS = TILE * CPR / D;      // chunks per thread per tile
  constexpr int KS = D + 1;                  // fp32 K row stride (floats)
  constexpr int KW = D / 4 + 1;              // int8 K row stride (words)
  constexpr int NWARPS = D / 32;
  const int G = Hq / Hkv;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  extern __shared__ float smem[];
  float* sQ = smem;
  uint32_t* sQi = reinterpret_cast<uint32_t*>(sQ + G * D);
  float* sK = reinterpret_cast<float*>(sQi + G * (D / 4));
  uint32_t* sKi = reinterpret_cast<uint32_t*>(sK);  // integer route
  float* sV = sK + TILE * KS;
  float* sS = sV + TILE * D;
  float* sAcc = sS + G * TILE;
  float* sM = sAcc + G * D;
  float* sL = sM + G;
  float* sAlpha = sL + G;
  float* sQc = sAlpha + G;
  float* sKs = sQc + G;
  float* sVs = sKs + TILE;
  size_t* sOff = reinterpret_cast<size_t*>(smem + smem_floats<D>(G));
  int* sHi = reinterpret_cast<int*>(sOff + TILE);

  int len = lengths[b];
  len = max(0, min(len, pages_per_seq * page_size));
  const int h0 = kvh * G;

  for (int idx = tid; idx < G * D; idx += D) {
    float x = load_f(q, (size_t(b) * Hq + h0) * D + idx, q_dtype);
    // quantized pools: q pre-scaled in its own dtype (sm_scale arrives
    // rounded to it, so the product is exact before the rounding)
    if (QUANT) x = round_to(x * sm_scale, q_dtype);
    sQ[idx] = x;
    sAcc[idx] = 0.f;
  }
  for (int g = tid; g < G; g += D) {
    sM[g] = -INFINITY;
    sL[g] = 0.f;
  }
  if (INT_ROUTE) {
    __syncthreads();
    for (int g = warp; g < G; g += NWARPS) {
      const float* qr = sQ + g * D;
      float qa = 0.f;
      for (int c = lane; c < D; c += 32) qa = fmaxf(qa, fabsf(qr[c]));
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        qa = fmaxf(qa, __shfl_xor_sync(0xffffffffu, qa, off));
      const float inv = qa > 0.f ? 127.f / qa : 0.f;
      for (int w = lane; w < D / 4; w += 32) {
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int v = __float2int_rn(qr[4 * w + j] * inv);
          word |= (uint32_t(v) & 0xFFu) << (8 * j);
        }
        sQi[g * (D / 4) + w] = word;
      }
      if (lane == 0) sQc[g] = qa * (1.0f / 127.0f);
    }
  }

  const char* kb = static_cast<const char*>(k_pages);
  const char* vb = static_cast<const char*>(v_pages);
  const int* table = page_table + size_t(b) * pages_per_seq;
  for (int t0 = 0; t0 < len; t0 += TILE) {
    const int n = min(TILE, len - t0);
    __syncthreads();  // previous tile fully consumed
    for (int r = tid; r < n; r += D) {
      const int pos = t0 + r;
      const int page = table[pos / page_size];
      const int off = pos % page_size;
      const TokenAddr a = token_addr(KIND, kvh, page, off, P, page_size, D);
      sOff[r] = a.row;
      sHi[r] = a.hi;
      if (QUANT) {
        const size_t si = scale_index(kvh, page, off, P, page_size);
        sKs[r] = k_scales[si];
        sVs[r] = v_scales[si];
      }
    }
    __syncthreads();
    // Every load of the tile in flight before the first is used.
    uint4 kraw[ITERS], vraw[ITERS];
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int idx = tid + it * D;
      const int r = idx / CPR, c = (idx % CPR) * VEC;
      if (r < n) {
        kraw[it] = *reinterpret_cast<const uint4*>(kb + (sOff[r] + c) * EB);
        vraw[it] = *reinterpret_cast<const uint4*>(vb + (sOff[r] + c) * EB);
      }
    }
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int idx = tid + it * D;
      const int r = idx / CPR, c = (idx % CPR) * VEC;
      if (r < n) {
        const int hi = sHi[r];
        if (INT_ROUTE) {
          const uint32_t w[4] = {kraw[it].x, kraw[it].y, kraw[it].z, kraw[it].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) sKi[r * KW + c / 4 + j] = s8x4(KIND, w[j], hi);
        } else {
          chunk_values(KIND, kraw[it], hi, sK + r * KS + c);
        }
        chunk_values(KIND, vraw[it], hi, sV + r * D + c);
      }
    }
    __syncthreads();

    // Scores for every (head, token) pair of the tile.
    for (int pair = tid; pair < G * n; pair += D) {
      const int g = pair / n, r = pair % n;
      float x;
      if (INT_ROUTE) {
        const uint32_t* qr = sQi + g * (D / 4);
        const uint32_t* kr = sKi + r * KW;
        int acc = 0;
#pragma unroll 8
        for (int w = 0; w < D / 4; ++w) acc = __dp4a(int(qr[w]), int(kr[w]), acc);
        x = float(acc) * sQc[g] * sKs[r];
      } else {
        const float* qr = sQ + g * D;
        const float* kr = sK + r * KS;
        float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;  // split FMA chains
#pragma unroll 8
        for (int c = 0; c < D; c += 4) {
          d0 = fmaf(qr[c], kr[c], d0);
          d1 = fmaf(qr[c + 1], kr[c + 1], d1);
          d2 = fmaf(qr[c + 2], kr[c + 2], d2);
          d3 = fmaf(qr[c + 3], kr[c + 3], d3);
        }
        const float dot = (d0 + d1) + (d2 + d3);
        x = QUANT ? dot * sKs[r] : dot * sm_scale;
      }
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      if (slopes != nullptr) x -= slopes[h0 + g] * float(len - 1 - (t0 + r));
      sS[g * TILE + r] = x;
    }
    __syncthreads();

    // Online softmax update, one warp per head.  Quantized pools: the row
    // sum takes P, the P V product P * v_scale rounded to q's dtype.
    for (int g = warp; g < G; g += NWARPS) {
      float* srow = sS + g * TILE;
      float mx = -INFINITY;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, srow[r]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);  // 0 on the first tile
      float sum = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float p = expf(srow[r] - m_new);
        srow[r] = QUANT ? round_to(p * sVs[r], q_dtype) : p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        sL[g] = sL[g] * alpha + sum;
        sM[g] = m_new;
        sAlpha[g] = alpha;
      }
    }
    __syncthreads();

    // Output column `tid` of every head in the group.
    for (int g = 0; g < G; ++g) {
      const float* prow = sS + g * TILE;
      float a0 = sAcc[g * D + tid] * sAlpha[g], a1 = 0.f;  // split FMA chains
      int r = 0;
      for (; r + 1 < n; r += 2) {
        a0 = fmaf(prow[r], sV[r * D + tid], a0);
        a1 = fmaf(prow[r + 1], sV[(r + 1) * D + tid], a1);
      }
      if (r < n) a0 = fmaf(prow[r], sV[r * D + tid], a0);
      sAcc[g * D + tid] = a0 + a1;
    }
  }
  __syncthreads();

  for (int g = 0; g < G; ++g) {
    const float l = sL[g];
    const float out = l > 0.f ? sAcc[g * D + tid] / l : 0.f;
    store_f(o, (size_t(b) * Hq + h0 + g) * D + tid, q_dtype, out);
  }
  if (lse != nullptr) {
    for (int g = tid; g < G; g += D) {
      const float l = sL[g];
      lse[size_t(b) * Hq + h0 + g] = l > 0.f ? sM[g] + logf(l) : kMaskValue;
    }
  }
}

struct Args {
  const void* q;
  int q_dtype;
  const void *k_pages, *v_pages;
  const float *k_scales, *v_scales;
  const int *lengths, *page_table;
  void* o;
  float* lse;
  int B, Hq, Hkv, P, page_size, pages_per_seq;
  float sm_scale, softcap;
  const float* slopes;
  cudaStream_t stream;
};

template <int KIND, int D>
int launch(const Args& a) {
  auto kernel = paged_decode_kernel<KIND, D>;
  const size_t smem = smem_bytes<D>(a.Hq / a.Hkv);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(a.Hkv, a.B);
  kernel<<<grid, D, smem, a.stream>>>(
      a.q, a.q_dtype, a.k_pages, a.v_pages, a.k_scales, a.v_scales, a.lengths,
      a.page_table, a.o, a.lse, a.Hq, a.Hkv, a.P, a.page_size,
      a.pages_per_seq, a.sm_scale, a.softcap, a.slopes);
  return int(cudaGetLastError());
}

template <int KIND>
int launch_d(int D, const Args& a) {
  if (D == 64) return launch<KIND, 64>(a);
  if (D == 128) return launch<KIND, 128>(a);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// kv_kind: a PoolKind of paged.cuh.  page_size is the LOGICAL page size (an
// int4 pool stores page_size/2 rows).  Quantized kinds need k_scales and
// v_scales [Hkv, P, page_size] fp32 and take sm_scale rounded to q's dtype;
// value kinds ignore the scale pointers.  lse may be null.  slopes: [Hq]
// fp32 ALiBi slopes on the device, or null.  Pools must be
// 16-byte aligned.  A GQA group too large for shared memory is refused by
// cudaFuncSetAttribute and reported through the return code.  Returns
// cudaGetLastError() after the launch (0 on success); launches nothing for
// an empty batch.
extern "C" int paged_decode(const void* q, int q_dtype, const void* k_pages,
                            const void* v_pages, int kv_kind,
                            const float* k_scales, const float* v_scales,
                            const int* lengths, const int* page_table, void* o,
                            float* lse, int B, int Hq, int Hkv, int P,
                            int page_size, int pages_per_seq, int D,
                            float sm_scale, float softcap, const float* slopes,
                            void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || page_size <= 0 || pages_per_seq <= 0 ||
      (kv_kind == kI4 && page_size % 2) ||
      (is_quantized(kv_kind) && (k_scales == nullptr || v_scales == nullptr)))
    return int(cudaErrorInvalidValue);
  const Args a{q, q_dtype, k_pages, v_pages, k_scales, v_scales, lengths,
               page_table, o, lse, B, Hq, Hkv, P, page_size, pages_per_seq,
               sm_scale, softcap, slopes, static_cast<cudaStream_t>(stream)};
  switch (kv_kind) {
    case kF32: return launch_d<kF32>(D, a);
    case kBF16: return launch_d<kBF16>(D, a);
    case kF16: return launch_d<kF16>(D, a);
    case kI8: return launch_d<kI8>(D, a);
    case kI4: return launch_d<kI4>(D, a);
    case kE4M3: return launch_d<kE4M3>(D, a);
    case kE5M2: return launch_d<kE5M2>(D, a);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
