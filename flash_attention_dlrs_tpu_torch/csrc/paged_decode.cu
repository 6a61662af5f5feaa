// Paged decode attention for Hopper, sm_90a.
//
// Replaces the unquantized single-token path of the TPU kernel
//   flash_attention_dlrs_tpu/ops/decode.py  _decode_kernel  (via _paged_decode,
//   paged_decode_attention)
// Quantized (int8 / int4 / fp8) pools, ALiBi and the multi-token verify mode
// of that kernel are not here yet (ROADMAP queue 2).
//
// Computes, for each sequence b and q head h,
//   O[b, h] = softmax(scale * q[b, h] . K[b, :len]^T (+ softcap)) V[b, :len]
// where K/V rows are gathered through the page table: token t of sequence b
// lives in pool page page_table[b, t / page_size] at row t % page_size.
// q is [B, Hq, d]; pools are [Hkv, P, page_size, d]; lengths [B] int32
// (clamped to pages_per_seq * page_size); page_table [B, pages_per_seq]
// int32.  Optionally writes the natural-base logsumexp per (b, h).  A
// sequence of length 0 gets O = 0 and lse = DEFAULT_MASK_VALUE.  q and O may
// be fp32, bf16 or fp16, and so may the pools; all arithmetic is fp32.
//
// Bound on this card.  Decode is bound by bytes: every step reads each live
// K/V row once (2 * len * d * bytes per kv head) and does only 2 flops per
// byte of bf16 K/V.  The floor is sum(len) * Hkv * d * 2 * bytes over
// 3.35 TB/s.  What the design does about it: one CTA per (b, kv head) serves
// all Hq/Hkv q heads of its GQA group, so each K/V row is read from device
// memory once per step, not once per q head; a 64-token tile of K and V is
// staged with 16-byte loads that are all issued before any is consumed, so
// a tile costs about one memory round trip.  It does not carry over the TPU's
// cross-cell DMA hand-off, which relied on a strictly sequential grid; CUDA
// blocks run in no order.  With only B*Hkv CTAs the card is under-filled at
// small batch: a split-KV version with a combine pass is the next step
// (ROADMAP queue 2).
//
// Layout: blockDim = d threads (64 or 128).  Per tile of 64 tokens: all
// threads stage K and V rows in shared memory as fp32, each (head, token)
// score is a dot over d by one thread, one warp per head runs the online
// softmax update (exact running max), and thread c accumulates output
// column c of every head of the group.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;  // tokens staged in shared memory per step
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16 (q and O only; the
// pools' type is a template parameter)
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

// 16 bytes of pool elements → fp32 in shared memory.
template <typename KV> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void store(float* dst, uint4 raw) {
    dst[0] = __uint_as_float(raw.x); dst[1] = __uint_as_float(raw.y);
    dst[2] = __uint_as_float(raw.z); dst[3] = __uint_as_float(raw.w);
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void store(float* dst, uint4 raw) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x; dst[2 * i + 1] = f.y;
    }
  }
};
template <> struct Chunk<__half> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void store(float* dst, uint4 raw) {
    const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      dst[2 * i] = f.x; dst[2 * i + 1] = f.y;
    }
  }
};

template <int D>
__host__ __device__ size_t smem_floats(int G) {
  // sQ [G][D], sK [TILE][D+1], sV [TILE][D], sS [G][TILE], sAcc [G][D],
  // sM/sL/sAlpha [G]; rounded up to keep the row offsets after it aligned.
  const size_t f = size_t(G) * D + size_t(TILE) * (D + 1) + size_t(TILE) * D +
                   size_t(G) * TILE + size_t(G) * D + 3 * size_t(G);
  return (f + 1) & ~size_t(1);
}

template <typename KV, int D>
__global__ void __launch_bounds__(D)
paged_decode_kernel(const void* __restrict__ q, int q_dtype,
                    const KV* __restrict__ k_pages,
                    const KV* __restrict__ v_pages,
                    const int* __restrict__ lengths,
                    const int* __restrict__ page_table, void* __restrict__ o,
                    float* __restrict__ lse, int Hq, int Hkv, int P,
                    int page_size, int pages_per_seq, float sm_scale,
                    float softcap) {
  constexpr int KS = D + 1;
  constexpr int NWARPS = D / 32;
  constexpr int VEC = Chunk<KV>::N;          // pool elements per 16 bytes
  constexpr int CPR = D / VEC;               // 16-byte chunks per row
  constexpr int ITERS = TILE * CPR / D;      // chunks per thread per tile
  const int G = Hq / Hkv;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + G * D;
  float* sV = sK + TILE * KS;
  float* sS = sV + TILE * D;
  float* sAcc = sS + G * TILE;
  float* sM = sAcc + G * D;
  float* sL = sM + G;
  float* sAlpha = sL + G;
  size_t* sOff = reinterpret_cast<size_t*>(smem + smem_floats<D>(G));

  int len = lengths[b];
  len = max(0, min(len, pages_per_seq * page_size));
  const int h0 = kvh * G;

  for (int idx = tid; idx < G * D; idx += D) {
    sQ[idx] = load_f(q, (size_t(b) * Hq + h0) * D + idx, q_dtype);
    sAcc[idx] = 0.f;
  }
  for (int g = tid; g < G; g += D) {
    sM[g] = -INFINITY;
    sL[g] = 0.f;
  }

  const int* table = page_table + size_t(b) * pages_per_seq;
  for (int t0 = 0; t0 < len; t0 += TILE) {
    const int n = min(TILE, len - t0);
    __syncthreads();  // previous tile fully consumed
    for (int r = tid; r < n; r += D) {
      const int pos = t0 + r;
      const int page = table[pos / page_size];
      sOff[r] = ((size_t(kvh) * P + page) * page_size + pos % page_size) * D;
    }
    __syncthreads();
    // Every load of the tile in flight before the first is used.
    uint4 kraw[ITERS], vraw[ITERS];
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int idx = tid + it * D;
      const int r = idx / CPR, c = (idx % CPR) * VEC;
      if (r < n) {
        kraw[it] = *reinterpret_cast<const uint4*>(k_pages + sOff[r] + c);
        vraw[it] = *reinterpret_cast<const uint4*>(v_pages + sOff[r] + c);
      }
    }
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int idx = tid + it * D;
      const int r = idx / CPR, c = (idx % CPR) * VEC;
      if (r < n) {
        Chunk<KV>::store(sK + r * KS + c, kraw[it]);
        Chunk<KV>::store(sV + r * D + c, vraw[it]);
      }
    }
    __syncthreads();

    // Scores for every (head, token) pair of the tile.
    for (int pair = tid; pair < G * n; pair += D) {
      const int g = pair / n, r = pair % n;
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
      float x = ((d0 + d1) + (d2 + d3)) * sm_scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      sS[g * TILE + r] = x;
    }
    __syncthreads();

    // Online softmax update, one warp per head.
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
        srow[r] = p;
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
  const int *lengths, *page_table;
  void* o;
  float* lse;
  int B, Hq, Hkv, P, page_size, pages_per_seq;
  float sm_scale, softcap;
  cudaStream_t stream;
};

template <typename KV, int D>
int launch(const Args& a) {
  auto kernel = paged_decode_kernel<KV, D>;
  const size_t smem = smem_floats<D>(a.Hq / a.Hkv) * sizeof(float) +
                      TILE * sizeof(size_t);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(a.Hkv, a.B);
  kernel<<<grid, D, smem, a.stream>>>(
      a.q, a.q_dtype, static_cast<const KV*>(a.k_pages),
      static_cast<const KV*>(a.v_pages), a.lengths, a.page_table, a.o, a.lse,
      a.Hq, a.Hkv, a.P, a.page_size, a.pages_per_seq, a.sm_scale, a.softcap);
  return int(cudaGetLastError());
}

template <typename KV>
int launch_d(int D, const Args& a) {
  if (D == 64) return launch<KV, 64>(a);
  if (D == 128) return launch<KV, 128>(a);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// lse may be null.  Pools must be 16-byte aligned.  A GQA group too large for
// shared memory is refused by cudaFuncSetAttribute and reported through the
// return code.  Returns cudaGetLastError() after the launch (0 on success);
// launches nothing for an empty batch.
extern "C" int paged_decode(const void* q, int q_dtype, const void* k_pages,
                            const void* v_pages, int kv_dtype,
                            const int* lengths, const int* page_table, void* o,
                            float* lse, int B, int Hq, int Hkv, int P,
                            int page_size, int pages_per_seq, int D,
                            float sm_scale, float softcap, void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || page_size <= 0 || pages_per_seq <= 0)
    return int(cudaErrorInvalidValue);
  const Args a{q, q_dtype, k_pages, v_pages, lengths, page_table, o, lse, B,
               Hq, Hkv, P, page_size, pages_per_seq, sm_scale, softcap,
               static_cast<cudaStream_t>(stream)};
  switch (kv_dtype) {
    case 0: return launch_d<float>(D, a);
    case 1: return launch_d<__nv_bfloat16>(D, a);
    case 2: return launch_d<__half>(D, a);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
