// Blocked attention forward for Hopper, sm_90a: the fp32 kernel, the launch
// arguments and the C entry, included by six sources that compile side by
// side, one for each head dim (64, 128, 256) without and with segment ids
// (attn_fwd_entry); the bf16 / fp16 kernel is in attn_fwd_sm90.cuh.
//
// Replaces the forward of four TPU kernels, with their whole feature set:
//   flash_attention_dlrs_tpu/ops/fwd_kernel.py  _fwd_kernel        (general tri/band grid;
//                                                                   ALiBi, dropout, segment
//                                                                   ids, fp8 V)
//   flash_attention_dlrs_tpu/ops/fwd_mid.py     _mid_kernel        (causal pane, N <= 2048;
//                                                                   fp8 V)
//   flash_attention_dlrs_tpu/ops/fwd_mid.py     _mid_strip_kernel  (causal strip, N <= 8192;
//                                                                   fp8 V)
//   flash_attention_dlrs_tpu/ops/fwd_small.py   _small_kernel      (one-shot, N <= 512;
//                                                                   segment ids, fp8 V)
// The TPU split that function by length to work around its grid-step
// overhead and VMEM limits; one kernel here takes every length.
//
// Computes O = dropout(softmax(scale * Q K^T (+ softcap) + bias + mask)) V and
// the natural-base logsumexp L per row, for q [B, Hq, Nq, d], k/v
// [B, Hkv, Nkv, d] (contiguous), with causal masking aligned bottom-right (row
// i sits at kv position i + Nkv - Nq), an optional sliding window on the
// causal band, an optional logit softcap, any Nq/Nkv (ragged tails are masked
// here) and GQA (kv head = h / (Hq / Hkv)).  ALiBi (common.cuh Mods) adds the
// TRUE bias -m_h * (i + Nkv - Nq - col) after the softcap, so L is the true
// logsumexp with no shift; the TPU kernel added the separable +m_h * col,
// which here would cost precision (the term reaches ~1450 at col 2048, where
// an fp32 ulp is ~1e-4) and save nothing.  Dropout multiplies P by the
// counter-based mask of common.cuh (dropout_factor of batch, q head, local
// row, column) after the row sum, so L stays undropped, and before P is
// rounded for P V, as the plain version and the TPU kernel do.  Segment ids
// (packed sequences) add q_seg[b, row] == kv_seg[b, col] to the mask; ids
// are arbitrary integers, so no tile is skipped by segment and every tile
// evaluates the mask.  ALiBi, dropout, segment ids and fp8 V are template
// flags (common.cuh dispatch_mods, dispatch_v8): a call without a mode
// runs code compiled without it.  A row that sees no key (above a
// cross-length causal diagonal, or whose segment id occurs nowhere in its
// keys, mid-sequence) gets O = 0 and L = DEFAULT_MASK_VALUE, the JAX
// package's stats_to_lse convention.  Inputs are fp32, bf16 or fp16 with d
// in {64, 128, 256}, every mode at every head dim; V may instead be fp8
// (e4m3fn or e5m2, the JAX package's
// v_payload), dequantized exactly to q's type before P V (P is still
// rounded to q's type).  The online softmax keeps an exact running max (no
// static shift) and fp32 statistics.
//
// Bound on this card.  Causal prefill at the serving shapes is bound by
// operations: 4*Nq*Nkv*d/2 flops per head against ~(2*Nq + 2*Nkv)*d*2
// bytes; the tensor cores' 989 TFLOP/s bf16 rate sets the floor.  The C
// entry takes a route (ops/fwd_kernel.py fwd_route) and refuses one that
// cannot carry the call:
//  * "wgmma" (attn_fwd_sm90.cuh): every bf16 / fp16 call, on Hopper's
//    warpgroup products fed by TMA through a ring of shared-memory stages;
//    that header says what bounds it and what its design does about it.
//  * "fp32" (this file): fp32 inputs must compute in true fp32 (the fp32
//    gate is atol 1e-4), so they run on the CUDA cores: 256 threads, each
//    owning a 4 x 4 patch of the score tile and a 4 x d/16 patch of the
//    output; 64-row K/V tiles, V dequantized as it is staged when fp8.
// Both skip KV tiles wholly above the causal diagonal or outside the window
// band, and process the heaviest causal q tiles first.

#pragma once

#include "common.cuh"

namespace {

constexpr int BM = 64;  // q rows per CTA of the fp32 kernel
constexpr int BN = 64;  // kv rows per tile of the fp32 kernel

// ---------------------------------------------------------------------------
// fp32 path (CUDA cores, true fp32)
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;  // 16 x 16

template <int D, bool SEG>
constexpr size_t f32_smem_bytes() {
  // sQ [BM][D+1], sK [BN][D+1], sV [BN][D], sS [BM][BN+1], row stats 3 x [BM];
  // with segments the K tile's ids [BN]
  return sizeof(float) *
             (size_t(BM) * (D + 1) + size_t(BN) * (D + 1) + size_t(BN) * D +
              size_t(BM) * (BN + 1) + 3 * BM) +
         (SEG ? BN * sizeof(int) : 0);
}

template <int D, bool ALIBI, bool DROP, bool SEG, bool V8>
__global__ void __launch_bounds__(F32_THREADS)
attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const void* __restrict__ v, int v_kind, float* __restrict__ o,
                    float* __restrict__ lse, int Hq, int Hkv, int Nq, int Nkv,
                    float sm_scale, int causal, int window, float softcap, Mods md) {
  constexpr int QS = D + 1;   // padded row strides: conflict-free column walks
  constexpr int KS = D + 1;
  constexpr int SS = BN + 1;
  constexpr int OJ = D / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BM * QS;
  float* sV = sK + BN * KS;
  float* sS = sV + BN * D;
  float* sAlpha = sS + BM * SS;
  float* sM = sAlpha + BM;
  float* sL = sM + BM;
  int* sKseg = reinterpret_cast<int*>(sL + BM);  // the K tile's ids (SEG)

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const int q_off = Nkv - Nq;
  const float slope = ALIBI ? md.slopes[h] : 0.f;
  const uint32_t stream = DROP ? dropout_stream(md.seed, b, h) : 0u;

  const float* qb = q + (size_t(b) * Hq + h) * size_t(Nq) * D;
  const size_t kv_base = (size_t(b) * Hkv + kvh) * size_t(Nkv) * D;
  const float* kb = k + kv_base;
  const float* vb = static_cast<const float*>(v) + kv_base;     // fp32 V
  const uint8_t* vb8 = static_cast<const uint8_t*>(v) + kv_base;  // fp8 V

  int qseg[4] = {0, 0, 0, 0};  // segment ids of rows 4*ty + i
  if (SEG) {
#pragma unroll
    for (int i = 0; i < 4; ++i) qseg[i] = seg_id(md.q_seg, b, Nq, m0 + ty * 4 + i);
  }

  for (int idx = tid; idx < BM * D; idx += F32_THREADS) {
    const int r = idx / D, c = idx % D;
    const int row = m0 + r;
    sQ[r * QS + c] = row < Nq ? qb[size_t(row) * D + c] : 0.f;
  }

  // Row state lives with the 4 threads of each row in the softmax phase.
  const int srow = tid / 4;
  const int spart = tid % 4;
  float m_i = -INFINITY;
  float l_i = 0.f;

  float acc[4][OJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) acc[i][j] = 0.f;

  const TileRange tiles = kv_tiles<BM, BN>(m0, Nq, Nkv, causal, window);
  for (int kt = tiles.lo; kt < tiles.hi; ++kt) {
    const int n0 = kt * BN;
    __syncthreads();  // the previous tile's P.V is done with sS / sV
    for (int idx = tid; idx < BN * D; idx += F32_THREADS) {
      const int r = idx / D, c = idx % D;
      const int col = n0 + r;
      const bool in = col < Nkv;
      const size_t at = size_t(col) * D + c;
      sK[r * KS + c] = in ? kb[at] : 0.f;
      sV[r * D + c] = !in ? 0.f : V8 ? fp8_to_float(vb8[at], v_kind) : vb[at];
    }
    if (SEG && tid < BN) sKseg[tid] = seg_id(md.kv_seg, b, Nkv, n0 + tid);
    __syncthreads();

    // S = Q K^T for rows 4*ty+i, columns tx+16*j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * QS + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * KS + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx + 16 * j;
        float x = s[i][j] * sm_scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (ALIBI) x -= slope * float(row + q_off - col);
        const bool vis = visible(row, col, Nq, Nkv, causal, window) &&
                         (!SEG || qseg[i] == sKseg[tx + 16 * j]);
        sS[(ty * 4 + i) * SS + tx + 16 * j] = vis ? x : -INFINITY;
      }
    }
    __syncthreads();

    // Online softmax, 4 threads per row, exact running max.
    {
      float* srow_p = sS + srow * SS;
      float mx = -INFINITY;
#pragma unroll
      for (int c = spart; c < BN; c += 4) mx = fmaxf(mx, srow_p[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m_i - m_use);  // 0 while the row saw nothing
      float sum = 0.f;
#pragma unroll
      for (int c = spart; c < BN; c += 4) {
        const float p = expf(srow_p[c] - m_use);  // masked: exp(-inf) = 0
        sum += p;  // the row sum is undropped
        srow_p[c] = DROP ? p * dropout_factor(stream, m0 + srow, n0 + c, md) : p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_i = l_i * alpha + sum;
      m_i = m_new;
      if (spart == 0) sAlpha[srow] = alpha;
    }
    __syncthreads();

    // O = O * alpha + P V for rows 4*ty+i, columns tx+16*j.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sAlpha[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < OJ; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float p[4], vv[OJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sS[(ty * 4 + i) * SS + c];
#pragma unroll
      for (int j = 0; j < OJ; ++j) vv[j] = sV[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < OJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  __syncthreads();
  if (spart == 0) {
    sM[srow] = m_i;
    sL[srow] = l_i;
    const int row = m0 + srow;
    if (row < Nq) {
      lse[(size_t(b) * Hq + h) * Nq + row] = l_i > 0.f ? m_i + logf(l_i) : kMaskValue;
    }
  }
  __syncthreads();

  float* ob = o + (size_t(b) * Hq + h) * size_t(Nq) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int row = m0 + r;
    if (row >= Nq) continue;
    const float l = sL[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int j = 0; j < OJ; ++j) {
      ob[size_t(row) * D + tx + 16 * j] = acc[i][j] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  int v_kind;
  void* o;
  float* lse;
  int B, Hq, Hkv, Nq, Nkv;
  float sm_scale;
  int causal, window;
  float softcap;
  Mods md;
  cudaStream_t stream;
};

// The routes of the C entry (ops/fwd_kernel.py ROUTE_CODES).
constexpr int kRouteF32 = 0, kRouteWgmma = 1;

// Keys per K / V tile of the "wgmma" route's builds of a head dim, each with
// every mode: 128, and 64 at d 256.  attn_fwd_tiles.cu builds 64-key tiles at
// d 64 and 128 too, mode-free (ops/fwd_kernel.py FWD_TILES).
__host__ __device__ constexpr int key_tile(int D) { return D == 256 ? 64 : 128; }

// The "wgmma" route on tiles of KT keys, defined in attn_fwd_sm90.cuh.
template <bool SEG, typename T, int D, int KT = key_tile(D)>
int launch_wgmma(const Args& a);

// Calls fn(v8) with std::true_type for fp8 V, std::false_type otherwise.
template <typename Fn>
int dispatch_v8(int v_kind, Fn&& fn) {
  return v_kind == kVSame ? fn(std::false_type{}) : fn(std::true_type{});
}

template <bool SEG, int D>
int launch_f32(const Args& a) {
  auto run = [&](auto alibi, auto drop, auto v8) {
    auto kernel = attn_fwd_f32_kernel<D, decltype(alibi)::value, decltype(drop)::value,
                                      SEG, decltype(v8)::value>;
    constexpr size_t smem = f32_smem_bytes<D, SEG>();
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    dim3 grid((a.Nq + BM - 1) / BM, a.B * a.Hq);
    kernel<<<grid, F32_THREADS, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k), a.v,
        a.v_kind, static_cast<float*>(a.o), a.lse, a.Hq, a.Hkv,
        a.Nq, a.Nkv, a.sm_scale, a.causal, a.window, a.softcap, a.md);
    return int(cudaGetLastError());
  };
  return dispatch_mods<SEG>(a.md, [&](auto alibi, auto drop, auto) {
    return dispatch_v8(a.v_kind, [&](auto v8) { return run(alibi, drop, v8); });
  });
}

// The C entry of the forward's builds, one for each head dim DIM (64, 128,
// 256) without (SEG false) and with segment ids: attn_fwd_d64.cu,
// attn_fwd.cu (128), attn_fwd_d256.cu and their *_seg.cu twins, sources of
// their own so that they compile side by side.  D must be DIM.
// dtype: 0 = float32, 1 = bfloat16, 2 = float16, of q, k and O; v_kind 0 =
// V of that type, 1 = float8_e4m3fn, 2 = float8_e5m2.  bf16/fp16/fp8
// pointers must be 16-byte aligned.  q_seg [B, Nq] / kv_seg [B, Nkv] int32
// segment ids on the device: set exactly when SEG (kv_seg is read only
// where keys exist).  slopes: [Hq] fp32 on the device, or null (no ALiBi);
// rate 0 disables dropout, keep_scale = 1 / (1 - rate), seed the int32
// seed.  route: kRouteF32 (dtype 0) or kRouteWgmma (dtype 1 or 2); a
// route that cannot carry the call returns cudaErrorInvalidValue, never
// another route.  Returns cudaGetLastError() after the launch (0 on success);
// launches nothing for an empty problem.  KT: the wgmma route's keys a tile;
// a tile other than the head dim's own (attn_fwd_tiles.cu) takes only the
// wgmma route and no mode.
template <bool SEG, int DIM, int KT = key_tile(DIM)>
int attn_fwd_entry(const void* q, const void* k, const void* v, void* o, float* lse,
                   const int* q_seg, const int* kv_seg, int dtype, int v_kind, int B,
                   int Hq, int Hkv, int Nq, int Nkv, int D, float sm_scale, int causal,
                   int window, float softcap, const float* slopes, float rate,
                   float keep_scale, int seed, int route, void* stream) {
  if (B <= 0 || Hq <= 0 || Nq <= 0) return 0;
  if (D != DIM || Hkv <= 0 || Hq % Hkv != 0 || Nkv < 0 || rate < 0.f || rate >= 1.f ||
      v_kind < kVSame || v_kind > kVE5M2)
    return int(cudaErrorInvalidValue);
  const Args a{q, k, v, v_kind, o, lse, B, Hq, Hkv, Nq, Nkv, sm_scale, causal, window,
               softcap, Mods{slopes, rate, keep_scale, uint32_t(seed), q_seg, kv_seg},
               static_cast<cudaStream_t>(stream)};
  if constexpr (KT == key_tile(DIM)) {
    if (route == kRouteF32 && dtype == 0) return launch_f32<SEG, DIM>(a);
  }
  if (route == kRouteWgmma && dtype == 1) return launch_wgmma<SEG, __nv_bfloat16, DIM, KT>(a);
  if (route == kRouteWgmma && dtype == 2) return launch_wgmma<SEG, __half, DIM, KT>(a);
  return int(cudaErrorInvalidValue);
}

}  // namespace
