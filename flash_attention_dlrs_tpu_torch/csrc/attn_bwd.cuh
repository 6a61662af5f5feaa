// Attention backward (FlashAttention-2 style, deterministic) for Hopper, sm_90a:
// the kernel bodies and the sweeps' C entries, included by six sources that
// compile side by side, one for each head dim without and with segment ids
// (attn_bwd_dkv_entry); attn_bwd.cu also holds the preprocess.
//
// Three kernels, one per C entry point, carry the backward of all six TPU
// backward routes of the JAX package, with their whole feature set:
//   flash_attention_dlrs_tpu/ops/fwd_small.py  _small_bwd_kernel  (one-shot, N <= 320;
//                                                                  segment ids)
//   flash_attention_dlrs_tpu/ops/bwd_kernel.py _bwd_d_kernel      (D preprocess)
//   flash_attention_dlrs_tpu/ops/bwd_kernel.py _bwd_dkv_kernel    (dK/dV sweep; ALiBi,
//                                                                  dropout, segment ids)
//   flash_attention_dlrs_tpu/ops/bwd_kernel.py _bwd_dq_kernel     (dQ sweep; ALiBi,
//                                                                  dropout, segment ids)
//   flash_attention_dlrs_tpu/ops/bwd_fused.py  _bwd_fused_kernel  (single sweep, pane dQ;
//                                                                  ALiBi, dropout, segment ids)
//   flash_attention_dlrs_tpu/ops/bwd_mid.py    _bwd_mid_kernel    (causal pane, N <= 2048)
// The TPU split the function by length for its grid-step overhead and the
// VMEM ceiling of a pane-resident dQ (the fused route ran per Q segment
// beyond 8K); neither limit exists here, and one two-sweep family takes
// every length.
//
//   attn_bwd_preprocess: D = rowsum(O * dO) in fp32, [B, Hq, Nq], from the
//     stored O (as bwd_fused.py does).
//   attn_bwd_dkv: one CTA per (batch, KV head, key tile).  It walks the q
//     heads of its GQA group and, in a fixed order, the q tiles that see
//     the tile (from the causal diagonal on, only inside the window band),
//     recomputes P = exp(scale * S (softcapped) - lse) and
//     dS = P * (dP - D) (* the softcap's 1 - (S_c / cap)^2), and keeps
//     dV += P^T dO and dK += dS^T Q in fp32 registers.  dK (times sm_scale)
//     and dV are written once per KV head: no per-q-head fp32 intermediate
//     and no group-sum pass.
//   attn_bwd_dq: one CTA per (batch, q head, row tile), walking the KV
//     tiles it sees in order; dQ += dS K in fp32 registers, times sm_scale
//     at the end.
// Every sum runs in a fixed order and every output element has one owner,
// so the result is bitwise reproducible: there is no atomicAdd anywhere
// (the reference's first-call dQ race lived in its atomic/lock reduction).
//
// Each sweep's C entry takes one of two routes (ops/bwd_kernel.py
// bwd_route, from the call's types alone): "wgmma", the Hopper kernels of
// attn_bwd_sm90.cuh (warpgroup products, TMA, a producer warpgroup; every
// bf16 / fp16 call, 128-key / 128-row CTAs, 64-row steps), or "fp32", the
// CUDA-core kernels below (true fp32; 64-key / 64-row CTAs).
//
// Conventions are the forward's (attn_fwd.cu): q [B, Hq, Nq, d], k/v
// [B, Hkv, Nkv, d], o/dO like q, lse the natural-base logsumexp [B, Hq, Nq]
// fp32, causal aligned bottom-right, any Nq/Nkv, ALiBi as the true bias
// -m_h * (q_pos - col) after the softcap (the passed lse is the true one and
// is taken as it is), dropout as the forward's counter-based mask.  With
// dropout M (0 or 1 / (1 - rate)) the sweeps compute dV += (P o M)^T dO and
// dS = P o (M o dP - D) (JAX bwd_kernel.py); D = rowsum(dO o O) needs no
// mask, so the preprocess is unchanged.  The mask is regenerated from the
// seed, the batch, the Q head (attn_bwd_dkv walks the q heads of its group
// and hashes each), the local q row and the column, so it is the forward's
// bit for bit.  Segment ids add q_seg[b, row] == kv_seg[b, col] to the mask
// (D needs none).  With segments every tile evaluates the mask
// (tile_unmasked is off) and no tile is skipped by segment (ids are
// arbitrary integers).  The three modes are template flags (common.cuh
// dispatch_mods): a call without them runs code compiled without them.  A
// row that saw no key (a cross-length causal top, or a segment id absent
// from the keys, mid-sequence) has lse = kMaskValue (-inf in base-2 units);
// every score it has is masked, and its P is set to 0 before any exponent
// is taken, so no inf or NaN can arise.
//
// Bound on this card.  At the training shape (causal, N = 2048, d = 128)
// the backward is bound by operations: the five products of the minimal
// backward, 10 * N^2 * d / 2 flops per head, against ~(6 N d) * 2 bytes.
// These kernels do seven products (S and dP are computed in both sweeps),
// the price of having no atomics and no fp32 dQ round trip through device
// memory.  bf16 / fp16 run every product on the tensor cores
// (attn_bwd_sm90.cuh); fp32 inputs compute in true fp32 on the CUDA cores
// (the fp32 gradient ladder is atol 9e-4 / 7e-4 / 7e-5), with 256 threads
// each owning a 4 x 4 patch of the score tile and a 4 x d/16 patch of the
// output.  Causal and window tile ranges skip tiles that see nothing, and
// only tiles that cross an edge evaluate the mask.

#pragma once

#include "common.cuh"

namespace {

// The fp32 sweeps' tiles (the bf16 / fp16 sweeps' are attn_bwd_sm90.cuh's):
// 64-key (dK/dV) and 64-row (dQ) CTAs walking steps of 64 streamed rows (q
// rows in dK/dV, keys in dQ), 32 at d 256, where the four staged fp32 tiles
// would not fit a CTA's shared memory at 64 (263 KB).
constexpr int KV_TILE = 64;  // dkv: keys per CTA
constexpr int Q_TILE = 64;   // dq: q rows per CTA
__host__ __device__ constexpr int f32_step(int D) { return D == 256 ? 32 : 64; }

// The score of one (row, col) pair from its raw product: scaled, softcapped.
// `dcap` gets the softcap's derivative 1 - (S_c / cap)^2 (1 without one).
__device__ __forceinline__ float score(float s, float sm_scale, float softcap,
                                       float& dcap) {
  float x = s * sm_scale;
  dcap = 1.f;
  if (softcap > 0.f) {
    x = softcap * tanhf(x / softcap);
    const float r = x / softcap;
    dcap = 1.f - r * r;
  }
  return x;
}

// ---------------------------------------------------------------------------
// fp32 path (CUDA cores, true fp32)
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;  // 16 x 16

// rows [r0, r0 + ROWS) of a [N, D] fp32 matrix into a [ROWS][D+1] tile, zero
// past N
template <int D, int ROWS = 64>
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int r0, int N,
                                          int tid) {
  for (int idx = tid; idx < ROWS * D; idx += F32_THREADS) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] = r0 + r < N ? src[size_t(r0 + r) * D + c] : 0.f;
  }
}

template <int D, bool SEG>
constexpr size_t dkv_f32_smem_bytes() {
  // sK, sV [64][D+1]; sQ, sdO [STEP][D+1]; sP, sDS [64][STEP+1]; lse, D
  // [STEP]; with segments the q step's ids [STEP]
  constexpr size_t STEP = f32_step(D);
  return sizeof(float) * (2 * 64 * size_t(D + 1) + 2 * STEP * (D + 1) + 2 * 64 * (STEP + 1) +
                          2 * STEP) +
         (SEG ? STEP * sizeof(int) : 0);
}

template <int D, bool ALIBI, bool DROP, bool SEG>
__global__ void __launch_bounds__(F32_THREADS)
attn_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv, int Hq, int Hkv,
                        int Nq, int Nkv, float sm_scale, int causal, int window,
                        float softcap, Mods md) {
  static_assert(KV_TILE == 64, "the fp32 dK/dV CTA holds 64 keys");
  constexpr int STEP = f32_step(D);  // q rows per step
  constexpr int JS = STEP / 16;      // q rows per thread in a step
  constexpr int PS = D + 1;   // padded strides: conflict-free column walks
  constexpr int SS = STEP + 1;
  constexpr int OJ = D / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + 64 * PS;
  float* sQ = sV + 64 * PS;
  float* sdO = sQ + STEP * PS;
  float* sP = sdO + STEP * PS;  // P^T [key][row]
  float* sDS = sP + 64 * SS;    // dS^T [key][row]
  float* sLse = sDS + 64 * SS;
  float* sDelta = sLse + STEP;
  int* sQseg = reinterpret_cast<int*>(sDelta + STEP);  // the q step's ids (SEG)

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * KV_TILE;
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;
  const int group = Hq / Hkv;
  int kseg[4] = {0, 0, 0, 0};  // segment ids of keys 4*ty + i
  if (SEG) {
#pragma unroll
    for (int i = 0; i < 4; ++i) kseg[i] = seg_id(md.kv_seg, b, Nkv, n0 + ty * 4 + i);
  }

  stage_f32<D>(sK, k + (size_t(b) * Hkv + kvh) * size_t(Nkv) * D, n0, Nkv, tid);
  stage_f32<D>(sV, v + (size_t(b) * Hkv + kvh) * size_t(Nkv) * D, n0, Nkv, tid);

  // keys 4*ty + i, output columns tx + 16*j
  float dk_acc[4][OJ], dv_acc[4][OJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const TileRange steps = q_tiles<STEP, KV_TILE>(n0, Nq, Nkv, causal, window);
  const int q_off = Nkv - Nq;
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;  // the q head: its slope and dropout stream
    const float slope = ALIBI ? md.slopes[h] : 0.f;
    const uint32_t stream = DROP ? dropout_stream(md.seed, b, h) : 0u;
    const size_t bh = size_t(b) * Hq + h;
    for (int it = steps.lo; it < steps.hi; ++it) {
      const int m0 = it * STEP;
      __syncthreads();
      stage_f32<D, STEP>(sQ, q + bh * Nq * D, m0, Nq, tid);
      stage_f32<D, STEP>(sdO, dout + bh * Nq * D, m0, Nq, tid);
      if (tid < STEP) {
        const int row = m0 + tid;
        sLse[tid] = row < Nq ? lse[bh * Nq + row] : 0.f;
        sDelta[tid] = row < Nq ? delta[bh * Nq + row] : 0.f;
        if (SEG) sQseg[tid] = seg_id(md.q_seg, b, Nq, row);
      }
      __syncthreads();

      // S^T and dP^T for keys 4*ty + i, rows tx + 16*j
      float s[4][JS], dp[4][JS];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JS; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        float kv[4], vv[4], qv[JS], ov[JS];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = sK[(ty * 4 + i) * PS + c];
          vv[i] = sV[(ty * 4 + i) * PS + c];
        }
#pragma unroll
        for (int j = 0; j < JS; ++j) {
          qv[j] = sQ[(tx + 16 * j) * PS + c];
          ov[j] = sdO[(tx + 16 * j) * PS + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < JS; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < JS; ++j) {
          const int r = tx + 16 * j;
          const int row = m0 + r, col = n0 + ty * 4 + i;
          float dcap;
          float x = score(s[i][j], sm_scale, softcap, dcap);
          if (ALIBI) x -= slope * float(row + q_off - col);
          const bool vis = visible(row, col, Nq, Nkv, causal, window) &&
                           (!SEG || kseg[i] == sQseg[r]);
          const float p = vis ? expf(x - sLse[r]) : 0.f;
          if (DROP) {
            const float keep = dropout_factor(stream, row, col, md);
            sP[(ty * 4 + i) * SS + r] = p * keep;
            sDS[(ty * 4 + i) * SS + r] = p * (dp[i][j] * keep - sDelta[r]) * dcap;
          } else {
            sP[(ty * 4 + i) * SS + r] = p;
            sDS[(ty * 4 + i) * SS + r] = p * (dp[i][j] - sDelta[r]) * dcap;
          }
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < STEP; ++c) {
        float p[4], ds[4], ov[OJ], qv[OJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = sP[(ty * 4 + i) * SS + c];
          ds[i] = sDS[(ty * 4 + i) * SS + c];
        }
#pragma unroll
        for (int j = 0; j < OJ; ++j) {
          ov[j] = sdO[c * PS + tx + 16 * j];
          qv[j] = sQ[c * PS + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < OJ; ++j) {
            dv_acc[i][j] = fmaf(p[i], ov[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(ds[i], qv[j], dk_acc[i][j]);
          }
      }
    }
  }

  const size_t base = (size_t(b) * Hkv + kvh) * size_t(Nkv) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = n0 + ty * 4 + i;
    if (row >= Nkv) continue;
#pragma unroll
    for (int j = 0; j < OJ; ++j) {
      dk[base + size_t(row) * D + tx + 16 * j] = dk_acc[i][j] * sm_scale;
      dv[base + size_t(row) * D + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

template <int D, bool SEG>
constexpr size_t dq_f32_smem_bytes() {
  // sQ, sdO [64][D+1]; sK, sV [STEP][D+1]; sDS [64][STEP+1]; lse, D [64];
  // with segments the K tile's ids [STEP]
  constexpr size_t STEP = f32_step(D);
  return sizeof(float) * (2 * 64 * size_t(D + 1) + 2 * STEP * (D + 1) + 64 * (STEP + 1) +
                          2 * 64) +
         (SEG ? STEP * sizeof(int) : 0);
}

template <int D, bool ALIBI, bool DROP, bool SEG>
__global__ void __launch_bounds__(F32_THREADS)
attn_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, int Hq, int Hkv, int Nq, int Nkv,
                       float sm_scale, int causal, int window, float softcap,
                       Mods md) {
  static_assert(Q_TILE == 64, "the fp32 dQ CTA holds 64 q rows");
  constexpr int STEP = f32_step(D);  // keys per step
  constexpr int JS = STEP / 16;      // keys per thread in a step
  constexpr int PS = D + 1;
  constexpr int SS = STEP + 1;
  constexpr int OJ = D / 16;

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + 64 * PS;
  float* sK = sdO + 64 * PS;
  float* sV = sK + STEP * PS;
  float* sDS = sV + STEP * PS;
  float* sLse = sDS + 64 * SS;
  float* sDelta = sLse + 64;
  int* sKseg = reinterpret_cast<int*>(sDelta + 64);  // the K tile's ids (SEG)

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * Q_TILE;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq;
  const int kvh = h / (Hq / Hkv);
  const size_t bh = size_t(b) * Hq + h;
  const int q_off = Nkv - Nq;
  const float slope = ALIBI ? md.slopes[h] : 0.f;
  const uint32_t stream = DROP ? dropout_stream(md.seed, b, h) : 0u;
  const float* kb = k + (size_t(b) * Hkv + kvh) * size_t(Nkv) * D;
  const float* vb = v + (size_t(b) * Hkv + kvh) * size_t(Nkv) * D;
  int qseg[4] = {0, 0, 0, 0};  // segment ids of rows 4*ty + i
  if (SEG) {
#pragma unroll
    for (int i = 0; i < 4; ++i) qseg[i] = seg_id(md.q_seg, b, Nq, m0 + ty * 4 + i);
  }

  stage_f32<D>(sQ, q + bh * Nq * D, m0, Nq, tid);
  stage_f32<D>(sdO, dout + bh * Nq * D, m0, Nq, tid);
  if (tid < 64) {
    const int row = m0 + tid;
    sLse[tid] = row < Nq ? lse[bh * Nq + row] : 0.f;
    sDelta[tid] = row < Nq ? delta[bh * Nq + row] : 0.f;
  }

  // rows 4*ty + i, output columns tx + 16*j
  float acc[4][OJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) acc[i][j] = 0.f;

  const TileRange tiles = kv_tiles<Q_TILE, STEP>(m0, Nq, Nkv, causal, window);
  for (int kt = tiles.lo; kt < tiles.hi; ++kt) {
    const int n0 = kt * STEP;
    __syncthreads();  // the previous tile's dS K is done with sDS / sK
    stage_f32<D, STEP>(sK, kb, n0, Nkv, tid);
    stage_f32<D, STEP>(sV, vb, n0, Nkv, tid);
    if (SEG && tid < STEP) sKseg[tid] = seg_id(md.kv_seg, b, Nkv, n0 + tid);
    __syncthreads();

    // S and dP for rows 4*ty + i, keys tx + 16*j
    float s[4][JS], dp[4][JS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JS; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[4], ov[4], kv[JS], vv[JS];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty * 4 + i) * PS + c];
        ov[i] = sdO[(ty * 4 + i) * PS + c];
      }
#pragma unroll
      for (int j = 0; j < JS; ++j) {
        kv[j] = sK[(tx + 16 * j) * PS + c];
        vv[j] = sV[(tx + 16 * j) * PS + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JS; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < JS; ++j) {
        const int row = m0 + r, col = n0 + tx + 16 * j;
        float dcap;
        float x = score(s[i][j], sm_scale, softcap, dcap);
        if (ALIBI) x -= slope * float(row + q_off - col);
        const bool vis = visible(row, col, Nq, Nkv, causal, window) &&
                         (!SEG || qseg[i] == sKseg[tx + 16 * j]);
        const float p = vis ? expf(x - sLse[r]) : 0.f;
        const float dpk = DROP ? dp[i][j] * dropout_factor(stream, row, col, md) : dp[i][j];
        sDS[r * SS + tx + 16 * j] = p * (dpk - sDelta[r]) * dcap;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < STEP; ++c) {
      float ds[4], kv[OJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sDS[(ty * 4 + i) * SS + c];
#pragma unroll
      for (int j = 0; j < OJ; ++j) kv[j] = sK[c * PS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < OJ; ++j) acc[i][j] = fmaf(ds[i], kv[j], acc[i][j]);
    }
  }

  float* dqb = dq + bh * Nq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= Nq) continue;
#pragma unroll
    for (int j = 0; j < OJ; ++j) dqb[size_t(row) * D + tx + 16 * j] = acc[i][j] * sm_scale;
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, Hq, Hkv, Nq, Nkv;
  float sm_scale;
  int causal, window;
  float softcap;
  Mods md;
  cudaStream_t stream;
};

template <typename Kernel, typename... P>
int launch(Kernel kernel, size_t smem, dim3 grid, int threads, cudaStream_t stream,
           P... params) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, threads, smem, stream>>>(params...);
  return int(cudaGetLastError());
}

// The routes of the sweeps' C entries (ops/bwd_kernel.py ROUTE_CODES).
constexpr int kRouteF32 = 0, kRouteWgmma = 1;

// Rows streamed a stage by the "wgmma" route's builds of a head dim (q rows
// in dK/dV, keys in dQ; `dkv` names the sweep), each with every mode: 64,
// and 32 in the d 256 dQ sweep.  attn_bwd_tiles.cu builds 32-row stages at
// d 64 and 128 too, mode-free, for both sweeps (ops/bwd_kernel.py
// BWD_TILES).
__host__ __device__ constexpr int stream_tile(int D, bool dkv) {
  return D == 256 && !dkv ? 32 : 64;
}

// The "wgmma" route streaming ST rows a stage, defined in attn_bwd_sm90.cuh.
template <bool SEG, typename T, int D, int ST = stream_tile(D, true)>
int launch_dkv_wgmma(const Args& a, void* dk, void* dv);
template <bool SEG, typename T, int D, int ST = stream_tile(D, false)>
int launch_dq_wgmma(const Args& a, void* dq);

template <bool SEG, int D>
int launch_dkv_f32(const Args& a, void* dk, void* dv) {
  return dispatch_mods<SEG>(a.md, [&](auto alibi, auto drop, auto) {
    return launch(attn_bwd_dkv_f32_kernel<D, decltype(alibi)::value, decltype(drop)::value,
                                          SEG>,
                  dkv_f32_smem_bytes<D, SEG>(), dim3((a.Nkv + KV_TILE - 1) / KV_TILE,
                                                     a.B * a.Hkv),
                  F32_THREADS, a.stream, static_cast<const float*>(a.q),
                  static_cast<const float*>(a.k), static_cast<const float*>(a.v),
                  static_cast<const float*>(a.dout), a.lse, a.delta,
                  static_cast<float*>(dk), static_cast<float*>(dv), a.Hq, a.Hkv, a.Nq,
                  a.Nkv, a.sm_scale, a.causal, a.window, a.softcap, a.md);
  });
}

template <bool SEG, int D>
int launch_dq_f32(const Args& a, void* dq) {
  return dispatch_mods<SEG>(a.md, [&](auto alibi, auto drop, auto) {
    return launch(attn_bwd_dq_f32_kernel<D, decltype(alibi)::value, decltype(drop)::value,
                                         SEG>,
                  dq_f32_smem_bytes<D, SEG>(), dim3((a.Nq + Q_TILE - 1) / Q_TILE, a.B * a.Hq),
                  F32_THREADS, a.stream, static_cast<const float*>(a.q),
                  static_cast<const float*>(a.k), static_cast<const float*>(a.v),
                  static_cast<const float*>(a.dout), a.lse, a.delta,
                  static_cast<float*>(dq), a.Hq, a.Hkv, a.Nq, a.Nkv, a.sm_scale, a.causal,
                  a.window, a.softcap, a.md);
  });
}

bool valid(int B, int Hq, int Hkv, int Nq, int Nkv, float rate) {
  return B > 0 && Hq > 0 && Hkv > 0 && Hq % Hkv == 0 && Nq > 0 && Nkv > 0 &&
         rate >= 0.f && rate < 1.f;
}

// The sweeps' C entries of the backward's builds, one for each head dim
// DIM (64, 128, 256) without (SEG false) and with segment ids:
// attn_bwd_d64.cu, attn_bwd.cu (128, and the preprocess), attn_bwd_d256.cu
// and their *_seg.cu twins, sources of their own so that they compile side
// by side.  D must be DIM; every mode at every head dim.  dtype 0 = float32,
// 1 = bfloat16, 2 = float16; tensors contiguous, bf16/fp16 pointers 16-byte
// aligned.
// The sweeps take the forward's ALiBi slopes ([Hq] fp32 on the device, or
// null), dropout rate, keep scale 1 / (1 - rate) and seed, and its q_seg
// [B, Nq] / kv_seg [B, Nkv] int32 segment ids (set exactly when SEG).
// route: kRouteF32 (dtype 0) or kRouteWgmma (dtype 1 or 2); a route or a
// build that cannot carry the call returns cudaErrorInvalidValue, never
// another route.  Each returns cudaGetLastError() after its launch (0 on
// success).

// ST: the wgmma route's rows streamed a stage; a size other than the
// sweep's own at the head dim (attn_bwd_tiles.cu) takes only the wgmma route
// and no mode.

// dK, dV [B, Hkv, Nkv, d] from q, k, v, dout, lse and delta.
template <bool SEG, int DIM, int ST = stream_tile(DIM, true)>
int attn_bwd_dkv_entry(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv,
                       const int* q_seg, const int* kv_seg, int dtype, int B, int Hq,
                       int Hkv, int Nq, int Nkv, int D, float sm_scale, int causal,
                       int window, float softcap, const float* slopes, float rate,
                       float keep_scale, int seed, int route, void* stream) {
  if (D != DIM || !valid(B, Hq, Hkv, Nq, Nkv, rate)) return int(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, lse, delta, B, Hq, Hkv, Nq, Nkv, sm_scale, causal, window,
               softcap, Mods{slopes, rate, keep_scale, uint32_t(seed), q_seg, kv_seg},
               static_cast<cudaStream_t>(stream)};
  if constexpr (ST == stream_tile(DIM, true)) {
    if (route == kRouteF32 && dtype == 0) return launch_dkv_f32<SEG, DIM>(a, dk, dv);
  }
  if (route == kRouteWgmma && dtype == 1)
    return launch_dkv_wgmma<SEG, __nv_bfloat16, DIM, ST>(a, dk, dv);
  if (route == kRouteWgmma && dtype == 2)
    return launch_dkv_wgmma<SEG, __half, DIM, ST>(a, dk, dv);
  return int(cudaErrorInvalidValue);
}

// dQ [B, Hq, Nq, d] from q, k, v, dout, lse and delta.
template <bool SEG, int DIM, int ST = stream_tile(DIM, false)>
int attn_bwd_dq_entry(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, const int* q_seg,
                      const int* kv_seg, int dtype, int B, int Hq, int Hkv, int Nq,
                      int Nkv, int D, float sm_scale, int causal, int window,
                      float softcap, const float* slopes, float rate, float keep_scale,
                      int seed, int route, void* stream) {
  if (D != DIM || !valid(B, Hq, Hkv, Nq, Nkv, rate)) return int(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, lse, delta, B, Hq, Hkv, Nq, Nkv, sm_scale, causal, window,
               softcap, Mods{slopes, rate, keep_scale, uint32_t(seed), q_seg, kv_seg},
               static_cast<cudaStream_t>(stream)};
  if constexpr (ST == stream_tile(DIM, false)) {
    if (route == kRouteF32 && dtype == 0) return launch_dq_f32<SEG, DIM>(a, dq);
  }
  if (route == kRouteWgmma && dtype == 1)
    return launch_dq_wgmma<SEG, __nv_bfloat16, DIM, ST>(a, dq);
  if (route == kRouteWgmma && dtype == 2) return launch_dq_wgmma<SEG, __half, DIM, ST>(a, dq);
  return int(cudaErrorInvalidValue);
}

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // namespace
