// Attention backward (FlashAttention-2 style, deterministic) for Hopper, sm_90a.
//
// Three kernels, one per C entry point, carry the backward of all six TPU
// backward routes of the JAX package:
//   flash_attention_dlrs_tpu/ops/fwd_small.py  _small_bwd_kernel  (one-shot, N <= 320)
//   flash_attention_dlrs_tpu/ops/bwd_kernel.py _bwd_d_kernel      (D preprocess)
//   flash_attention_dlrs_tpu/ops/bwd_kernel.py _bwd_dkv_kernel    (dK/dV sweep)
//   flash_attention_dlrs_tpu/ops/bwd_kernel.py _bwd_dq_kernel     (dQ sweep)
//   flash_attention_dlrs_tpu/ops/bwd_fused.py  _bwd_fused_kernel  (single sweep, pane dQ)
//   flash_attention_dlrs_tpu/ops/bwd_mid.py    _bwd_mid_kernel    (causal pane, N <= 2048)
// The TPU split the function by length for its grid-step overhead and the
// VMEM ceiling of a pane-resident dQ (the fused route ran per Q segment
// beyond 8K); neither limit exists here, and one two-sweep family takes
// every length.
//
//   attn_bwd_preprocess: D = rowsum(O * dO) in fp32, [B, Hq, Nq], from the
//     stored O (as bwd_fused.py does).
//   attn_bwd_dkv: one CTA per (batch, KV head, 64-key tile).  It walks the
//     q heads of its GQA group and, in a fixed order, the q tiles that see
//     the tile (from the causal diagonal on, only inside the window band),
//     recomputes P = exp(scale * S (softcapped) - lse) and
//     dS = P * (dP - D) (* the softcap's 1 - (S_c / cap)^2), and keeps
//     dV += P^T dO and dK += dS^T Q in fp32 registers.  dK (times sm_scale)
//     and dV are written once per KV head: no per-q-head fp32 intermediate
//     and no group-sum pass.
//   attn_bwd_dq: one CTA per (batch, q head, 64-row tile), walking the KV
//     tiles it sees in order; dQ += dS K in fp32 registers, times sm_scale
//     at the end.
// Every sum runs in a fixed order and every output element has one owner,
// so the result is bitwise reproducible: there is no atomicAdd anywhere
// (the reference's first-call dQ race lived in its atomic/lock reduction).
//
// Conventions are the forward's (attn_fwd.cu): q [B, Hq, Nq, d], k/v
// [B, Hkv, Nkv, d], o/dO like q, lse the natural-base logsumexp [B, Hq, Nq]
// fp32, causal aligned bottom-right, any Nq/Nkv.  A row that saw no key has
// lse = kMaskValue; every score it has is masked, and its P is set to 0
// before any exponent is taken, so no inf or NaN can arise.
//
// Bound on this card.  At the training shape (causal, N = 2048, d = 128)
// the backward is bound by operations: the five products of the minimal
// backward, 10 * N^2 * d / 2 flops per head, against ~(6 N d) * 2 bytes.
// These kernels do seven products (S and dP are computed in both sweeps),
// the price of having no atomics and no fp32 dQ round trip through device
// memory.  What the design does about the bound:
//  * bf16/fp16 run every product on the tensor cores with mma.sync.m16n8k16
//    (fp32 accumulate), fragments loaded with ldmatrix from padded
//    (conflict-free) shared tiles; P and dS are rounded to the input type
//    before they enter a product, as the TPU kernels do.  No async copy,
//    wgmma or TMA yet: the synchronous tile loads keep this well above the
//    floor (ROADMAP queue 2).
//  * fp32 inputs compute in true fp32 on the CUDA cores (the fp32 gradient
//    ladder is atol 9e-4 / 7e-4 / 7e-5), with 256 threads each owning a
//    4 x 4 patch of the score tile and a 4 x d/16 patch of the output.
//  * causal and window tile ranges skip tiles that see nothing, and only
//    tiles that cross an edge evaluate the mask.

#include "common.cuh"

namespace {

constexpr int KV_TILE = 64;  // dkv: keys per CTA; dq: keys per step
constexpr int Q_TILE = 64;   // dq: q rows per CTA
constexpr int Q_STEP = 32;   // dkv (tensor cores): q rows per step
constexpr int F32_Q_STEP = 64;  // dkv (fp32): q rows per step

// q tiles of STEP rows that see keys [n0, n0 + KV_TILE): the transpose of
// kv_tiles.  Causal: rows from the diagonal on (row + Nkv - Nq >= n0);
// window: rows whose band still reaches the tile's last key.
template <int STEP>
__device__ __forceinline__ TileRange q_tiles(int n0, int Nq, int Nkv, int causal,
                                             int window) {
  const int q_off = Nkv - Nq;
  int row_lo = 0, row_hi = Nq;
  if (causal) {
    row_lo = max(0, n0 - q_off);
    if (window > 0) row_hi = min(Nq, n0 + KV_TILE - 1 - q_off + window);
  }
  if (row_lo >= row_hi) return {0, 0};
  return {row_lo / STEP, (row_hi + STEP - 1) / STEP};
}

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
// D = rowsum(O * dO)
// ---------------------------------------------------------------------------

constexpr int PRE_THREADS = 256;  // one warp per row

template <typename T>
__global__ void __launch_bounds__(PRE_THREADS)
attn_bwd_preprocess_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ delta, int rows, int D) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (PRE_THREADS / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const T* op = o + size_t(row) * D;
  const T* dp = dout + size_t(row) * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_float(op[c]), to_float(dp[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// Tensor-core path (bf16 / fp16)
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;  // 4 warps x 16 rows

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  // sK, sV [KV_TILE][D+8], sQ, sdO [Q_STEP][D+8] of 16-bit elements; lse, D
  return size_t(2) * (2 * KV_TILE + 2 * Q_STEP) * (D + 8) + 2 * Q_STEP * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS)
attn_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv,
                        int Nq, int Nkv, float sm_scale, int causal, int window,
                        float softcap) {
  constexpr int S = D + 8;           // padded row stride: conflict-free ldmatrix
  constexpr int KSTEPS = D / 16;     // k-steps of the score products
  constexpr int NT_S = Q_STEP / 8;   // S^T n-tiles per warp
  constexpr int NT_O = D / 8;        // dK / dV n-tiles per warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + KV_TILE * S;
  T* sQ = sV + KV_TILE * S;
  T* sdO = sQ + Q_STEP * S;
  float* sLse = reinterpret_cast<float*>(sdO + Q_STEP * S);  // base-2 units
  float* sDelta = sLse + Q_STEP;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group / column pair
  const int n0 = blockIdx.x * KV_TILE;   // causal: the first key tiles carry the most work
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;
  const int group = Hq / Hkv;

  const T* kb = k + (size_t(b) * Hkv + kvh) * size_t(Nkv) * D;
  const T* vb = v + (size_t(b) * Hkv + kvh) * size_t(Nkv) * D;
  stage_tile<T, D, S, KV_TILE, TC_THREADS>(sK, kb, n0, Nkv, tid);
  stage_tile<T, D, S, KV_TILE, TC_THREADS>(sV, vb, n0, Nkv, tid);

  float dk_acc[NT_O][4], dv_acc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  const TileRange steps = q_tiles<Q_STEP>(n0, Nq, Nkv, causal, window);
  for (int hh = 0; hh < group; ++hh) {
    const size_t bh = size_t(b) * Hq + kvh * group + hh;
    const T* qb = q + bh * Nq * D;
    const T* dob = dout + bh * Nq * D;
    for (int it = steps.lo; it < steps.hi; ++it) {
      const int m0 = it * Q_STEP;
      __syncthreads();  // every warp is done with the previous q tile
      stage_tile<T, D, S, Q_STEP, TC_THREADS>(sQ, qb, m0, Nq, tid);
      stage_tile<T, D, S, Q_STEP, TC_THREADS>(sdO, dob, m0, Nq, tid);
      if (tid < Q_STEP) {
        // rows past Nq: Q = dO = 0 and lse = D = 0, so P is finite and
        // both products they enter are 0
        const int row = m0 + tid;
        sLse[tid] = row < Nq ? lse[bh * Nq + row] * kLog2e : 0.f;
        sDelta[tid] = row < Nq ? delta[bh * Nq + row] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x Q_STEP rows
      float s[NT_S][4], dp[NT_S][4];
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, a_frag<S>(sK, warp * 16, ks * 16, lane));
        ldsm_x4(va, a_frag<S>(sV, warp * 16, ks * 16, lane));
#pragma unroll
        for (int np = 0; np < NT_S / 2; ++np) {
          uint32_t qf[4], of[4];
          ldsm_x4(qf, b_frag<S>(sQ, np * 16, ks * 16, lane));
          ldsm_x4(of, b_frag<S>(sdO, np * 16, ks * 16, lane));
          Mma<T>::run(s[2 * np], ka, qf[0], qf[1]);
          Mma<T>::run(s[2 * np + 1], ka, qf[2], qf[3]);
          Mma<T>::run(dp[2 * np], va, of[0], of[1]);
          Mma<T>::run(dp[2 * np + 1], va, of[2], of[3]);
        }
      }

      // P^T and dS^T: element e of n-tile j is key warp*16 + g (+8 for
      // e >= 2), q row j*8 + 2t + (e & 1)
      const bool unmasked = tile_unmasked<Q_STEP, KV_TILE>(m0, n0, Nq, Nkv, causal, window);
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = j * 8 + 2 * t + (e & 1);
          float dcap;
          const float x = score(s[j][e], sm_scale, softcap, dcap);
          const bool vis = unmasked || visible(m0 + r, n0 + warp * 16 + g + (e >= 2 ? 8 : 0),
                                               Nq, Nkv, causal, window);
          const float p = vis ? exp2f(x * kLog2e - sLse[r]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - sDelta[r]) * dcap;
        }
      }

      // dV += P^T dO, dK += dS^T Q over the step's q rows
#pragma unroll
      for (int kk = 0; kk < Q_STEP / 16; ++kk) {
        const uint32_t pa[4] = {
            Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
            Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
            Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]),
        };
        const uint32_t da[4] = {
            Mma<T>::pack(dp[2 * kk][0], dp[2 * kk][1]),
            Mma<T>::pack(dp[2 * kk][2], dp[2 * kk][3]),
            Mma<T>::pack(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
            Mma<T>::pack(dp[2 * kk + 1][2], dp[2 * kk + 1][3]),
        };
#pragma unroll
        for (int np = 0; np < NT_O / 2; ++np) {
          uint32_t of[4], qf[4];
          ldsm_x4_trans(of, bt_frag<S>(sdO, kk * 16, np * 16, lane));
          ldsm_x4_trans(qf, bt_frag<S>(sQ, kk * 16, np * 16, lane));
          Mma<T>::run(dv_acc[2 * np], pa, of[0], of[1]);
          Mma<T>::run(dv_acc[2 * np + 1], pa, of[2], of[3]);
          Mma<T>::run(dk_acc[2 * np], da, qf[0], qf[1]);
          Mma<T>::run(dk_acc[2 * np + 1], da, qf[2], qf[3]);
        }
      }
    }
  }

  const size_t base = (size_t(b) * Hkv + kvh) * size_t(Nkv) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = n0 + warp * 16 + g + 8 * r;
    if (row >= Nkv) continue;
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      const size_t at = base + size_t(row) * D + j * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dk + at) =
          Mma<T>::pack(dk_acc[j][2 * r] * sm_scale, dk_acc[j][2 * r + 1] * sm_scale);
      *reinterpret_cast<uint32_t*>(dv + at) =
          Mma<T>::pack(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
}

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  return size_t(2) * (2 * Q_TILE + 2 * KV_TILE) * (D + 8);  // sQ, sdO, sK, sV
}

template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS)
attn_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       T* __restrict__ dq, int Hq, int Hkv, int Nq, int Nkv,
                       float sm_scale, int causal, int window, float softcap) {
  constexpr int S = D + 8;
  constexpr int KSTEPS = D / 16;
  constexpr int NT_S = KV_TILE / 8;  // S n-tiles per warp
  constexpr int NT_O = D / 8;        // dQ n-tiles per warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + Q_TILE * S;
  T* sK = sdO + Q_TILE * S;
  T* sV = sK + KV_TILE * S;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * Q_TILE;  // heaviest causal tiles first
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq;
  const int kvh = h / (Hq / Hkv);
  const size_t bh = size_t(b) * Hq + h;

  const T* kb = k + (size_t(b) * Hkv + kvh) * size_t(Nkv) * D;
  const T* vb = v + (size_t(b) * Hkv + kvh) * size_t(Nkv) * D;
  stage_tile<T, D, S, Q_TILE, TC_THREADS>(sQ, q + bh * Nq * D, m0, Nq, tid);
  stage_tile<T, D, S, Q_TILE, TC_THREADS>(sdO, dout + bh * Nq * D, m0, Nq, tid);

  float lse2[2], dlt[2];  // this thread's rows g and g + 8 (0 past Nq)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + g + 8 * r;
    lse2[r] = row < Nq ? lse[bh * Nq + row] * kLog2e : 0.f;
    dlt[r] = row < Nq ? delta[bh * Nq + row] : 0.f;
  }

  float acc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const TileRange tiles = kv_tiles<Q_TILE, KV_TILE>(m0, Nq, Nkv, causal, window);
  for (int kt = tiles.lo; kt < tiles.hi; ++kt) {
    const int n0 = kt * KV_TILE;
    __syncthreads();  // every warp is done with the previous K/V tile
    stage_tile<T, D, S, KV_TILE, TC_THREADS>(sK, kb, n0, Nkv, tid);
    stage_tile<T, D, S, KV_TILE, TC_THREADS>(sV, vb, n0, Nkv, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x KV_TILE keys
    float s[NT_S][4], dp[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t qa[4], oa[4];
      ldsm_x4(qa, a_frag<S>(sQ, warp * 16, ks * 16, lane));
      ldsm_x4(oa, a_frag<S>(sdO, warp * 16, ks * 16, lane));
#pragma unroll
      for (int np = 0; np < NT_S / 2; ++np) {
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, b_frag<S>(sK, np * 16, ks * 16, lane));
        ldsm_x4(vf, b_frag<S>(sV, np * 16, ks * 16, lane));
        Mma<T>::run(s[2 * np], qa, kf[0], kf[1]);
        Mma<T>::run(s[2 * np + 1], qa, kf[2], kf[3]);
        Mma<T>::run(dp[2 * np], oa, vf[0], vf[1]);
        Mma<T>::run(dp[2 * np + 1], oa, vf[2], vf[3]);
      }
    }

    // dS: element e of n-tile j is row warp*16 + g (+8 for e >= 2), key
    // n0 + j*8 + 2t + (e & 1)
    const bool unmasked = tile_unmasked<Q_TILE, KV_TILE>(m0, n0, Nq, Nkv, causal, window);
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >= 2 ? 1 : 0;
        float dcap;
        const float x = score(s[j][e], sm_scale, softcap, dcap);
        const bool vis = unmasked || visible(m0 + warp * 16 + g + 8 * r,
                                             n0 + j * 8 + 2 * t + (e & 1), Nq, Nkv,
                                             causal, window);
        const float p = vis ? exp2f(x * kLog2e - lse2[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - dlt[r]) * dcap;
      }
    }

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < KV_TILE / 16; ++kk) {
      const uint32_t da[4] = {
          Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
          Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
          Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int np = 0; np < NT_O / 2; ++np) {
        uint32_t kf[4];
        ldsm_x4_trans(kf, bt_frag<S>(sK, kk * 16, np * 16, lane));
        Mma<T>::run(acc[2 * np], da, kf[0], kf[1]);
        Mma<T>::run(acc[2 * np + 1], da, kf[2], kf[3]);
      }
    }
  }

  T* dqb = dq + bh * Nq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + g + 8 * r;
    if (row >= Nq) continue;
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      *reinterpret_cast<uint32_t*>(dqb + size_t(row) * D + j * 8 + 2 * t) =
          Mma<T>::pack(acc[j][2 * r] * sm_scale, acc[j][2 * r + 1] * sm_scale);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 path (CUDA cores, true fp32)
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;  // 16 x 16

// rows [r0, r0 + 64) of a [N, D] fp32 matrix into a [64][D+1] tile, zero past N
template <int D>
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int r0, int N,
                                          int tid) {
  for (int idx = tid; idx < 64 * D; idx += F32_THREADS) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] = r0 + r < N ? src[size_t(r0 + r) * D + c] : 0.f;
  }
}

template <int D>
constexpr size_t dkv_f32_smem_bytes() {
  // sK, sV, sQ, sdO [64][D+1]; sP, sDS [64][65]; lse, D [64]
  return sizeof(float) * (4 * 64 * size_t(D + 1) + 2 * 64 * 65 + 2 * 64);
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
attn_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv, int Hq, int Hkv,
                        int Nq, int Nkv, float sm_scale, int causal, int window,
                        float softcap) {
  static_assert(KV_TILE == 64 && F32_Q_STEP == 64, "the fp32 tiles are 64 x 64");
  constexpr int PS = D + 1;   // padded strides: conflict-free column walks
  constexpr int SS = 64 + 1;
  constexpr int OJ = D / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + 64 * PS;
  float* sQ = sV + 64 * PS;
  float* sdO = sQ + 64 * PS;
  float* sP = sdO + 64 * PS;   // P^T [key][row]
  float* sDS = sP + 64 * SS;   // dS^T [key][row]
  float* sLse = sDS + 64 * SS;
  float* sDelta = sLse + 64;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * KV_TILE;
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;
  const int group = Hq / Hkv;

  stage_f32<D>(sK, k + (size_t(b) * Hkv + kvh) * size_t(Nkv) * D, n0, Nkv, tid);
  stage_f32<D>(sV, v + (size_t(b) * Hkv + kvh) * size_t(Nkv) * D, n0, Nkv, tid);

  // keys 4*ty + i, output columns tx + 16*j
  float dk_acc[4][OJ], dv_acc[4][OJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const TileRange steps = q_tiles<F32_Q_STEP>(n0, Nq, Nkv, causal, window);
  for (int hh = 0; hh < group; ++hh) {
    const size_t bh = size_t(b) * Hq + kvh * group + hh;
    for (int it = steps.lo; it < steps.hi; ++it) {
      const int m0 = it * F32_Q_STEP;
      __syncthreads();
      stage_f32<D>(sQ, q + bh * Nq * D, m0, Nq, tid);
      stage_f32<D>(sdO, dout + bh * Nq * D, m0, Nq, tid);
      if (tid < 64) {
        const int row = m0 + tid;
        sLse[tid] = row < Nq ? lse[bh * Nq + row] : 0.f;
        sDelta[tid] = row < Nq ? delta[bh * Nq + row] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T for keys 4*ty + i, rows tx + 16*j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = sK[(ty * 4 + i) * PS + c];
          vv[i] = sV[(ty * 4 + i) * PS + c];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = sQ[(tx + 16 * j) * PS + c];
          ov[j] = sdO[(tx + 16 * j) * PS + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          float dcap;
          const float x = score(s[i][j], sm_scale, softcap, dcap);
          const bool vis = visible(m0 + r, n0 + ty * 4 + i, Nq, Nkv, causal, window);
          const float p = vis ? expf(x - sLse[r]) : 0.f;
          sP[(ty * 4 + i) * SS + r] = p;
          sDS[(ty * 4 + i) * SS + r] = p * (dp[i][j] - sDelta[r]) * dcap;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < F32_Q_STEP; ++c) {
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

template <int D>
constexpr size_t dq_f32_smem_bytes() {
  // sQ, sdO, sK, sV [64][D+1]; sDS [64][65]; lse, D [64]
  return sizeof(float) * (4 * 64 * size_t(D + 1) + 64 * 65 + 2 * 64);
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
attn_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, int Hq, int Hkv, int Nq, int Nkv,
                       float sm_scale, int causal, int window, float softcap) {
  static_assert(Q_TILE == 64 && KV_TILE == 64, "the fp32 tiles are 64 x 64");
  constexpr int PS = D + 1;
  constexpr int SS = 64 + 1;
  constexpr int OJ = D / 16;

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + 64 * PS;
  float* sK = sdO + 64 * PS;
  float* sV = sK + 64 * PS;
  float* sDS = sV + 64 * PS;
  float* sLse = sDS + 64 * SS;
  float* sDelta = sLse + 64;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * Q_TILE;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq;
  const int kvh = h / (Hq / Hkv);
  const size_t bh = size_t(b) * Hq + h;
  const float* kb = k + (size_t(b) * Hkv + kvh) * size_t(Nkv) * D;
  const float* vb = v + (size_t(b) * Hkv + kvh) * size_t(Nkv) * D;

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

  const TileRange tiles = kv_tiles<Q_TILE, KV_TILE>(m0, Nq, Nkv, causal, window);
  for (int kt = tiles.lo; kt < tiles.hi; ++kt) {
    const int n0 = kt * KV_TILE;
    __syncthreads();  // the previous tile's dS K is done with sDS / sK
    stage_f32<D>(sK, kb, n0, Nkv, tid);
    stage_f32<D>(sV, vb, n0, Nkv, tid);
    __syncthreads();

    // S and dP for rows 4*ty + i, keys tx + 16*j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty * 4 + i) * PS + c];
        ov[i] = sdO[(ty * 4 + i) * PS + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(tx + 16 * j) * PS + c];
        vv[j] = sV[(tx + 16 * j) * PS + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float dcap;
        const float x = score(s[i][j], sm_scale, softcap, dcap);
        const bool vis = visible(m0 + r, n0 + tx + 16 * j, Nq, Nkv, causal, window);
        const float p = vis ? expf(x - sLse[r]) : 0.f;
        sDS[r * SS + tx + 16 * j] = p * (dp[i][j] - sDelta[r]) * dcap;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < KV_TILE; ++c) {
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

template <typename T, int D>
int launch_dkv(const Args& a, void* dk, void* dv) {
  const dim3 grid((a.Nkv + KV_TILE - 1) / KV_TILE, a.B * a.Hkv);
  if constexpr (sizeof(T) == 4) {
    return launch(attn_bwd_dkv_f32_kernel<D>, dkv_f32_smem_bytes<D>(), grid,
                  F32_THREADS, a.stream, static_cast<const float*>(a.q),
                  static_cast<const float*>(a.k), static_cast<const float*>(a.v),
                  static_cast<const float*>(a.dout), a.lse, a.delta,
                  static_cast<float*>(dk), static_cast<float*>(dv), a.Hq, a.Hkv,
                  a.Nq, a.Nkv, a.sm_scale, a.causal, a.window, a.softcap);
  } else {
    return launch(attn_bwd_dkv_mma_kernel<T, D>, dkv_mma_smem_bytes<D>(), grid,
                  TC_THREADS, a.stream, static_cast<const T*>(a.q),
                  static_cast<const T*>(a.k), static_cast<const T*>(a.v),
                  static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(dk),
                  static_cast<T*>(dv), a.Hq, a.Hkv, a.Nq, a.Nkv, a.sm_scale,
                  a.causal, a.window, a.softcap);
  }
}

template <typename T, int D>
int launch_dq(const Args& a, void* dq) {
  const dim3 grid((a.Nq + Q_TILE - 1) / Q_TILE, a.B * a.Hq);
  if constexpr (sizeof(T) == 4) {
    return launch(attn_bwd_dq_f32_kernel<D>, dq_f32_smem_bytes<D>(), grid, F32_THREADS,
                  a.stream, static_cast<const float*>(a.q),
                  static_cast<const float*>(a.k), static_cast<const float*>(a.v),
                  static_cast<const float*>(a.dout), a.lse, a.delta,
                  static_cast<float*>(dq), a.Hq, a.Hkv, a.Nq, a.Nkv, a.sm_scale,
                  a.causal, a.window, a.softcap);
  } else {
    return launch(attn_bwd_dq_mma_kernel<T, D>, dq_mma_smem_bytes<D>(), grid, TC_THREADS,
                  a.stream, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                  static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
                  a.delta, static_cast<T*>(dq), a.Hq, a.Hkv, a.Nq, a.Nkv, a.sm_scale,
                  a.causal, a.window, a.softcap);
  }
}

// dtype x head_dim dispatch: 0 = float32, 1 = bfloat16, 2 = float16; d in {64, 128}
template <template <typename, int> class Fn, typename... P>
int dispatch(int dtype, int D, P... params) {
  if (D != 64 && D != 128) return int(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return D == 64 ? Fn<float, 64>::run(params...) : Fn<float, 128>::run(params...);
    case 1:
      return D == 64 ? Fn<__nv_bfloat16, 64>::run(params...)
                     : Fn<__nv_bfloat16, 128>::run(params...);
    case 2:
      return D == 64 ? Fn<__half, 64>::run(params...) : Fn<__half, 128>::run(params...);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template <typename T, int D> struct DkvFn {
  static int run(const Args& a, void* dk, void* dv) { return launch_dkv<T, D>(a, dk, dv); }
};
template <typename T, int D> struct DqFn {
  static int run(const Args& a, void* dq) { return launch_dq<T, D>(a, dq); }
};

bool valid(int B, int Hq, int Hkv, int Nq, int Nkv) {
  return B > 0 && Hq > 0 && Hkv > 0 && Hq % Hkv == 0 && Nq > 0 && Nkv > 0;
}

}  // namespace

// All entry points: dtype 0 = float32, 1 = bfloat16, 2 = float16; tensors
// contiguous, bf16/fp16 pointers 16-byte aligned.  Each returns
// cudaGetLastError() after its launch (0 on success).

// delta[r] = sum_c o[r, c] * dout[r, c] in fp32, for `rows` rows of D.
extern "C" int attn_bwd_preprocess(const void* o, const void* dout, float* delta,
                                   int dtype, int rows, int D, void* stream) {
  if (rows <= 0) return 0;
  const dim3 grid((rows + PRE_THREADS / 32 - 1) / (PRE_THREADS / 32));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      attn_bwd_preprocess_kernel<float><<<grid, PRE_THREADS, 0, s>>>(
          static_cast<const float*>(o), static_cast<const float*>(dout), delta, rows, D);
      break;
    case 1:
      attn_bwd_preprocess_kernel<__nv_bfloat16><<<grid, PRE_THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
          delta, rows, D);
      break;
    case 2:
      attn_bwd_preprocess_kernel<__half><<<grid, PRE_THREADS, 0, s>>>(
          static_cast<const __half*>(o), static_cast<const __half*>(dout), delta, rows, D);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// dK, dV [B, Hkv, Nkv, d] from q, k, v, dout, lse and delta.
extern "C" int attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dk, void* dv,
                            int dtype, int B, int Hq, int Hkv, int Nq, int Nkv, int D,
                            float sm_scale, int causal, int window, float softcap,
                            void* stream) {
  if (!valid(B, Hq, Hkv, Nq, Nkv)) return int(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, lse, delta, B, Hq, Hkv, Nq, Nkv, sm_scale, causal,
               window, softcap, static_cast<cudaStream_t>(stream)};
  return dispatch<DkvFn>(dtype, D, a, dk, dv);
}

// dQ [B, Hq, Nq, d] from q, k, v, dout, lse and delta.
extern "C" int attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dq, int dtype,
                           int B, int Hq, int Hkv, int Nq, int Nkv, int D, float sm_scale,
                           int causal, int window, float softcap, void* stream) {
  if (!valid(B, Hq, Hkv, Nq, Nkv)) return int(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, lse, delta, B, Hq, Hkv, Nq, Nkv, sm_scale, causal,
               window, softcap, static_cast<cudaStream_t>(stream)};
  return dispatch<DqFn>(dtype, D, a, dq);
}

static const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
extern "C" const char* attn_bwd_preprocess_error_string(int err) { return error_string(err); }
extern "C" const char* attn_bwd_dkv_error_string(int err) { return error_string(err); }
extern "C" const char* attn_bwd_dq_error_string(int err) { return error_string(err); }
