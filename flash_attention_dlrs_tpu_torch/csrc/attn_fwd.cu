// Blocked attention forward (FlashAttention-2 style) for Hopper, sm_90a.
//
// Replaces the forward of four TPU kernels for the serving feature set:
//   flash_attention_dlrs_tpu/ops/fwd_kernel.py  _fwd_kernel        (general tri/band grid)
//   flash_attention_dlrs_tpu/ops/fwd_mid.py     _mid_kernel        (causal pane, N <= 2048)
//   flash_attention_dlrs_tpu/ops/fwd_mid.py     _mid_strip_kernel  (causal strip, N <= 8192)
//   flash_attention_dlrs_tpu/ops/fwd_small.py   _small_kernel      (one-shot, N <= 512)
// The TPU split that function by length to work around its grid-step
// overhead and VMEM limits; one kernel here takes every length.
//
// Computes O = softmax(scale * Q K^T (+ softcap) + mask) V and the natural-base
// logsumexp L per row, for q [B, Hq, Nq, d], k/v [B, Hkv, Nkv, d] (contiguous),
// with causal masking aligned bottom-right (row i sits at kv position
// i + Nkv - Nq), an optional sliding window on the causal band, an optional
// logit softcap, any Nq/Nkv (ragged tails are masked here) and GQA
// (kv head = h / (Hq / Hkv)).  A row that sees no key gets O = 0 and
// L = DEFAULT_MASK_VALUE, the JAX package's stats_to_lse convention.
// Inputs are fp32, bf16 or fp16 with d in {64, 128}.  The online softmax
// keeps an exact running max (no static shift) and fp32 statistics.
//
// Bound on this card.  Causal prefill at the serving shapes is bound by
// operations: 4*Nq*Nkv*d/2 flops per head against ~(2*Nq + 2*Nkv)*d*2
// bytes; the tensor cores' 989 TFLOP/s bf16 rate sets the floor.  What the
// design does about it:
//  * bf16/fp16 inputs run both products on the tensor cores with
//    mma.sync.m16n8k16 (fp32 accumulate), fragments loaded with ldmatrix
//    from padded (conflict-free) shared tiles.  A CTA of 4 warps owns 64 q
//    rows (16 per warp) kept in registers; 64-row K/V tiles stream past them
//    through shared memory, so device memory traffic is one K/V read per q
//    tile; scores and P never leave registers (the S accumulator is re-packed
//    as the A operand of P.V).  P is rounded to the input type before P.V,
//    as the TPU kernel does.  No async copy, wgmma or TMA yet (ROADMAP
//    queue 2): the loads stall the warps, which keeps this well above the
//    floor.
//  * fp32 inputs must compute in true fp32 (the fp32 gate is atol 1e-4), so
//    they run on the CUDA cores: 256 threads, each owning a 4 x 4 patch of
//    the score tile and a 4 x d/16 patch of the output.
// Both paths skip KV tiles wholly above the causal diagonal or outside the
// window band, and process the heaviest causal q tiles first.

#include "common.cuh"

namespace {

constexpr int BM = 64;  // q rows per CTA
constexpr int BN = 64;  // kv rows per tile

// ---------------------------------------------------------------------------
// Tensor-core path (bf16 / fp16)
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;  // 4 warps x 16 q rows

template <int D>
constexpr size_t tc_smem_bytes() {
  return size_t(3) * BM * (D + 8) * 2;  // sQ, sK, sV of 16-bit elements
}

template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS)
attn_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ lse, int Hq, int Hkv, int Nq, int Nkv,
                    float sm_scale, int causal, int window, float softcap) {
  constexpr int S = D + 8;          // padded row stride: conflict-free ldmatrix
  constexpr int KSTEPS = D / 16;    // k-steps of Q K^T
  constexpr int NT_S = BN / 8;      // score n-tiles per warp
  constexpr int NT_O = D / 8;       // output n-tiles per warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + BM * S;
  T* sV = sK + BM * S;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group / column pair
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);

  const T* qb = q + (size_t(b) * Hq + h) * size_t(Nq) * D;
  const T* kb = k + (size_t(b) * Hkv + kvh) * size_t(Nkv) * D;
  const T* vb = v + (size_t(b) * Hkv + kvh) * size_t(Nkv) * D;

  stage_tile<T, D, S, BM, TC_THREADS>(sQ, qb, m0, Nq, tid);
  __syncthreads();
  uint32_t qf[KSTEPS][4];  // this warp's 16 q rows as A fragments
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks)
    ldsm_x4(qf[ks], a_frag<S>(sQ, warp * 16, ks * 16, lane));

  float acc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // running max, base-2 units
  float l_r[2] = {0.f, 0.f};              // this thread's share of the row sum

  const TileRange tiles = kv_tiles<BM, BN>(m0, Nq, Nkv, causal, window);
  for (int kt = tiles.lo; kt < tiles.hi; ++kt) {
    const int n0 = kt * BN;
    __syncthreads();  // every warp is done with the previous K/V tile
    stage_tile<T, D, S, BN, TC_THREADS>(sK, kb, n0, Nkv, tid);
    stage_tile<T, D, S, BN, TC_THREADS>(sV, vb, n0, Nkv, tid);
    __syncthreads();

    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int np = 0; np < NT_S / 2; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, b_frag<S>(sK, np * 16, ks * 16, lane));
        Mma<T>::run(s[2 * np], qf[ks], kf[0], kf[1]);
        Mma<T>::run(s[2 * np + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // scale, softcap, mask; base-2 units from here on
    const bool unmasked = tile_unmasked<BM, BN>(m0, n0, Nq, Nkv, causal, window);
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sm_scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        x *= kLog2e;
        if (!unmasked) {
          const int row = m0 + warp * 16 + g + (e >= 2 ? 8 : 0);
          const int col = n0 + j * 8 + 2 * t + (e & 1);
          if (!visible(row, col, Nq, Nkv, causal, window)) x = -INFINITY;
        }
        s[j][e] = x;
      }
    }

    // online softmax for rows g (r = 0) and g + 8 (r = 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT_S; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m_r[r] - m_use);  // 0 while the row saw nothing
      m_r[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = exp2f(s[j][e] - m_use);  // masked: exp2(-inf) = 0
          s[j][e] = p;
          sum += p;
        }
      }
      l_r[r] = l_r[r] * alpha + sum;
#pragma unroll
      for (int j = 0; j < NT_O; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }

    // O += P V: the score accumulators re-packed as A fragments
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {
          Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
          Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
          Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int np = 0; np < NT_O / 2; ++np) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, bt_frag<S>(sV, kk * 16, np * 16, lane));
        Mma<T>::run(acc[2 * np], pa, vf[0], vf[1]);
        Mma<T>::run(acc[2 * np + 1], pa, vf[2], vf[3]);
      }
    }
  }

  T* ob = o + (size_t(b) * Hq + h) * size_t(Nq) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = m0 + warp * 16 + g + 8 * r;
    if (row >= Nq) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      *reinterpret_cast<uint32_t*>(ob + size_t(row) * D + j * 8 + 2 * t) =
          Mma<T>::pack(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    }
    if (t == 0) {
      lse[(size_t(b) * Hq + h) * Nq + row] =
          l > 0.f ? (m_r[r] + log2f(l)) * kLn2 : kMaskValue;
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 path (CUDA cores, true fp32)
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;  // 16 x 16

template <int D>
constexpr size_t f32_smem_bytes() {
  // sQ [BM][D+1], sK [BN][D+1], sV [BN][D], sS [BM][BN+1], row stats 3 x [BM]
  return sizeof(float) *
         (size_t(BM) * (D + 1) + size_t(BN) * (D + 1) + size_t(BN) * D +
          size_t(BM) * (BN + 1) + 3 * BM);
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int Hq, int Hkv, int Nq, int Nkv,
                    float sm_scale, int causal, int window, float softcap) {
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

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int kvh = h / (Hq / Hkv);

  const float* qb = q + (size_t(b) * Hq + h) * size_t(Nq) * D;
  const float* kb = k + (size_t(b) * Hkv + kvh) * size_t(Nkv) * D;
  const float* vb = v + (size_t(b) * Hkv + kvh) * size_t(Nkv) * D;

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
      sK[r * KS + c] = in ? kb[size_t(col) * D + c] : 0.f;
      sV[r * D + c] = in ? vb[size_t(col) * D + c] : 0.f;
    }
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
        sS[(ty * 4 + i) * SS + tx + 16 * j] =
            visible(row, col, Nq, Nkv, causal, window) ? x : -INFINITY;
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
        srow_p[c] = p;
        sum += p;
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
  void* o;
  float* lse;
  int B, Hq, Hkv, Nq, Nkv;
  float sm_scale;
  int causal, window;
  float softcap;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_mma(const Args& a) {
  auto kernel = attn_fwd_mma_kernel<T, D>;
  constexpr size_t smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((a.Nq + BM - 1) / BM, a.B * a.Hq);
  kernel<<<grid, TC_THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.Hq, a.Hkv,
      a.Nq, a.Nkv, a.sm_scale, a.causal, a.window, a.softcap);
  return int(cudaGetLastError());
}

template <int D>
int launch_f32(const Args& a) {
  auto kernel = attn_fwd_f32_kernel<D>;
  constexpr size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((a.Nq + BM - 1) / BM, a.B * a.Hq);
  kernel<<<grid, F32_THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.Hq,
      a.Hkv, a.Nq, a.Nkv, a.sm_scale, a.causal, a.window, a.softcap);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  bf16/fp16 pointers must be
// 16-byte aligned.  Returns cudaGetLastError() after the launch (0 on
// success); launches nothing for an empty problem.
extern "C" int attn_fwd(const void* q, const void* k, const void* v, void* o,
                        float* lse, int dtype, int B, int Hq, int Hkv, int Nq,
                        int Nkv, int D, float sm_scale, int causal, int window,
                        float softcap, void* stream) {
  if (B <= 0 || Hq <= 0 || Nq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Nkv < 0) return int(cudaErrorInvalidValue);
  const Args a{q, k, v, o, lse, B, Hq, Hkv, Nq, Nkv, sm_scale, causal, window,
               softcap, static_cast<cudaStream_t>(stream)};
  if (D != 64 && D != 128) return int(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return D == 64 ? launch_f32<64>(a) : launch_f32<128>(a);
    case 1:
      return D == 64 ? launch_mma<__nv_bfloat16, 64>(a)
                     : launch_mma<__nv_bfloat16, 128>(a);
    case 2:
      return D == 64 ? launch_mma<__half, 64>(a) : launch_mma<__half, 128>(a);
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* attn_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
