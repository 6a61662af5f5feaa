// Multi-token paged attention (speculative verify, chunked prefill) for
// Hopper, sm_90a.
//
// Replaces the multi-token mode of the TPU kernel
//   flash_attention_dlrs_tpu/ops/decode.py  _decode_kernel  (num_tokens > 1,
//   s8_scores=False; via _paged_decode, paged_verify_attention)
// for every pool kind of paged.cuh, with ALiBi.
//
// q is [B, Hq, T, d]: T new tokens per sequence whose K/V are already in the
// pages; lengths [B] int32 are the FINAL lengths (the T tokens counted,
// clamped to pages_per_seq * page_size).  The rows of one kv head are
// T * G (G = Hq / Hkv), t-major: row = t * G + g.  Row t sees positions
// < length - (T - 1 - t); a row that sees nothing (the front padding of a
// partial prefill chunk) gets O = 0.  O is [B, Hq, T, d] in q's dtype.  The
// arithmetic is the TPU kernel's dequantized route: q pre-scaled in its own
// dtype (the caller passes sm_scale rounded to it), K and V payloads cast to
// q's dtype unscaled (exact for every quantized kind), S = q . k in fp32
// times the K scale (+ softcap), ALiBi's true bias -m_h * (q_pos - pos) with
// row t at q_pos = length - T + t (one below its horizon, the same
// alignment as the mask; one FMA per score), an online softmax with an exact
// running max, and P * v_scale rounded to q's dtype before P V.  Value pools
// have scale 1; in bf16/fp16 they must be of q's dtype.
//
// Bound on this card.  A 256-token chunk against a 2048-token context is
// bound by operations: 4 * (T*G rows) * ctx * d flops per kv head against
// ~2 * ctx * d bytes of K/V; the tensor cores' 989 TFLOP/s sets the floor.
// What the design does about it: the grid is (64-row tiles of the T*G rows,
// kv head, sequence), so a 256-token chunk with G = 2 runs on 8 row tiles
// per kv head instead of one CTA; bf16/fp16 run both products on
// mma.sync.m16n8k16 (fp32 accumulate) with the fragment helpers of
// common.cuh, as attn_fwd.cu does: 4 warps own 16 rows each, 64-token K/V
// tiles are gathered through the page table and dequantized into padded
// shared tiles, S and P stay in registers.  A CTA walks only the tokens its
// last row can see.  No async copy, wgmma or TMA yet, and each row tile
// reads its K/V range again.  fp32 q computes in true fp32 on the CUDA cores
// (256 threads, a 4 x 4 patch of the score tile each).

#include "common.cuh"
#include "paged.cuh"

namespace {

constexpr int VBM = 64;  // rows per CTA
constexpr int VBN = 64;  // tokens per K/V tile
constexpr int TC_THREADS = 128;
constexpr int F32_THREADS = 256;

struct Args {
  const void* q;
  int kind;
  const void *k_pages, *v_pages;
  const float *k_scales, *v_scales;
  const int *lengths, *page_table;
  void* o;
  int B, Hq, Hkv, T, P, page_size, pages_per_seq;
  float scale_q, softcap;
  const float* slopes;  // [Hq] ALiBi slopes, or null
  cudaStream_t stream;
};

// Positions [0, kmax) that rows [m0, min(m0 + VBM, rows)) can see, at most.
__device__ __forceinline__ int visible_tokens(int len, int m0, int rows, int G,
                                              int T) {
  const int last = min(m0 + VBM, rows) - 1;
  return max(0, min(len, len - (T - 1 - last / G)));
}

// Page-table lookups of one K/V tile: stored-row index, nibble and scales
// of positions [n0, n0 + VBN) below kmax.
__device__ __forceinline__ void tile_addrs(const Args& a, const int* table,
                                           int kvh, int n0, int kmax, int tid,
                                           int threads, size_t* sOff, int* sHi,
                                           float* sKs, float* sVs) {
  const bool quant = is_quantized(a.kind);
  for (int r = tid; r < VBN; r += threads) {
    const int pos = n0 + r;
    if (pos < kmax) {
      const int page = table[pos / a.page_size];
      const int off = pos % a.page_size;
      const TokenAddr t = token_addr(a.kind, kvh, page, off, a.P, a.page_size, 1);
      sOff[r] = t.row;
      sHi[r] = t.hi;
      const size_t si = scale_index(kvh, page, off, a.P, a.page_size);
      sKs[r] = quant ? a.k_scales[si] : 1.f;
      sVs[r] = quant ? a.v_scales[si] : 1.f;
    } else {
      sOff[r] = 0;
      sHi[r] = -1;  // outside: staged as zeros
      sKs[r] = sVs[r] = 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path (bf16 / fp16 q)
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t tc_smem_bytes() {
  return size_t(3) * VBM * (D + 8) * 2 + VBN * (2 * sizeof(float) + sizeof(size_t) + sizeof(int));
}

// A 64-token tile of one pool into a [VBN][S] shared tile of T, dequantized
// (unscaled) to T: 16-byte loads, all issued before the first store.
template <typename T, int D, int S>
__device__ __forceinline__ void stage_pool_tile(T* dst, const char* pool, int kind,
                                                const size_t* sOff, const int* sHi,
                                                int tid) {
  const int eb = stored_bytes(kind);
  if (eb == 2) {  // the pool is q's dtype: a straight copy
    constexpr int CPR = D / 8, ITERS = VBN * CPR / TC_THREADS;
    uint4 buf[ITERS];
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int idx = tid + it * TC_THREADS, r = idx / CPR, c = (idx % CPR) * 8;
      buf[it] = sHi[r] >= 0 ? *reinterpret_cast<const uint4*>(pool + (sOff[r] * D + c) * 2)
                            : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int idx = tid + it * TC_THREADS, r = idx / CPR, c = (idx % CPR) * 8;
      *reinterpret_cast<uint4*>(dst + r * S + c) = buf[it];
    }
  } else {  // one byte per element: 16 elements per load
    constexpr int CPR = D / 16, ITERS = VBN * CPR / TC_THREADS;
    uint4 buf[ITERS];
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int idx = tid + it * TC_THREADS, r = idx / CPR, c = (idx % CPR) * 16;
      buf[it] = sHi[r] >= 0 ? *reinterpret_cast<const uint4*>(pool + sOff[r] * D + c)
                            : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int idx = tid + it * TC_THREADS, r = idx / CPR, c = (idx % CPR) * 16;
      const int hi = max(sHi[r], 0);
      const uint32_t w[4] = {buf[it].x, buf[it].y, buf[it].z, buf[it].w};
      uint32_t packed[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float f[4];
        word_values(kind, w[j], hi, f);
        packed[2 * j] = Mma<T>::pack(f[0], f[1]);
        packed[2 * j + 1] = Mma<T>::pack(f[2], f[3]);
      }
      *reinterpret_cast<uint4*>(dst + r * S + c) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
      *reinterpret_cast<uint4*>(dst + r * S + c + 8) =
          make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS)
paged_verify_mma_kernel(const Args a) {
  constexpr int S = D + 8;          // padded row stride: conflict-free ldmatrix
  constexpr int KSTEPS = D / 16;    // k-steps of Q K^T
  constexpr int NT_S = VBN / 8;     // score n-tiles per warp
  constexpr int NT_O = D / 8;       // output n-tiles per warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + VBM * S;
  T* sV = sK + VBN * S;
  float* sKs = reinterpret_cast<float*>(sV + VBN * S);
  float* sVs = sKs + VBN;
  size_t* sOff = reinterpret_cast<size_t*>(sVs + VBN);
  int* sHi = reinterpret_cast<int*>(sOff + VBN);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;  // mma fragment row group / column pair
  const int G = a.Hq / a.Hkv, rows = a.T * G;
  const int m0 = blockIdx.x * VBM, kvh = blockIdx.y, b = blockIdx.z;
  const int len = max(0, min(a.lengths[b], a.pages_per_seq * a.page_size));
  const T* q = static_cast<const T*>(a.q);

  // Q rows, pre-scaled and rounded to T; padding rows are zero.
  for (int idx = tid; idx < VBM * (D / 8); idx += TC_THREADS) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8, row = m0 + r;
    uint4 out = make_uint4(0, 0, 0, 0);
    if (row < rows) {
      const int t = row / G, g = row % G;
      const T* src = q + ((size_t(b) * a.Hq + kvh * G + g) * a.T + t) * D + c;
      const uint4 raw = *reinterpret_cast<const uint4*>(src);
      const T* e = reinterpret_cast<const T*>(&raw);
      uint32_t p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = Mma<T>::pack(to_float(e[2 * i]) * a.scale_q, to_float(e[2 * i + 1]) * a.scale_q);
      out = make_uint4(p[0], p[1], p[2], p[3]);
    }
    *reinterpret_cast<uint4*>(sQ + r * S + c) = out;
  }
  __syncthreads();
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks)
    ldsm_x4(qf[ks], a_frag<S>(sQ, warp * 16, ks * 16, lane));

  int horizon[2];    // positions < horizon visible, rows g and g + 8
  float slope[2];    // their ALiBi slopes (0 without ALiBi)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + gq + 8 * r;
    horizon[r] = row < rows ? len - (a.T - 1 - row / G) : 0;
    slope[r] = a.slopes != nullptr && row < rows ? a.slopes[kvh * G + row % G] : 0.f;
  }

  float acc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // running max, base-2 units
  float l_r[2] = {0.f, 0.f};              // this thread's share of the row sum

  const int* table = a.page_table + size_t(b) * a.pages_per_seq;
  const int kmax = visible_tokens(len, m0, rows, G, a.T);
  for (int n0 = 0; n0 < kmax; n0 += VBN) {
    __syncthreads();  // every warp is done with the previous tile
    tile_addrs(a, table, kvh, n0, kmax, tid, TC_THREADS, sOff, sHi, sKs, sVs);
    __syncthreads();
    stage_pool_tile<T, D, S>(sK, static_cast<const char*>(a.k_pages), a.kind, sOff, sHi, tid);
    stage_pool_tile<T, D, S>(sV, static_cast<const char*>(a.v_pages), a.kind, sOff, sHi, tid);
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

    // K scale, softcap, ALiBi bias (q_pos = horizon - 1), horizon mask;
    // base-2 units from here on
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * tq + (e & 1);
        float x = s[j][e] * sKs[c];
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        x -= slope[e >> 1] * float(horizon[e >> 1] - 1 - (n0 + c));
        s[j][e] = n0 + c < horizon[e >> 1] ? x * kLog2e : -INFINITY;
      }
    }

    // online softmax for rows gq (r = 0) and gq + 8 (r = 1)
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

    // O += (P * v_scale) V, P * v_scale rounded to T by the packing
#pragma unroll
    for (int kk = 0; kk < VBN / 16; ++kk) {
      const int c0 = kk * 16 + 2 * tq;
      const float v0 = sVs[c0], v1 = sVs[c0 + 1], v8 = sVs[c0 + 8], v9 = sVs[c0 + 9];
      const uint32_t pa[4] = {
          Mma<T>::pack(s[2 * kk][0] * v0, s[2 * kk][1] * v1),
          Mma<T>::pack(s[2 * kk][2] * v0, s[2 * kk][3] * v1),
          Mma<T>::pack(s[2 * kk + 1][0] * v8, s[2 * kk + 1][1] * v9),
          Mma<T>::pack(s[2 * kk + 1][2] * v8, s[2 * kk + 1][3] * v9),
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

  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = m0 + warp * 16 + gq + 8 * r;
    if (row >= rows) continue;
    const int t = row / G, g = row % G;
    T* dst = o + ((size_t(b) * a.Hq + kvh * G + g) * a.T + t) * D;
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      *reinterpret_cast<uint32_t*>(dst + j * 8 + 2 * tq) =
          Mma<T>::pack(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 path (CUDA cores, true fp32)
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t f32_smem_bytes() {
  // sQ [VBM][D+1], sK [VBN][D+1], sV [VBN][D], sS [VBM][VBN+1], sAlpha [VBM],
  // sHz [VBM] (ints), sSl [VBM], sKs / sVs [VBN]; then sOff (size_t), sHi
  // (int) [VBN]
  const size_t f = size_t(VBM) * (D + 1) + size_t(VBN) * (D + 1) + size_t(VBN) * D +
                   size_t(VBM) * (VBN + 1) + 3 * VBM + 2 * VBN;
  return ((f + 1) & ~size_t(1)) * sizeof(float) + VBN * (sizeof(size_t) + sizeof(int));
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
paged_verify_f32_kernel(const Args a) {
  constexpr int QS = D + 1;   // padded row strides: conflict-free column walks
  constexpr int KS = D + 1;
  constexpr int SS = VBN + 1;
  constexpr int OJ = D / 16;  // output columns per thread
  constexpr size_t F = size_t(VBM) * QS + size_t(VBN) * KS + size_t(VBN) * D +
                       size_t(VBM) * SS + 3 * VBM + 2 * VBN;

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + VBM * QS;
  float* sV = sK + VBN * KS;
  float* sS = sV + VBN * D;
  float* sAlpha = sS + VBM * SS;
  int* sHz = reinterpret_cast<int*>(sAlpha + VBM);
  float* sSl = reinterpret_cast<float*>(sHz + VBM);
  float* sKs = sSl + VBM;
  float* sVs = sKs + VBN;
  size_t* sOff = reinterpret_cast<size_t*>(smem + ((F + 1) & ~size_t(1)));
  int* sHi = reinterpret_cast<int*>(sOff + VBN);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int G = a.Hq / a.Hkv, rows = a.T * G;
  const int m0 = blockIdx.x * VBM, kvh = blockIdx.y, b = blockIdx.z;
  const int len = max(0, min(a.lengths[b], a.pages_per_seq * a.page_size));
  const float* q = static_cast<const float*>(a.q);

  for (int idx = tid; idx < VBM * D; idx += F32_THREADS) {
    const int r = idx / D, c = idx % D, row = m0 + r;
    float x = 0.f;
    if (row < rows) {
      const int t = row / G, g = row % G;
      x = q[((size_t(b) * a.Hq + kvh * G + g) * a.T + t) * D + c] * a.scale_q;
    }
    sQ[r * QS + c] = x;
  }
  for (int r = tid; r < VBM; r += F32_THREADS) {
    const int row = m0 + r;
    sHz[r] = row < rows ? len - (a.T - 1 - row / G) : 0;
    sSl[r] = a.slopes != nullptr && row < rows ? a.slopes[kvh * G + row % G] : 0.f;
  }

  const int srow = tid / 4, spart = tid % 4;  // softmax: 4 threads per row
  float m_i = -INFINITY, l_i = 0.f;
  float acc[4][OJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) acc[i][j] = 0.f;

  const char* kb = static_cast<const char*>(a.k_pages);
  const char* vb = static_cast<const char*>(a.v_pages);
  const int eb = stored_bytes(a.kind);
  const int* table = a.page_table + size_t(b) * a.pages_per_seq;
  const int kmax = visible_tokens(len, m0, rows, G, a.T);
  for (int n0 = 0; n0 < kmax; n0 += VBN) {
    __syncthreads();  // the previous tile's P.V is done with sS / sV
    tile_addrs(a, table, kvh, n0, kmax, tid, F32_THREADS, sOff, sHi, sKs, sVs);
    __syncthreads();
    // 16-byte chunks of the stored rows, dequantized (unscaled) to fp32
    const int vec = 16 / eb, cpr = D / vec;
    for (int idx = tid; idx < VBN * cpr; idx += F32_THREADS) {
      const int r = idx / cpr, c = (idx % cpr) * vec, hi = sHi[r];
      float kv[16], vv[16];
      if (hi >= 0) {
        chunk_values(a.kind, *reinterpret_cast<const uint4*>(kb + (sOff[r] * D + c) * eb),
                     hi, kv);
        chunk_values(a.kind, *reinterpret_cast<const uint4*>(vb + (sOff[r] * D + c) * eb),
                     hi, vv);
      }
      for (int i = 0; i < vec; ++i) {
        sK[r * KS + c + i] = hi >= 0 ? kv[i] : 0.f;
        sV[r * D + c + i] = hi >= 0 ? vv[i] : 0.f;
      }
    }
    __syncthreads();

    // S = Q K^T for rows 4*ty+i, columns tx+16*j
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
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float x = s[i][j] * sKs[c];
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        x -= sSl[r] * float(sHz[r] - 1 - (n0 + c));
        sS[r * SS + c] = n0 + c < sHz[r] ? x : -INFINITY;
      }
    }
    __syncthreads();

    // Online softmax, 4 threads per row, exact running max; P * v_scale is
    // written back for P V.
    {
      float* prow = sS + srow * SS;
      float mx = -INFINITY;
      for (int c = spart; c < VBN; c += 4) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m_i - m_use);  // 0 while the row saw nothing
      float sum = 0.f;
      for (int c = spart; c < VBN; c += 4) {
        const float p = expf(prow[c] - m_use);  // masked: exp(-inf) = 0
        prow[c] = p * sVs[c];
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_i = l_i * alpha + sum;
      m_i = m_new;
      if (spart == 0) sAlpha[srow] = alpha;
    }
    __syncthreads();

    // O = O * alpha + P V for rows 4*ty+i, columns tx+16*j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = sAlpha[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < OJ; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < VBN; ++c) {
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
  if (spart == 0) sAlpha[srow] = l_i;  // the row sums, for the writers below
  __syncthreads();
  float* o = static_cast<float*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, row = m0 + r;
    if (row >= rows) continue;
    const int t = row / G, g = row % G;
    float* dst = o + ((size_t(b) * a.Hq + kvh * G + g) * a.T + t) * D;
    const float l = sAlpha[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int j = 0; j < OJ; ++j) dst[tx + 16 * j] = acc[i][j] * inv;
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename T, int D>
int launch_mma(const Args& a) {
  auto kernel = paged_verify_mma_kernel<T, D>;
  constexpr size_t smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((a.T * (a.Hq / a.Hkv) + VBM - 1) / VBM, a.Hkv, a.B);
  kernel<<<grid, TC_THREADS, smem, a.stream>>>(a);
  return int(cudaGetLastError());
}

template <int D>
int launch_f32(const Args& a) {
  auto kernel = paged_verify_f32_kernel<D>;
  constexpr size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((a.T * (a.Hq / a.Hkv) + VBM - 1) / VBM, a.Hkv, a.B);
  kernel<<<grid, F32_THREADS, smem, a.stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q and O).  kv_kind: a
// PoolKind of paged.cuh; a bf16/fp16 value pool must be q's dtype.
// page_size is the LOGICAL page size.  Quantized kinds need k_scales and
// v_scales [Hkv, P, page_size] fp32.  scale_q is sm_scale rounded to q's
// dtype.  slopes: [Hq] fp32 ALiBi slopes on the device, or null.  Pools and
// q must be 16-byte aligned.  Returns cudaGetLastError() after the launch (0
// on success); launches nothing for an empty problem.
extern "C" int paged_verify(const void* q, int q_dtype, const void* k_pages,
                            const void* v_pages, int kv_kind,
                            const float* k_scales, const float* v_scales,
                            const int* lengths, const int* page_table, void* o,
                            int B, int Hq, int Hkv, int T, int P, int page_size,
                            int pages_per_seq, int D, float scale_q,
                            float softcap, const float* slopes, void* stream) {
  if (B <= 0 || Hq <= 0 || T <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || page_size <= 0 || pages_per_seq <= 0 ||
      kv_kind < kF32 || kv_kind > kE5M2 || (kv_kind == kI4 && page_size % 2) ||
      (is_quantized(kv_kind) && (k_scales == nullptr || v_scales == nullptr)) ||
      (D != 64 && D != 128))
    return int(cudaErrorInvalidValue);
  const Args a{q, kv_kind, k_pages, v_pages, k_scales, v_scales, lengths,
               page_table, o, B, Hq, Hkv, T, P, page_size, pages_per_seq,
               scale_q, softcap, slopes, static_cast<cudaStream_t>(stream)};
  switch (q_dtype) {
    case 0:
      return D == 64 ? launch_f32<64>(a) : launch_f32<128>(a);
    case 1:
      if (kv_kind == kF32 || kv_kind == kF16) return int(cudaErrorInvalidValue);
      return D == 64 ? launch_mma<__nv_bfloat16, 64>(a) : launch_mma<__nv_bfloat16, 128>(a);
    case 2:
      if (kv_kind == kF32 || kv_kind == kBF16) return int(cudaErrorInvalidValue);
      return D == 64 ? launch_mma<__half, 64>(a) : launch_mma<__half, 128>(a);
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* paged_verify_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
