// Multi-token paged attention (speculative verify, chunked prefill) for
// Hopper, sm_90a: the kernels, their launch and the C entry, included by
// paged_verify_d64.cu, paged_verify.cu (head dim 128), paged_verify_d256.cu
// (fp32 and bf16 q) and paged_verify_d256_f16.cu (fp16 q), which compile side
// by side.
//
// Replaces the multi-token mode of the TPU kernel
//   flash_attention_dlrs_tpu/ops/decode.py:44  _decode_kernel  (num_tokens >
//   1, s8_scores=False; called at decode.py:438 by _paged_decode, via
//   paged_verify_attention)
// for every pool kind of paged.cuh, with the logit softcap and ALiBi.
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
// Two routes, fixed by the caller from the call's types (ops/decode.py
// verify_route) and refused here when they cannot carry the call:
//  * "wgmma", bf16 / fp16 q.  Bound on this card by operations: a 256-token
//    chunk against a 2048-token context does 4 * (T*G rows) * ctx * d flops
//    per kv head against ~2 * ctx * d bytes of K/V, so the floor is the
//    tensor cores' 989 TFLOP/s.  What the design does about it: a CTA is a
//    producer warpgroup and two consumer warpgroups that own 64 of the T*G
//    rows each, so each K/V tile in shared memory serves 128 rows; S = Q K^T
//    (wgmma.m64n64k16, both operands in shared memory, K-major) and O += P V
//    (wgmma.m64n{d}k16, P from registers, V MN-major) accumulate in fp32,
//    and S of tile i is issued beside P V of tile i - 1, as in
//    attn_fwd_sm90.cuh; each consumer warpgroup stages its own Q rows (all
//    loads in flight) behind an mbarrier.  The producer fills a ring of K/V
//    stages
//    tracked by mbarriers in the 128-byte-swizzled operand layout: value
//    pools of q's dtype by TMA boxes of a 2-D map over the pool viewed as
//    [Hkv * P * page_size, d] (a tile never crosses a page), pages smaller
//    than a tile and a split's ragged last tile by 16-byte cp.asyncs at
//    each row's address (zero past the visible keys); quantized pools as
//    raw 16-byte chunks in registers, converted exactly to q's dtype and
//    stored swizzled, with the K and V scales beside them.  The serving
//    chunk (B1, T 256, G 2, Hkv 8) has only 4 such row blocks per kv head,
//    so the keys are split as decode splits them (the same planner, asked
//    for one CTA an SM, and the same lse-weighted merge, here a second
//    kernel of one warp a row: one CTA merging its row block's 128 rows at
//    the end of the launch left a serial tail): a CTA takes one row block
//    and one split, and the card gets a full wave.
//    A CTA walks only the keys its last row can see, and only a tile past
//    its warpgroup's first row's horizon (or past the split) is masked.
//    The ring has 4 stages of 64 keys, so three tiles are in flight while
//    one is computed (2 stages at d 256, where Q takes 64 KB and O 128
//    registers a consumer thread; P V is two n128 products).  The pool
//    kind, softcap and ALiBi are template flags at every head dim.
//  * "fp32", fp32 q: the CUDA cores in true fp32, one CTA of 256 threads per
//    64 rows (a 4 x 4 patch of the score tile each), no split.

#pragma once

#include "paged.cuh"

namespace {

constexpr int VBM = 64;  // rows per CTA
constexpr int VBN = 64;  // tokens per K/V tile
constexpr int F32_THREADS = 256;

// The C entry's routes (ops/decode.py VERIFY_ROUTE_CODES), and the most
// key splits the wgmma route takes (ops/decode.py VERIFY_MAX_SPLITS: two
// weights a lane in the combine kernel).
constexpr int kRouteF32 = 0, kRouteWgmma = 1;
constexpr int kMaxSplits = 64;

struct Args {
  const void* q;
  int q_dtype, kind;
  const void *k_pages, *v_pages;
  const float *k_scales, *v_scales;
  const int *lengths, *page_table;
  void* o;
  float *part_o, *part_lse;  // [splits, B * Hq * T, D] and [splits, B * Hq * T] when splits > 1
  int B, Hq, Hkv, T, P, page_size, pages_per_seq, splits, pages_per_split;
  float scale_q, softcap;
  const float* slopes;  // [Hq] ALiBi slopes, or null
  cudaStream_t stream;
};

// Positions [0, kmax) that rows [m0, min(m0 + BM, rows)) can see, at most.
template <int BM>
__device__ __forceinline__ int visible_tokens(int len, int m0, int rows, int G, int T) {
  const int last = min(m0 + BM, rows) - 1;
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
  const int kmax = visible_tokens<VBM>(len, m0, rows, G, a.T);
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
// "wgmma" route (bf16 / fp16 q)
// ---------------------------------------------------------------------------

namespace sm90 {

constexpr int V_BM = 128;  // rows a CTA: two consumer warpgroups of 64
constexpr int V_BN = 64;   // keys a K / V tile
// Registers a thread: the CTA launches with 384 x 168 (THREADS,
// LAUNCH_REGS of sm90.cuh); the producer keeps 72 for its conversions
// (int4 at d 128 spills at 64), the consumers take the rest.  setmaxnreg
// moves registers only within the launch allocation: a split that asks for
// more would hang the CTA.
constexpr int V_PRODUCER_REGS = 72, V_CONSUMER_REGS = 216;
static_assert(128 * V_PRODUCER_REGS + 256 * V_CONSUMER_REGS <= THREADS * LAUNCH_REGS,
              "the register split exceeds the CTA's registers");

// Shared memory of one CTA, in bytes from a 1024-byte aligned base: Q, the
// K stages, the V stages (each [d / 64 chunks][rows][128 bytes], swizzled),
// each stage's K and V scales, then the barriers (each consumer
// warpgroup's Q rows; per stage full and empty).
template <int D>
struct VerifyLayout {
  static constexpr int STAGES = D == 256 ? 2 : 4;  // d 256: 64 KB of Q + 128 KB of K/V
  static constexpr uint32_t Q_BYTES = V_BM * D * 2;
  static constexpr uint32_t KV_BYTES = V_BN * D * 2;
  static constexpr uint32_t K_OFF = Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t SC_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t BAR_OFF = SC_OFF + STAGES * 2 * V_BN * 4;
  static constexpr size_t BYTES = BAR_OFF + 8 * (2 + 2 * STAGES) + 1024;  // + alignment
};

// Byte offset of 16-byte unit u of row r of 64-column chunk c in a swizzled
// tile of `rows` rows.
__device__ __forceinline__ uint32_t swizzled(int rows, int c, int r, int u) {
  return c * (rows * 128) + r * 128 + ((u ^ (r & 7)) * 16);
}

// One stored 16-byte chunk c16 (elements 16 * c16 ..) of row r of a
// quantized K or V tile, converted unscaled to T into the swizzled stage.
template <typename T, int KIND>
__device__ __forceinline__ void store_converted(unsigned char* tile, int r, int c16,
                                                const uint4& raw, int hi) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t p[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float f[4];
    word_values(KIND, w[j], hi, f);
    p[2 * j] = Mma<T>::pack(f[0], f[1]);
    p[2 * j + 1] = Mma<T>::pack(f[2], f[3]);
  }
  const int c = c16 / 4, u = 2 * (c16 % 4);
  *reinterpret_cast<uint4*>(tile + swizzled(V_BN, c, r, u)) = make_uint4(p[0], p[1], p[2], p[3]);
  *reinterpret_cast<uint4*>(tile + swizzled(V_BN, c, r, u + 1)) =
      make_uint4(p[4], p[5], p[6], p[7]);
}

template <typename T, int D, int KIND, bool CAP, bool ALIBI>
__global__ void __launch_bounds__(THREADS, 1)
paged_verify_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const Args a, int tma) {
  using L = VerifyLayout<D>;
  constexpr int STAGES = L::STAGES;
  constexpr bool QUANT = is_quantized(KIND);
  constexpr int NS = V_BN / 8;  // score n-tiles of 8 keys per warp
  constexpr int NO = D / 8;     // output n-tiles per warp

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle atom
  unsigned char* const smem = smem_raw + (base - smem_u32(smem_raw));  // generic view
  const uint32_t sQ = base, sK = base + L::K_OFF, sV = base + L::V_OFF;
  const uint32_t bars = base + L::BAR_OFF;
  auto bar_q = [&](int cw) { return bars + 8u * cw; };  // a consumer warpgroup's Q rows
  auto full = [&](int s) { return bars + 8u * (2 + s); };
  auto empty = [&](int s) { return bars + 8u * (2 + STAGES + s); };
  auto stage_scales = [&](int s) {  // K's then V's, V_BN each
    return reinterpret_cast<float*>(smem + L::SC_OFF) + s * 2 * V_BN;
  };

  const int G = a.Hq / a.Hkv, rows = a.T * G;
  const int row_blocks = (rows + V_BM - 1) / V_BM;
  const int rb = blockIdx.x % row_blocks, split = blockIdx.x / row_blocks;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int m0 = rb * V_BM;
  const int ps = a.page_size;
  const int len = max(0, min(a.lengths[b], a.pages_per_seq * ps));
  const int span = a.pages_per_split * ps;  // keys of one split
  const int k_lo = split * span;
  const int k_hi = min(k_lo + span, visible_tokens<V_BM>(len, m0, rows, G, a.T));
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + V_BN - 1) / V_BN : 0;
  const size_t all_rows = size_t(a.B) * a.Hq * a.T;
  auto out_row = [&](int row) {  // row t * G + g of O [B, Hq, T, d]
    return (size_t(b) * a.Hq + kvh * G + row % G) * a.T + row / G;
  };

  if (n_tiles == 0) {  // the block's rows see no key of this split
    if (a.splits > 1) {
      for (int r = threadIdx.x; r < V_BM; r += THREADS)
        if (m0 + r < rows) a.part_lse[split * all_rows + out_row(m0 + r)] = -INFINITY;
    } else {
      for (int idx = threadIdx.x; idx < V_BM * (D / 8); idx += THREADS) {
        const int row = m0 + idx / (D / 8);
        if (row < rows)
          *reinterpret_cast<uint4*>(static_cast<T*>(a.o) + out_row(row) * D +
                                    (idx % (D / 8)) * 8) = make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_q(0), 128);  // one arrival per thread of the warpgroup
    mbar_init(bar_q(1), 128);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 128);  // one arrival per producer thread
      mbar_init(empty(s), 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: every K / V tile of the split.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(V_PRODUCER_REGS));
    const int tid = threadIdx.x;
    const int* table = a.page_table + size_t(b) * a.pages_per_seq;
    const int data_end = min(k_lo + span, len);  // keys of the split whose pages hold data
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES, n0 = k_lo + i * V_BN;
      const uint32_t parity = ((i / STAGES) & 1) ^ 1;  // passes at once on the first lap
      const uint32_t dk = sK + s * L::KV_BYTES, dv = sV + s * L::KV_BYTES;
      if constexpr (!QUANT) {
        mbar_wait(empty(s), parity);
        if (tma && n0 + V_BN <= data_end) {  // a whole tile inside one page
          if (tid == 0) {
            const int row = (kvh * a.P + table[n0 / ps]) * ps + n0 % ps;
            mbar_expect_tx(full(s), 2 * L::KV_BYTES);
#pragma unroll
            for (int c = 0; c < D / CHUNK; ++c) {
              tma_load_2d(dk + c * (V_BN * 128), &tm_k, full(s), c * CHUNK, row);
              tma_load_2d(dv + c * (V_BN * 128), &tm_v, full(s), c * CHUNK, row);
            }
          } else {
            mbar_arrive(full(s));
          }
        } else {  // each row at its own address; zero past the visible keys
          const T* kp = static_cast<const T*>(a.k_pages);
          const T* vp = static_cast<const T*>(a.v_pages);
          for (int idx = tid; idx < V_BN * (D / 8); idx += 128) {
            const int r = idx / (D / 8), u16 = idx % (D / 8), key = n0 + r;
            const bool live = key < k_hi;
            const size_t off =
                live ? (size_t(kvh * a.P + table[key / ps]) * ps + key % ps) * D + u16 * 8 : 0;
            const uint32_t at = swizzled(V_BN, u16 / 8, r, u16 % 8);
            cp_async16(dk + at, kp + off, live ? 16 : 0);
            cp_async16(dv + at, vp + off, live ? 16 : 0);
          }
          cp_async_arrive(full(s));
        }
      } else {
        // Quantized pools: the tile's stored 16-byte chunks in flight as
        // registers, converted (unscaled, exactly) into T once the stage is
        // free; zero past the visible keys.  At d 256 the tile is taken in
        // two parts of four chunks a thread, so the producer's 72 registers
        // still hold a part's loads.
        constexpr int CPR = D / 16, IT_ALL = V_BN * CPR / 128;
        constexpr int IT = IT_ALL < 4 ? IT_ALL : 4;
        const unsigned char* kb = static_cast<const unsigned char*>(a.k_pages);
        const unsigned char* vb = static_cast<const unsigned char*>(a.v_pages);
        float ks = 0.f, vs = 0.f;
        if (tid < V_BN && n0 + tid < k_hi) {
          const int key = n0 + tid;
          const size_t si = scale_index(kvh, table[key / ps], key % ps, a.P, ps);
          ks = a.k_scales[si];
          vs = a.v_scales[si];
        }
#pragma unroll
        for (int part = 0; part < IT_ALL; part += IT) {
          uint4 kr[IT], vr[IT];
          int hi[IT];
#pragma unroll
          for (int it = 0; it < IT; ++it) {
            const int idx = tid + (part + it) * 128, r = idx / CPR, c16 = idx % CPR;
            const int key = n0 + r;
            kr[it] = vr[it] = make_uint4(0, 0, 0, 0);
            hi[it] = 0;
            if (key < k_hi) {
              const TokenAddr t = token_addr(KIND, kvh, table[key / ps], key % ps, a.P, ps, D);
              kr[it] = *reinterpret_cast<const uint4*>(kb + t.row + c16 * 16);
              vr[it] = *reinterpret_cast<const uint4*>(vb + t.row + c16 * 16);
              hi[it] = t.hi;
            }
          }
          if (part == 0) mbar_wait(empty(s), parity);
#pragma unroll
          for (int it = 0; it < IT; ++it) {
            const int idx = tid + (part + it) * 128, r = idx / CPR, c16 = idx % CPR;
            store_converted<T, KIND>(smem + L::K_OFF + s * L::KV_BYTES, r, c16, kr[it], hi[it]);
            store_converted<T, KIND>(smem + L::V_OFF + s * L::KV_BYTES, r, c16, vr[it], hi[it]);
          }
        }
        if (tid < V_BN) {
          stage_scales(s)[tid] = ks;
          stage_scales(s)[V_BN + tid] = vs;
        }
        fence_proxy_async();  // the stage is read by wgmma
        mbar_arrive(full(s));
      }
    }
  } else {
    // Consumer warpgroups 0 and 1: rows [m0 + 64 * cw, + 64).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(V_CONSUMER_REGS));
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;  // accumulator row group / column pair
    const int mw = m0 + 64 * cw;
    const int row0 = mw + 16 * warp + g;  // this thread's rows: row0, row0 + 8

    // The warpgroup's 64 Q rows, pre-scaled and rounded to T (padding rows
    // zero): every load in flight before the first is used.
    {
      constexpr int IT = 64 * (D / 8) / 128;
      const T* q = static_cast<const T*>(a.q);
      const int wt = threadIdx.x % 128;
      uint4 raw[IT];
#pragma unroll
      for (int it = 0; it < IT; ++it) {
        const int idx = wt + it * 128, row = mw + idx / (D / 8);
        raw[it] = row < rows ? *reinterpret_cast<const uint4*>(q + out_row(row) * D +
                                                              (idx % (D / 8)) * 8)
                             : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int it = 0; it < IT; ++it) {
        const int idx = wt + it * 128, r = 64 * cw + idx / (D / 8), u16 = idx % (D / 8);
        const T* e = reinterpret_cast<const T*>(&raw[it]);
        uint32_t p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[i] = Mma<T>::pack(to_float(e[2 * i]) * a.scale_q, to_float(e[2 * i + 1]) * a.scale_q);
        *reinterpret_cast<uint4*>(smem + swizzled(V_BM, u16 / 8, r, u16 % 8)) =
            make_uint4(p[0], p[1], p[2], p[3]);
      }
      fence_proxy_async();  // Q is read by wgmma
      mbar_arrive(bar_q(cw));
    }

    int horizon[2], lim[2];  // keys < horizon visible; < lim visible in this split
    float slope[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      horizon[r] = row < rows ? len - (a.T - 1 - row / G) : 0;
      lim[r] = min(horizon[r], k_hi);
      slope[r] = ALIBI && row < rows ? a.slopes[kvh * G + row % G] : 0.f;
    }
    // Keys below `open` are visible to every row of the warpgroup (its first
    // row's horizon is the nearest) and lie inside the split: a tile below
    // it needs no mask.
    const int open = min(len - (a.T - 1 - mw / G), k_hi);

    float s[V_BN / 2], acc[D / 2];
    uint32_t pa[V_BN / 16][4];  // P as the A fragments of P V, 16 keys a k-step
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};  // running max, base-2 units
    float l_r[2] = {0.f, 0.f};              // this thread's share of the row sum
    float alpha[2] = {1.f, 1.f};            // O's rescale before the next P V

    const uint32_t q_rows = sQ + cw * (64 * 128);  // this warpgroup's rows of chunk 0
    auto issue_s = [&](int st) {
      const uint32_t k_tile = sK + st * L::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t in_chunk = (ks % 4) * 32;
        WgmmaSS<V_BN, T>::run(s, smem_desc(q_rows + (ks / 4) * (V_BM * 128) + in_chunk, 16, 1024),
                              smem_desc(k_tile + (ks / 4) * (V_BN * 128) + in_chunk, 16, 1024),
                              ks > 0);
      }
      wgmma_commit();
    };
    auto rescale_o = [&]() {
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        acc[4 * i] *= alpha[0];
        acc[4 * i + 1] *= alpha[0];
        acc[4 * i + 2] *= alpha[1];
        acc[4 * i + 3] *= alpha[1];
      }
    };
    auto issue_pv = [&](int st) {
      const uint32_t v_tile = sV + st * L::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < V_BN / 16; ++kk)
        WgmmaRS<D, T>::run(acc, pa[kk], smem_desc(v_tile + kk * 2048, V_BN * 128, 1024));
      wgmma_commit();
    };
    // K scale, softcap, ALiBi bias and mask of the scores of keys [n0, n0 +
    // V_BN), into base-2 units; the mask is compiled out of an open tile.
    auto scores = [&](int n0, const float* ksc, auto masked) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1), r = e >> 1;
          float x = s[4 * j + e];
          if (QUANT) x *= ksc[c];
          if (CAP) x = a.softcap * tanhf(x / a.softcap);
          if (ALIBI) x -= slope[r] * float(horizon[r] - 1 - (n0 + c));
          x *= kLog2e;
          if constexpr (decltype(masked)::value) {
            if (n0 + c >= lim[r]) x = -INFINITY;
          }
          s[4 * j + e] = x;
        }
      }
    };
    auto softmax = [&](int n0, const float* ksc) {
      const bool masked = n0 + V_BN > open;
      if (masked) {
        scores(n0, ksc, std::true_type{});
      } else {
        scores(n0, ksc, std::false_type{});
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[r], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = exp2_ftz(m_r[r] - m_use);  // 0 while the row saw nothing
        m_r[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[4 * j + e] = exp2_ftz(s[4 * j + e] - m_use);  // masked: 0
            sum += s[4 * j + e];
          }
        }
        l_r[r] = l_r[r] * alpha[r] + sum;
      }
    };
    // P (times the V scale on quantized pools) rounded to T, as P V's A
    // fragments.
    auto pack_p = [&](const float* vsc) {
#pragma unroll
      for (int kk = 0; kk < V_BN / 16; ++kk) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int c = 8 * (2 * kk + x / 2) + 2 * t;
          const float p0 = s[8 * kk + 2 * x], p1 = s[8 * kk + 2 * x + 1];
          pa[kk][x] = QUANT ? Mma<T>::pack(p0 * vsc[c], p1 * vsc[c + 1]) : Mma<T>::pack(p0, p1);
        }
      }
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    // Tile i: S(i) is issued beside P V of tile i - 1, and the softmax of
    // S(i) runs while that P V finishes; stage i - 1 is released once its
    // P V is done.
    mbar_wait(bar_q(cw), 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % STAGES, prev = (i + STAGES - 1) % STAGES;
      if (i > 0) rescale_o();
      mbar_wait(full(st), (i / STAGES) & 1);
      fence_proxy_async();  // rows written by cp.async, read by wgmma
      issue_s(st);
      if (i > 0) issue_pv(prev);
      if (i > 0) {
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      } else {
        wgmma_wait_all();
      }
      fence_regs(s);
      softmax(k_lo + i * V_BN, stage_scales(st));
      if (i > 0) {
        wgmma_wait_all();
        fence_regs(acc);
        release(empty(prev));
      }
      pack_p(stage_scales(st) + V_BN);
    }
    // n_tiles > 0 here (an empty split returned above); without the guard
    // ptxas serializes every wgmma of the kernel (C7514).
    if (n_tiles > 0) {
      const int last = (n_tiles - 1) % STAGES;
      rescale_o();
      issue_pv(last);
      wgmma_wait_all();
      fence_regs(acc);
      release(empty(last));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_r[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row0 + 8 * r;
      if (row >= rows) continue;
      const size_t orow = out_row(row);
      const float inv = l > 0.f ? 1.f / l : 0.f;
      if (a.splits == 1) {
        T* dst = static_cast<T*>(a.o) + orow * D;
#pragma unroll
        for (int j = 0; j < NO; ++j)
          *reinterpret_cast<uint32_t*>(dst + j * 8 + 2 * t) =
              Mma<T>::pack(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      } else {
        float* dst = a.part_o + (split * all_rows + orow) * D;
#pragma unroll
        for (int j = 0; j < NO; ++j)
          *reinterpret_cast<float2*>(dst + j * 8 + 2 * t) =
              make_float2(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
        if (t == 0)
          a.part_lse[split * all_rows + orow] = l > 0.f ? (m_r[r] + log2f(l)) * kLn2 : -INFINITY;
      }
    }
  }
}

}  // namespace sm90

// The merge of a split call (ops/decode.py combine_partials): one warp a
// row of O, its lanes D / 32 columns each; w_s = exp(lse_s - max lse), 0
// where split s saw nothing (its O is never used), and O = sum_s w_s O_s /
// sum_s w_s with the sum over s in split order.  A row no split saw gets O
// = 0.  Every load of a row's partials is independent of the others.
template <int D>
__global__ void __launch_bounds__(256)
paged_verify_combine_kernel(const float* __restrict__ part_o,
                            const float* __restrict__ part_lse, int splits, int rows,
                            void* __restrict__ o, int o_dtype) {
  constexpr int VEC = D / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= rows) return;
  // lane l holds the weights of splits l and l + 32 (at most 64 splits)
  float ls[2], mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int s = lane + 32 * k;
    ls[k] = s < splits ? part_lse[size_t(s) * rows + row] : -INFINITY;
    mx = fmaxf(mx, ls[k]);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float w[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) w[k] = ls[k] != -INFINITY ? expf(ls[k] - mx) : 0.f;
  float w_sum = 0.f, acc[VEC] = {};
#pragma unroll 4
  for (int s = 0; s < splits; ++s) {
    const float ws = __shfl_sync(0xffffffffu, w[s / 32], s % 32);
    const float* src = part_o + (size_t(s) * rows + row) * D + lane * VEC;
    float os[VEC];
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int j = 0; j < VEC; j += 4) {
        const float4 x = *reinterpret_cast<const float4*>(src + j);
        os[j] = x.x, os[j + 1] = x.y, os[j + 2] = x.z, os[j + 3] = x.w;
      }
    } else {
      const float2 x = *reinterpret_cast<const float2*>(src);
      os[0] = x.x, os[1] = x.y;
    }
    w_sum += ws;
    if (ws != 0.f) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = fmaf(ws, os[j], acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    store_as(o, size_t(row) * D + lane * VEC + j, o_dtype, w_sum > 0.f ? acc[j] / w_sum : 0.f);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename T, int D, int KIND>
int launch_wgmma(const Args& a) {
  using namespace sm90;
  // Value pools whose pages hold whole tiles are read by TMA boxes.
  CUtensorMap tm_k{}, tm_v{};
  int tma = 0;
  if (!is_quantized(KIND) && a.page_size % V_BN == 0) {
    const size_t pool_rows = size_t(a.Hkv) * a.P * a.page_size;
    if (!encode_map_2d<T>(&tm_k, a.k_pages, D, pool_rows, V_BN) ||
        !encode_map_2d<T>(&tm_v, a.v_pages, D, pool_rows, V_BN))
      return int(cudaErrorInvalidValue);
    tma = 1;
  }
  auto run = [&](auto kernel) {
    constexpr size_t smem = VerifyLayout<D>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    const int row_blocks = (a.T * (a.Hq / a.Hkv) + V_BM - 1) / V_BM;
    dim3 grid(row_blocks * a.splits, a.Hkv, a.B);
    kernel<<<grid, THREADS, smem, a.stream>>>(tm_k, tm_v, a, tma);
    err = cudaGetLastError();
    if (err != cudaSuccess || a.splits == 1) return int(err);
    const int all_rows = a.B * a.Hq * a.T;
    paged_verify_combine_kernel<D><<<(all_rows + 7) / 8, 256, 0, a.stream>>>(
        a.part_o, a.part_lse, a.splits, all_rows, a.o, a.q_dtype);
    return int(cudaGetLastError());
  };
  const bool cap = a.softcap > 0.f, alibi = a.slopes != nullptr;
  if (cap)
    return alibi ? run(paged_verify_wgmma_kernel<T, D, KIND, true, true>)
                 : run(paged_verify_wgmma_kernel<T, D, KIND, true, false>);
  return alibi ? run(paged_verify_wgmma_kernel<T, D, KIND, false, true>)
               : run(paged_verify_wgmma_kernel<T, D, KIND, false, false>);
}

// The pool kinds the wgmma route takes from q of type T: T's own values and
// every quantized kind.
template <typename T, int D>
int launch_wgmma_kind(const Args& a) {
  constexpr int SELF = std::is_same<T, __half>::value ? kF16 : kBF16;
  switch (a.kind) {
    case SELF: return launch_wgmma<T, D, SELF>(a);
    case kI8: return launch_wgmma<T, D, kI8>(a);
    case kI4: return launch_wgmma<T, D, kI4>(a);
    case kE4M3: return launch_wgmma<T, D, kE4M3>(a);
    case kE5M2: return launch_wgmma<T, D, kE5M2>(a);
    default: return int(cudaErrorInvalidValue);
  }
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

// q_dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q and O).  kv_kind: a
// PoolKind of paged.cuh; a bf16/fp16 value pool must be q's dtype.
// page_size is the LOGICAL page size.  Quantized kinds need k_scales and
// v_scales [Hkv, P, page_size] fp32.  scale_q is sm_scale rounded to q's
// dtype.  slopes: [Hq] fp32 ALiBi slopes on the device, or null.  splits:
// the key splits of paged.cuh (1 to pages_per_seq, as ops/decode.py
// decode_splits gives them, at most kMaxSplits); above 1 part_o [splits,
// B, Hq, T, D] and part_lse [splits, B, Hq, T] fp32 scratch, and the
// combine kernel is launched after the kernel on the same stream.  route:
// kRouteF32 (fp32 q, one split) or kRouteWgmma (bf16 / fp16 q); a route
// that cannot carry the call returns cudaErrorInvalidValue, never another
// route.  Pools and q must be
// 16-byte aligned.  Returns cudaGetLastError() after the launches (0 on
// success); launches nothing for an empty problem.  D must be DIM, the
// build's head dim.  Q_TYPES: the q dtypes the build carries, a mask of
// 1 << q_dtype (every one but at d 256, whose fp16-q instances compile in
// paged_verify_d256_f16.cu beside the others); another returns
// cudaErrorInvalidValue.
template <int DIM, int Q_TYPES = 7>
int paged_verify_entry(const void* q, int q_dtype, const void* k_pages,
                       const void* v_pages, int kv_kind, const float* k_scales,
                       const float* v_scales, const int* lengths, const int* page_table,
                       void* o, float* part_o, float* part_lse, int B, int Hq, int Hkv,
                       int T, int P, int page_size, int pages_per_seq, int D, int splits,
                       float scale_q, float softcap, const float* slopes, int route,
                       void* stream) {
  if (B <= 0 || Hq <= 0 || T <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || page_size <= 0 || pages_per_seq <= 0 ||
      kv_kind < kF32 || kv_kind > kE5M2 || (kv_kind == kI4 && page_size % 2) ||
      (is_quantized(kv_kind) && (k_scales == nullptr || v_scales == nullptr)) ||
      D != DIM || splits < 1 || splits > pages_per_seq ||
      (splits > 1 && (part_o == nullptr || part_lse == nullptr)))
    return int(cudaErrorInvalidValue);
  const int per = (pages_per_seq + splits - 1) / splits;
  if ((pages_per_seq + per - 1) / per != splits) return int(cudaErrorInvalidValue);
  const Args a{q, q_dtype, kv_kind, k_pages, v_pages, k_scales, v_scales, lengths,
               page_table, o, part_o, part_lse, B, Hq, Hkv, T, P, page_size, pages_per_seq,
               splits, per, scale_q, softcap, slopes, static_cast<cudaStream_t>(stream)};
  if (q_dtype < 0 || q_dtype > 2 || !(Q_TYPES >> q_dtype & 1))
    return int(cudaErrorInvalidValue);
  if constexpr (Q_TYPES & 1) {
    if (route == kRouteF32 && q_dtype == 0 && splits == 1) return launch_f32<DIM>(a);
  }
  if (route == kRouteWgmma && splits > kMaxSplits) return int(cudaErrorInvalidValue);
  if constexpr (Q_TYPES & 2) {
    if (route == kRouteWgmma && q_dtype == 1) return launch_wgmma_kind<__nv_bfloat16, DIM>(a);
  }
  if constexpr (Q_TYPES & 4) {
    if (route == kRouteWgmma && q_dtype == 2) return launch_wgmma_kind<__half, DIM>(a);
  }
  return int(cudaErrorInvalidValue);
}

// Dynamic shared memory of the route's kernel at head dim D, in bytes; 0
// for a pair no kernel of the build takes.
template <int DIM, int Q_TYPES = 7>
int paged_verify_shared_bytes_entry(int route, int D) {
  if (D != DIM) return 0;
  if (route == kRouteF32) return Q_TYPES & 1 ? int(f32_smem_bytes<DIM>()) : 0;
  if (route == kRouteWgmma) return int(sm90::VerifyLayout<DIM>::BYTES);
  return 0;
}

}  // namespace
