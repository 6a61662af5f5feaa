// Attention kernels for head dims above 256, sm_90a: the forward, both
// backward sweeps and paged verify on column-chunked tiles, paged decode on
// the CUDA cores, and the merge of key splits.  Included by
// attn_fwd_wide.cu, attn_bwd_wide.cu, paged_decode_wide.cu and
// paged_verify_wide.cu, which compile side by side.
//
// Replaces, at head dims the JAX package pads to a multiple of 128 above
// 256 (flash_attention_dlrs_tpu/ops/flash_attention.py _pad_inputs), every
// TPU kernel the narrower builds replace:
//   flash_attention_dlrs_tpu/ops/fwd_kernel.py:197  _fwd_kernel       (forward; also the
//   flash_attention_dlrs_tpu/ops/fwd_mid.py:211     _mid_kernel        routes the narrower
//   flash_attention_dlrs_tpu/ops/fwd_mid.py:572     _mid_strip_kernel  forward builds carry)
//   flash_attention_dlrs_tpu/ops/fwd_small.py:69    _small_kernel
//   flash_attention_dlrs_tpu/ops/fwd_small.py:239   _small_bwd_kernel  (the sweeps below)
//   flash_attention_dlrs_tpu/ops/bwd_kernel.py:203  _bwd_dkv_kernel
//   flash_attention_dlrs_tpu/ops/bwd_kernel.py:504  _bwd_dq_kernel
//   flash_attention_dlrs_tpu/ops/bwd_fused.py:45    _bwd_fused_kernel
//   flash_attention_dlrs_tpu/ops/bwd_mid.py:76      _bwd_mid_kernel
//   flash_attention_dlrs_tpu/ops/decode.py:44       _decode_kernel     (decode and verify)
// with the narrower builds' contracts and modes: causal bottom-right, GQA,
// ragged lengths, window, softcap, ALiBi (the true bias), attention dropout
// (common.cuh's lowbias32 mask, bit for bit), segment ids and fp8 V in the
// forward; the same but fp8 V in the sweeps; every pool kind of paged.cuh,
// the softcap, ALiBi and key splits in the paged kernels, with their
// arithmetic (paged_decode.cuh says which).  D = rowsum(dO o O) is the
// narrower builds' attn_bwd_preprocess, which takes any head dim.
//
// Why not one more template instance of the narrower kernels: they hold a
// whole head row of a tile in shared memory or registers.  At d 512 a
// 128-row bf16 Q tile alone is 128 KB of the 227 KB, and a 64 x 512 fp32
// O accumulator 256 registers a thread of a warpgroup.  So here D is a
// runtime multiple of 128 (at most 1024) and the work is cut by columns:
//  * Products over the head dim (S = Q K^T, dP = dO V^T and their
//    transposes) stream both operands through shared memory in chunks of
//    128 bytes a row (64 bf16 / fp16 columns, 32 fp32), double-buffered
//    by cp.async, into a warp's 16 x 64 block of fp32 scores.
//  * Each CTA owns 64 rows and one 128-column chunk of its output (O, dQ,
//    dK or dV): the update product multiplies the 64-key tile of
//    probabilities (or dS) into that chunk only.  Scores are recomputed
//    for each output chunk: at d 512 the forward does 4 x (Q K^T) + P V,
//    2.5x the FLOPs of one pass; the dK/dV sweep runs dV and dK as
//    separate CTAs (dV needs no dP), 4 x (S + dP) + 4 x S + dV + dK =
//    14 units against 4, 3.5x; the dQ sweep 4 x (S + dP) + dQ, 3x.
//  * bf16 / fp16 run on the tensor cores (mma.sync m16n8k16, fp32
//    accumulate, ldmatrix); fp32 runs in true fp32 on the CUDA cores with
//    the same fragment layout, so masks, softmax and updates are shared.
//  * The sweeps stay deterministic: every output element has one owner and
//    every sum runs in a fixed order; there are no atomics.
// Bound on this card: at the bench models' shapes the forward and sweeps
// are bound by operations (989 TFLOP/s bf16), decode by bytes (3.35 TB/s).
// These kernels are right first; their speed is later work (ROADMAP.md).

#pragma once

#include "paged.cuh"

namespace {

constexpr int WROWS = 64;       // rows a CTA owns (q rows; keys in the dK/dV sweep)
constexpr int WKEYS = 64;       // rows of a streamed tile (keys; q rows in the dK/dV sweep)
constexpr int WCOLS = 128;      // output columns a CTA owns
constexpr int WTHREADS = 128;   // 4 warps of 16 rows
constexpr int WIDE_MAX_D = 1024;

// Route codes of the wide C entries (ops/fwd_kernel.py ROUTE_CODES,
// ops/decode.py VERIFY_ROUTE_CODES).
constexpr int kRouteWideF32 = 2, kRouteWideMma = 3;

// Whether D is a head dim of these kernels.
__host__ __device__ constexpr bool wide_head_dim(int D) {
  return D > 256 && D <= WIDE_MAX_D && D % WCOLS == 0;
}

// Shared memory of the column-chunked kernels, in bytes from an aligned
// base: two stages of each streamed operand (64 rows x 128 bytes, padded),
// the update tile (64 rows x 128 columns), fp32 P of each warp (the fp32
// route's update reads it back), six vectors of 64 (segment ids, scales,
// lse, D) and the paged tile's stored-row offsets.
template <typename T>
struct WideLayout {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int KC = 128 / int(sizeof(T));          // columns of a streamed chunk
  static constexpr int SA = KC + 16 / int(sizeof(T));      // its row stride
  static constexpr int ST = WCOLS + 16 / int(sizeof(T));   // the update tile's row stride
  static constexpr int PS = WKEYS + 4;                     // fp32 P's row stride
  static constexpr size_t CHUNK = size_t(WROWS) * SA * sizeof(T);
  static constexpr size_t A_OFF = 0;
  static constexpr size_t B_OFF = 2 * CHUNK;
  static constexpr size_t T_OFF = 4 * CHUNK;
  static constexpr size_t P_OFF = T_OFF + size_t(WKEYS) * ST * sizeof(T);
  static constexpr size_t VEC_OFF = P_OFF + (F32 ? size_t(4) * 16 * PS * 4 : 0);
  static constexpr size_t ROW_OFF = VEC_OFF + 6 * 64 * 4;
  static constexpr size_t BYTES = ROW_OFF + 64 * 8 + 64 * 4;
};

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) { return __float2half_rn(x); }

// Rows [0, 64) x columns [c0, c0 + W) of a row source of T into a shared
// tile of row stride S, 16 bytes a cp.async; `row(r)` is the row's first
// element, or null for a row of zeros.  `any` is a valid address the
// zero-filled copies name.
template <typename T, int W, int S, typename RowFn>
__device__ __forceinline__ void stage_async(T* dst, RowFn row, int c0, const void* any) {
  constexpr int EPP = 16 / int(sizeof(T));
  constexpr int PER_ROW = W / EPP;
  for (int i = threadIdx.x; i < WROWS * PER_ROW; i += WTHREADS) {
    const int r = i / PER_ROW, p = i % PER_ROW;
    const T* src = row(r);
    cp_async16(sm90::smem_u32(dst + r * S + p * EPP), src ? src + c0 + p * EPP : any, src ? 16 : 0);
  }
}

// The same from rows of any stored kind (paged.cuh PoolKind; fp8 V of the
// forward as kE4M3 / kE5M2), converted exactly to T, payloads unscaled:
// row r starts at element `off[r]` of `base` (-1: zeros), int4 rows read
// their high nibbles where `hi[r]`.  Synchronous: a __syncthreads() makes
// the tile visible.
template <typename T, int W, int S>
__device__ __forceinline__ void stage_convert(T* dst, const void* base, int kind,
                                              const long long* off, const int* hi, int c0) {
  const int eb = stored_bytes(kind);
  const int epp = 16 / eb;
  const int per_row = W / epp;
  const uint8_t* bytes = static_cast<const uint8_t*>(base);
  for (int i = threadIdx.x; i < WROWS * per_row; i += WTHREADS) {
    const int r = i / per_row, p = i % per_row;
    T* out = dst + r * S + p * epp;
    float f[16];
    if (off[r] < 0) {
#pragma unroll
      for (int e = 0; e < 16; ++e) f[e] = 0.f;
    } else {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          bytes + size_t(off[r] + c0 + p * epp) * eb);
      chunk_values(kind, raw, hi[r], f);
    }
    for (int e = 0; e < epp; ++e) out[e] = from_float<T>(f[e]);
  }
}

// Rows of T times `scale`, rounded to T (the paged kernels pre-scale q in
// its own dtype, as the TPU kernel does); null rows give zeros.
template <typename T, int W, int S, typename RowFn>
__device__ __forceinline__ void stage_scaled(T* dst, RowFn row, int c0, float scale) {
  constexpr int EPP = 16 / int(sizeof(T));
  constexpr int PER_ROW = W / EPP;
  for (int i = threadIdx.x; i < WROWS * PER_ROW; i += WTHREADS) {
    const int r = i / PER_ROW, p = i % PER_ROW;
    const T* src = row(r);
    T* out = dst + r * S + p * EPP;
    if (src == nullptr) {
#pragma unroll
      for (int e = 0; e < EPP; ++e) out[e] = from_float<T>(0.f);
      continue;
    }
    const uint4 raw = *reinterpret_cast<const uint4*>(src + c0 + p * EPP);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < EPP; ++e) out[e] = from_float<T>(to_float(v[e]) * scale);
  }
}

// A warp's 16 x 64 block of scores from one staged chunk: rows
// [16 warp, 16 warp + 16) of sA against the 64 rows of sB, over the chunk's
// KC columns, added to s.  Element (j, e) of s is row lane/4 (+8 for e >= 2)
// and column 8 j + 2 (lane % 4) + (e & 1) of the block: the mma.sync
// accumulator layout, which the fp32 route keeps.
template <typename T>
__device__ __forceinline__ void score_chunk(float (&s)[8][4], const T* sA, const T* sB,
                                            int warp, int lane) {
  using L = WideLayout<T>;
  if constexpr (L::F32) {
    const float* a0 = sA + (warp * 16 + lane / 4) * L::SA;
    const float* a1 = a0 + 8 * L::SA;
    const int cb = 2 * (lane % 4);
#pragma unroll 2
    for (int k = 0; k < L::KC; k += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(a0 + k);
      const float4 x1 = *reinterpret_cast<const float4*>(a1 + k);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 y = *reinterpret_cast<const float4*>(sB + (8 * j + cb + e) * L::SA + k);
          float t0 = s[j][e], t1 = s[j][2 + e];
          t0 = fmaf(x0.x, y.x, t0); t0 = fmaf(x0.y, y.y, t0);
          t0 = fmaf(x0.z, y.z, t0); t0 = fmaf(x0.w, y.w, t0);
          t1 = fmaf(x1.x, y.x, t1); t1 = fmaf(x1.y, y.y, t1);
          t1 = fmaf(x1.z, y.z, t1); t1 = fmaf(x1.w, y.w, t1);
          s[j][e] = t0;
          s[j][2 + e] = t1;
        }
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < L::KC / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, a_frag<L::SA>(sA, warp * 16, kk * 16, lane));
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t b[4];
        ldsm_x4(b, b_frag<L::SA>(sB, jj * 16, kk * 16, lane));
        Mma<T>::run(s[2 * jj], a, b[0], b[1]);
        Mma<T>::run(s[2 * jj + 1], a, b[2], b[3]);
      }
    }
  }
}

// s = the warp's 16 x 64 block of A B^T over `cols` columns of the head dim,
// streamed in chunks through two stages: `load_a(dst, c0)` / `load_b(dst,
// c0)` stage a chunk (cp.async ones are committed here; synchronous ones
// are made visible by the barrier).  Every thread of the CTA calls it.
template <typename T, typename LoadA, typename LoadB>
__device__ __forceinline__ void scores(float (&s)[8][4], T* sA, T* sB, LoadA load_a,
                                       LoadB load_b, int cols, int warp, int lane) {
  using L = WideLayout<T>;
  constexpr int STAGE = WROWS * L::SA;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  const int nc = cols / L::KC;
  if (nc <= 0) return;
  load_a(sA, 0);
  load_b(sB, 0);
  cp_commit();
  for (int ci = 0; ci < nc; ++ci) {
    const int st = (ci & 1) * STAGE;
    if (ci + 1 < nc) {
      const int nx = ((ci + 1) & 1) * STAGE;
      load_a(sA + nx, (ci + 1) * L::KC);
      load_b(sB + nx, (ci + 1) * L::KC);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    score_chunk(s, sA + st, sB + st, warp, lane);
    __syncthreads();
  }
}

// o (the warp's 16 rows x 128 columns) += p (its 16 x 64 block, fp32) times
// the staged 64 x 128 tile: p rounded to T on the tensor cores; in fp32
// through the warp's rows of sP (row stride PS).
template <typename T>
__device__ __forceinline__ void update_product(float (&o)[16][4], const float (&p)[8][4],
                                               const T* sT, float* sPw, int lane) {
  using L = WideLayout<T>;
  if constexpr (L::F32) {
    const int r = lane / 4, cb = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sPw[r * L::PS + 8 * j + cb] = p[j][0];
      sPw[r * L::PS + 8 * j + cb + 1] = p[j][1];
      sPw[(r + 8) * L::PS + 8 * j + cb] = p[j][2];
      sPw[(r + 8) * L::PS + 8 * j + cb + 1] = p[j][3];
    }
    __syncwarp();
#pragma unroll 2
    for (int k = 0; k < WKEYS; ++k) {
      const float p0 = sPw[r * L::PS + k], p1 = sPw[(r + 8) * L::PS + k];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(sT + k * L::ST + 8 * j + cb);
        o[j][0] = fmaf(p0, v.x, o[j][0]);
        o[j][1] = fmaf(p0, v.y, o[j][1]);
        o[j][2] = fmaf(p1, v.x, o[j][2]);
        o[j][3] = fmaf(p1, v.y, o[j][3]);
      }
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int kk = 0; kk < WKEYS / 16; ++kk) {
      const uint32_t a[4] = {Mma<T>::pack(p[2 * kk][0], p[2 * kk][1]),
                             Mma<T>::pack(p[2 * kk][2], p[2 * kk][3]),
                             Mma<T>::pack(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             Mma<T>::pack(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int jj = 0; jj < WCOLS / 16; ++jj) {
        uint32_t b[4];
        ldsm_x4_trans(b, bt_frag<L::ST>(sT, kk * 16, jj * 16, lane));
        Mma<T>::run(o[2 * jj], a, b[0], b[1]);
        Mma<T>::run(o[2 * jj + 1], a, b[2], b[3]);
      }
    }
  }
}

// A pair of fp32 values stored as T at `p` (two consecutive elements).
template <typename T>
__device__ __forceinline__ void store_pair(T* p, float x, float y) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    const uint32_t v = Mma<T>::pack(x, y);
    *reinterpret_cast<uint32_t*>(p) = v;
  }
}

// ---------------------------------------------------------------------------
// The forward and paged verify
// ---------------------------------------------------------------------------

struct WideArgs {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int v_kind;  // forward: common.cuh kVSame / kVE4M3 / kVE5M2
  int B, Hq, Hkv, Nq, Nkv, D;
  float sm_scale;
  int causal, window;
  float softcap;
  Mods md;
  // paged verify: pools of `kind` (paged.cuh), T new tokens a sequence
  int kind;
  const float *k_scales, *v_scales;
  const int *lengths, *page_table;
  int P, page_size, pages_per_seq, T, splits, pages_per_split;
  float *part_o, *part_lse;  // [splits, B * Hq * T, D] and [splits, B * Hq * T] when splits > 1
  cudaStream_t stream;
};

// The forward (PAGED false) and paged verify (PAGED true), one CTA per
// (64-row tile, output column chunk [and key split], batch x head).  The
// forward's rows are one q head's; verify's are the T x G (token, q head)
// rows of a kv head, row r = t * G + g, as the TPU kernel folds them.
template <typename T, bool PAGED>
__global__ void __launch_bounds__(WTHREADS)
wide_fwd_kernel(const WideArgs a) {
  using L = WideLayout<T>;
  extern __shared__ __align__(128) unsigned char wsmem[];
  T* sA = reinterpret_cast<T*>(wsmem + L::A_OFF);
  T* sB = reinterpret_cast<T*>(wsmem + L::B_OFF);
  T* sT = reinterpret_cast<T*>(wsmem + L::T_OFF);
  float* sP = reinterpret_cast<float*>(wsmem + L::P_OFF);
  float* vec = reinterpret_cast<float*>(wsmem + L::VEC_OFF);
  int* sColSeg = reinterpret_cast<int*>(vec);
  float* sKs = vec + 64;
  float* sVs = vec + 128;
  long long* sOff = reinterpret_cast<long long*>(wsmem + L::ROW_OFF);
  int* sHi = reinterpret_cast<int*>(sOff + 64);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = a.D;
  const int nchunks = D / WCOLS;
  const int cc = blockIdx.y % nchunks;
  const int c0 = cc * WCOLS;
  const int G = a.Hq / a.Hkv;
  const int score_cols = D;  // Q K^T runs over every column of the head dim

  int b, h = 0, kvh, m0, rows, key_lo, key_hi, split = 0, len = 0, max_len = 0, alen = 0;
  if constexpr (PAGED) {
    b = blockIdx.z / a.Hkv;
    kvh = blockIdx.z % a.Hkv;
    split = blockIdx.y / nchunks;
    m0 = blockIdx.x * WROWS;
    rows = a.T * G;
    len = a.lengths[b];
    max_len = a.pages_per_seq * a.page_size;
    alen = min(max(len, 0), max_len);
    const int t_hi = min(a.T - 1, (min(m0 + WROWS, rows) - 1) / G);
    key_lo = split * a.pages_per_split * a.page_size;
    key_hi = min(min(key_lo + a.pages_per_split * a.page_size, max_len),
                 max(0, len - a.T + 1 + t_hi));
  } else {
    b = blockIdx.z / a.Hq;
    h = blockIdx.z % a.Hq;
    kvh = h / G;
    m0 = (a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * WROWS;
    rows = a.Nq;
    const TileRange tr = kv_tiles<WROWS, WKEYS>(m0, a.Nq, a.Nkv, a.causal, a.window);
    key_lo = tr.lo * WKEYS;
    key_hi = min(tr.hi * WKEYS, a.Nkv);
  }

  // The thread's two rows (local lr[i], i = 0 / 1 for accumulator halves).
  int lrow[2], row[2], qseg[2] = {0, 0}, horizon[2] = {0, 0}, qpos[2] = {0, 0};
  float slope[2] = {0.f, 0.f};
  uint32_t stream = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lrow[i] = warp * 16 + lane / 4 + 8 * i;
    row[i] = m0 + lrow[i];
    if constexpr (PAGED) {
      const int t = row[i] / G, g = row[i] % G;
      horizon[i] = len - a.T + 1 + t;
      qpos[i] = alen - a.T + t;
      if (a.md.slopes != nullptr) slope[i] = a.md.slopes[kvh * G + g];
    } else {
      if (a.md.slopes != nullptr) slope[i] = a.md.slopes[h];
      if (a.md.q_seg != nullptr) qseg[i] = seg_id(a.md.q_seg, b, a.Nq, row[i]);
    }
  }
  if constexpr (!PAGED) {
    if (a.md.rate > 0.f) stream = dropout_stream(a.md.seed, b, h);
  }
  const bool quant = PAGED && is_quantized(a.kind);
  const bool v8 = !PAGED && a.v_kind != kVSame;

  const T* qT = static_cast<const T*>(a.q);
  const T* kT = static_cast<const T*>(a.k);
  const T* vT = static_cast<const T*>(a.v);
  auto q_row = [&](int r) -> const T* {
    const int i = m0 + r;
    if (i >= rows) return nullptr;
    if constexpr (PAGED) {
      return qT + ((size_t(b) * a.Hq + kvh * G + i % G) * a.T + i / G) * D;
    } else {
      return qT + ((size_t(b) * a.Hq + h) * a.Nq + i) * D;
    }
  };

  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
  float o[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  const size_t kv_base = (size_t(b) * a.Hkv + kvh) * size_t(a.Nkv) * D;
  for (int n0 = key_lo; n0 < key_hi; n0 += WKEYS) {
    __syncthreads();  // the previous tile is done with every buffer
    if (tid < WKEYS) {
      const int pos = n0 + tid;
      if constexpr (PAGED) {
        if (pos < key_hi) {
          const int page = a.page_table[size_t(b) * a.pages_per_seq + pos / a.page_size];
          const int off = pos % a.page_size;
          const TokenAddr ta = token_addr(a.kind, kvh, page, off, a.P, a.page_size, D);
          sOff[tid] = (long long)ta.row;
          sHi[tid] = ta.hi;
          if (is_quantized(a.kind)) {
            const size_t si = scale_index(kvh, page, off, a.P, a.page_size);
            sKs[tid] = a.k_scales[si];
            sVs[tid] = a.v_scales[si];
          }
        } else {  // past the split, the sequence or the table: no key
          sOff[tid] = -1;
          sHi[tid] = 0;
          sKs[tid] = 0.f;
          sVs[tid] = 0.f;
        }
      } else {
        if (a.md.q_seg != nullptr) sColSeg[tid] = seg_id(a.md.kv_seg, b, a.Nkv, pos);
        sOff[tid] = pos < a.Nkv ? (long long)(kv_base + size_t(pos) * D) : -1;
        sHi[tid] = 0;
      }
    }
    __syncthreads();
    auto k_row = [&](int r) -> const T* {
      return n0 + r < a.Nkv ? kT + kv_base + size_t(n0 + r) * D : nullptr;
    };
    if (!PAGED && !v8) {
      stage_async<T, WCOLS, L::ST>(
          sT, [&](int r) { return n0 + r < a.Nkv ? vT + kv_base + size_t(n0 + r) * D : nullptr; },
          c0, a.v);
    }
    float s[8][4];
    if constexpr (PAGED) {
      scores(s, sA, sB,
             [&](T* dst, int c) { stage_scaled<T, L::KC, L::SA>(dst, q_row, c, a.sm_scale); },
             [&](T* dst, int c) { stage_convert<T, L::KC, L::SA>(dst, a.k, a.kind, sOff, sHi, c); },
             score_cols, warp, lane);
      stage_convert<T, WCOLS, L::ST>(sT, a.v, a.kind, sOff, sHi, c0);
    } else {
      scores(s, sA, sB,
             [&](T* dst, int c) { stage_async<T, L::KC, L::SA>(dst, q_row, c, a.q); },
             [&](T* dst, int c) { stage_async<T, L::KC, L::SA>(dst, k_row, c, a.k); },
             score_cols, warp, lane);
      if (v8) stage_convert<T, WCOLS, L::ST>(sT, a.v, a.v_kind == kVE4M3 ? kE4M3 : kE5M2,
                                             sOff, sHi, c0);
    }

    // Scores as the plain versions make them; masked -inf.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kc = 8 * j + 2 * (lane % 4) + (e & 1);
        const int col = n0 + kc;
        float x = s[j][e];
        bool vis;
        if constexpr (PAGED) {
          if (quant) x *= sKs[kc];
          if (a.softcap > 0.f) x = a.softcap * tanhf(x * (1.f / a.softcap));
          if (a.md.slopes != nullptr) x -= slope[i] * float(qpos[i] - col);
          vis = row[i] < rows && col < key_hi && col < horizon[i];
        } else {
          x *= a.sm_scale;
          if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
          if (a.md.slopes != nullptr) x -= slope[i] * float(row[i] + a.Nkv - a.Nq - col);
          vis = visible(row[i], col, a.Nq, a.Nkv, a.causal, a.window) &&
                (a.md.q_seg == nullptr || qseg[i] == sColSeg[kc]);
        }
        s[j][e] = vis ? x : -INFINITY;
      }
    }
    // Online softmax, exact running max; the row sum is undropped and
    // unscaled, P is then dropped (forward) or times the V scale (paged).
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m_i[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          float p = expf(s[j][e] - m_use);
          sum += p;
          const int kc = 8 * j + 2 * (lane % 4) + (e & 1);
          if constexpr (PAGED) {
            if (quant) p *= sVs[kc];
          } else {
            if (a.md.rate > 0.f) p *= dropout_factor(stream, row[i], n0 + kc, a.md);
          }
          s[j][e] = p;
        }
      }
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[j][2 * i] *= alpha;
        o[j][2 * i + 1] *= alpha;
      }
    }
    __syncthreads();  // the V tile is staged
    update_product(o, s, sT, sP + warp * 16 * L::PS, lane);
  }

  // Row sums over the quad, then O / l; lse from the first column chunk.
  const bool split_out = PAGED && a.splits > 1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_i[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    if (row[i] >= rows) continue;
    size_t out_row;
    if constexpr (PAGED) {
      const int t = row[i] / G, g = row[i] % G;
      out_row = (size_t(b) * a.Hq + kvh * G + g) * a.T + t;
    } else {
      out_row = (size_t(b) * a.Hq + h) * a.Nq + row[i];
    }
    const int cb = c0 + 2 * (lane % 4);
    if (split_out) {
      float* po = a.part_o + (size_t(split) * a.B * a.Hq * a.T + out_row) * D + cb;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(po + 8 * j) = make_float2(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
      if (cc == 0 && lane % 4 == 0)
        a.part_lse[size_t(split) * a.B * a.Hq * a.T + out_row] =
            l > 0.f ? m_i[i] + logf(l) : -INFINITY;
    } else {
      T* po = static_cast<T*>(a.o) + out_row * D + cb;
#pragma unroll
      for (int j = 0; j < 16; ++j) store_pair(po + 8 * j, o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
      if (!PAGED && cc == 0 && lane % 4 == 0)
        a.lse[out_row] = l > 0.f ? m_i[i] + logf(l) : kMaskValue;
    }
  }
}

// ---------------------------------------------------------------------------
// The backward sweeps
// ---------------------------------------------------------------------------

struct WideBwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, Hq, Hkv, Nq, Nkv, D;
  float sm_scale;
  int causal, window;
  float softcap;
  Mods md;
  cudaStream_t stream;
};

// The dK/dV sweep: one CTA per (64-key tile, output column chunk and pass,
// batch x kv head).  Pass 0 keeps dV += (P o M)^T dO, pass 1 dK += dS^T Q
// (times sm_scale at the end), each for its 128 columns, over the q heads
// of the GQA group and, in order, the q tiles that see the keys.  The
// warp's rows are keys: S^T = K Q^T and dP^T = V dO^T.
template <typename T>
__global__ void __launch_bounds__(WTHREADS)
wide_bwd_dkv_kernel(const WideBwdArgs a) {
  using L = WideLayout<T>;
  extern __shared__ __align__(128) unsigned char wsmem[];
  T* sA = reinterpret_cast<T*>(wsmem + L::A_OFF);
  T* sB = reinterpret_cast<T*>(wsmem + L::B_OFF);
  T* sT = reinterpret_cast<T*>(wsmem + L::T_OFF);
  float* sP = reinterpret_cast<float*>(wsmem + L::P_OFF);
  float* vec = reinterpret_cast<float*>(wsmem + L::VEC_OFF);
  int* sQseg = reinterpret_cast<int*>(vec);
  float* sLse = vec + 64;
  float* sDelta = vec + 128;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = a.D;
  const int cc = blockIdx.y / 2, pass_dk = blockIdx.y % 2;
  const int c0 = cc * WCOLS;
  const int b = blockIdx.z / a.Hkv, kvh = blockIdx.z % a.Hkv;
  const int G = a.Hq / a.Hkv;
  const int n0 = blockIdx.x * WROWS;
  const int q_off = a.Nkv - a.Nq;
  const bool seg = a.md.q_seg != nullptr, drop = a.md.rate > 0.f;

  int key[2], kseg[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = n0 + warp * 16 + lane / 4 + 8 * i;
    if (seg) kseg[i] = seg_id(a.md.kv_seg, b, a.Nkv, key[i]);
  }
  // q rows that see any key of the tile
  int r_lo = 0, r_hi = a.Nq;
  if (a.causal) {
    r_lo = max(0, n0 - q_off);
    if (a.window > 0) r_hi = min(a.Nq, n0 + WROWS - 1 + a.window - q_off);
  }

  const T* qT = static_cast<const T*>(a.q);
  const T* kT = static_cast<const T*>(a.k);
  const T* vT = static_cast<const T*>(a.v);
  const T* dT = static_cast<const T*>(a.dout);
  const size_t kv_base = (size_t(b) * a.Hkv + kvh) * size_t(a.Nkv) * D;
  auto k_row = [&](int r) -> const T* {
    return n0 + r < a.Nkv ? kT + kv_base + size_t(n0 + r) * D : nullptr;
  };
  auto v_row = [&](int r) -> const T* {
    return n0 + r < a.Nkv ? vT + kv_base + size_t(n0 + r) * D : nullptr;
  };

  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float slope = a.md.slopes != nullptr ? a.md.slopes[h] : 0.f;
    const uint32_t stream = drop ? dropout_stream(a.md.seed, b, h) : 0u;
    const size_t q_base = (size_t(b) * a.Hq + h) * size_t(a.Nq);
    for (int m0 = (r_lo / WKEYS) * WKEYS; m0 < r_hi; m0 += WKEYS) {
      __syncthreads();  // the previous step is done with every buffer
      if (tid < WKEYS) {
        const int r = m0 + tid;
        sLse[tid] = r < a.Nq ? a.lse[q_base + r] : 0.f;
        sDelta[tid] = r < a.Nq ? a.delta[q_base + r] : 0.f;
        if (seg) sQseg[tid] = seg_id(a.md.q_seg, b, a.Nq, r);
      }
      auto q_row = [&](int r) -> const T* {
        return m0 + r < a.Nq ? qT + (q_base + m0 + r) * D : nullptr;
      };
      auto do_row = [&](int r) -> const T* {
        return m0 + r < a.Nq ? dT + (q_base + m0 + r) * D : nullptr;
      };
      if (pass_dk) {
        stage_async<T, WCOLS, L::ST>(sT, q_row, c0, a.q);
      } else {
        stage_async<T, WCOLS, L::ST>(sT, do_row, c0, a.q);
      }
      float s[8][4], dp[8][4];
      scores(s, sA, sB, [&](T* dst, int c) { stage_async<T, L::KC, L::SA>(dst, k_row, c, a.k); },
             [&](T* dst, int c) { stage_async<T, L::KC, L::SA>(dst, q_row, c, a.q); }, D, warp,
             lane);
      if (pass_dk) {
        scores(dp, sA, sB,
               [&](T* dst, int c) { stage_async<T, L::KC, L::SA>(dst, v_row, c, a.v); },
               [&](T* dst, int c) { stage_async<T, L::KC, L::SA>(dst, do_row, c, a.q); }, D,
               warp, lane);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int qc = 8 * j + 2 * (lane % 4) + (e & 1);
          const int qrow = m0 + qc;
          float xc = s[j][e] * a.sm_scale;
          if (a.softcap > 0.f) xc = a.softcap * tanhf(xc / a.softcap);
          float x = xc;
          if (a.md.slopes != nullptr) x -= slope * float(qrow + q_off - key[i]);
          const bool vis = qrow < a.Nq && visible(qrow, key[i], a.Nq, a.Nkv, a.causal, a.window) &&
                           (!seg || sQseg[qc] == kseg[i]);
          const float p = vis ? expf(x - sLse[qc]) : 0.f;
          const float keep = drop ? dropout_factor(stream, qrow, key[i], a.md) : 1.f;
          if (pass_dk) {
            float ds = p * (dp[j][e] * keep - sDelta[qc]);
            if (a.softcap > 0.f) {
              const float t = xc / a.softcap;
              ds *= 1.f - t * t;
            }
            s[j][e] = ds;
          } else {
            s[j][e] = p * keep;
          }
        }
      }
      update_product(acc, s, sT, sP + warp * 16 * L::PS, lane);
    }
  }

  const float scale = pass_dk ? a.sm_scale : 1.f;
  T* out = static_cast<T*>(pass_dk ? a.dk : a.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= a.Nkv) continue;
    T* po = out + kv_base + size_t(key[i]) * D + c0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      store_pair(po + 8 * j, acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
  }
}

// The dQ sweep: one CTA per (64-row q tile, output column chunk, batch x q
// head), walking the key tiles it sees in order; dQ += dS K for its 128
// columns, times sm_scale at the end.
template <typename T>
__global__ void __launch_bounds__(WTHREADS)
wide_bwd_dq_kernel(const WideBwdArgs a) {
  using L = WideLayout<T>;
  extern __shared__ __align__(128) unsigned char wsmem[];
  T* sA = reinterpret_cast<T*>(wsmem + L::A_OFF);
  T* sB = reinterpret_cast<T*>(wsmem + L::B_OFF);
  T* sT = reinterpret_cast<T*>(wsmem + L::T_OFF);
  float* sP = reinterpret_cast<float*>(wsmem + L::P_OFF);
  int* sColSeg = reinterpret_cast<int*>(wsmem + L::VEC_OFF);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = a.D;
  const int c0 = blockIdx.y * WCOLS;
  const int b = blockIdx.z / a.Hq, h = blockIdx.z % a.Hq;
  const int kvh = h / (a.Hq / a.Hkv);
  const int m0 = (a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * WROWS;
  const int q_off = a.Nkv - a.Nq;
  const bool seg = a.md.q_seg != nullptr, drop = a.md.rate > 0.f;
  const float slope = a.md.slopes != nullptr ? a.md.slopes[h] : 0.f;
  const uint32_t stream = drop ? dropout_stream(a.md.seed, b, h) : 0u;
  const size_t q_base = (size_t(b) * a.Hq + h) * size_t(a.Nq);

  int row[2], qseg[2] = {0, 0};
  float lse[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = m0 + warp * 16 + lane / 4 + 8 * i;
    if (row[i] < a.Nq) {
      lse[i] = a.lse[q_base + row[i]];
      delta[i] = a.delta[q_base + row[i]];
    }
    if (seg) qseg[i] = seg_id(a.md.q_seg, b, a.Nq, row[i]);
  }

  const T* qT = static_cast<const T*>(a.q);
  const T* kT = static_cast<const T*>(a.k);
  const T* vT = static_cast<const T*>(a.v);
  const T* dT = static_cast<const T*>(a.dout);
  const size_t kv_base = (size_t(b) * a.Hkv + kvh) * size_t(a.Nkv) * D;
  auto q_row = [&](int r) -> const T* {
    return m0 + r < a.Nq ? qT + (q_base + m0 + r) * D : nullptr;
  };
  auto do_row = [&](int r) -> const T* {
    return m0 + r < a.Nq ? dT + (q_base + m0 + r) * D : nullptr;
  };

  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const TileRange tr = kv_tiles<WROWS, WKEYS>(m0, a.Nq, a.Nkv, a.causal, a.window);
  for (int n0 = tr.lo * WKEYS; n0 < min(tr.hi * WKEYS, a.Nkv); n0 += WKEYS) {
    __syncthreads();  // the previous tile is done with every buffer
    if (seg && tid < WKEYS) sColSeg[tid] = seg_id(a.md.kv_seg, b, a.Nkv, n0 + tid);
    auto k_row = [&](int r) -> const T* {
      return n0 + r < a.Nkv ? kT + kv_base + size_t(n0 + r) * D : nullptr;
    };
    auto v_row = [&](int r) -> const T* {
      return n0 + r < a.Nkv ? vT + kv_base + size_t(n0 + r) * D : nullptr;
    };
    stage_async<T, WCOLS, L::ST>(sT, k_row, c0, a.k);
    float s[8][4], dp[8][4];
    scores(s, sA, sB, [&](T* dst, int c) { stage_async<T, L::KC, L::SA>(dst, q_row, c, a.q); },
           [&](T* dst, int c) { stage_async<T, L::KC, L::SA>(dst, k_row, c, a.k); }, D, warp,
           lane);
    scores(dp, sA, sB, [&](T* dst, int c) { stage_async<T, L::KC, L::SA>(dst, do_row, c, a.q); },
           [&](T* dst, int c) { stage_async<T, L::KC, L::SA>(dst, v_row, c, a.v); }, D, warp,
           lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kc = 8 * j + 2 * (lane % 4) + (e & 1);
        const int col = n0 + kc;
        float xc = s[j][e] * a.sm_scale;
        if (a.softcap > 0.f) xc = a.softcap * tanhf(xc / a.softcap);
        float x = xc;
        if (a.md.slopes != nullptr) x -= slope * float(row[i] + q_off - col);
        const bool vis = visible(row[i], col, a.Nq, a.Nkv, a.causal, a.window) &&
                         (!seg || qseg[i] == sColSeg[kc]);
        const float p = vis ? expf(x - lse[i]) : 0.f;
        const float keep = drop ? dropout_factor(stream, row[i], col, a.md) : 1.f;
        float ds = p * (dp[j][e] * keep - delta[i]);
        if (a.softcap > 0.f) {
          const float t = xc / a.softcap;
          ds *= 1.f - t * t;
        }
        s[j][e] = ds;
      }
    }
    update_product(acc, s, sT, sP + warp * 16 * L::PS, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= a.Nq) continue;
    T* po = static_cast<T*>(a.dq) + (q_base + row[i]) * D + c0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      store_pair(po + 8 * j, acc[j][2 * i] * a.sm_scale, acc[j][2 * i + 1] * a.sm_scale);
  }
}

template <typename T>
int launch_wide_bwd(const WideBwdArgs& a, bool dkv) {
  constexpr size_t smem = WideLayout<T>::BYTES;
  if (dkv) {
    auto kernel = wide_bwd_dkv_kernel<T>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    dim3 grid((a.Nkv + WROWS - 1) / WROWS, 2 * (a.D / WCOLS), a.B * a.Hkv);
    kernel<<<grid, WTHREADS, smem, a.stream>>>(a);
  } else {
    auto kernel = wide_bwd_dq_kernel<T>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    dim3 grid((a.Nq + WROWS - 1) / WROWS, a.D / WCOLS, a.B * a.Hq);
    kernel<<<grid, WTHREADS, smem, a.stream>>>(a);
  }
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Merging key splits (decode and verify)
// ---------------------------------------------------------------------------

// One CTA a row of `rows`: O = sum_s w_s O_s / sum_s w_s with w_s =
// exp(lse_s - max lse) in split order (ops/decode.py combine_partials); a
// partial of lse -inf weighs 0; a row no split saw gets O = 0 and lse
// kMaskValue.  O in `dtype` (paged.cuh store_as), lse when not null.
__global__ void __launch_bounds__(WTHREADS)
wide_combine_kernel(const float* __restrict__ part_o, const float* __restrict__ part_lse,
                    void* o, int dtype, float* lse, int rows, int splits, int D) {
  const int r = blockIdx.x;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part_lse[size_t(s) * rows + r]);
  const float m_use = m == -INFINITY ? 0.f : m;
  float w_sum = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float ls = part_lse[size_t(s) * rows + r];
    w_sum += ls == -INFINITY ? 0.f : expf(ls - m_use);
  }
  const bool seen = w_sum > 0.f;
  for (int c = threadIdx.x; c < D; c += WTHREADS) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float ls = part_lse[size_t(s) * rows + r];
      if (ls != -INFINITY) acc += expf(ls - m_use) * part_o[(size_t(s) * rows + r) * D + c];
    }
    store_as(o, size_t(r) * D + c, dtype, seen ? acc / w_sum : 0.f);
  }
  if (lse != nullptr && threadIdx.x == 0) lse[r] = seen ? m + logf(w_sum) : kMaskValue;
}

inline int launch_combine(const float* part_o, const float* part_lse, void* o, int dtype,
                          float* lse, int rows, int splits, int D, cudaStream_t stream) {
  wide_combine_kernel<<<rows, WTHREADS, 0, stream>>>(part_o, part_lse, o, dtype, lse, rows,
                                                     splits, D);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Paged decode
// ---------------------------------------------------------------------------

struct WideDecodeArgs {
  const void* q;
  int q_dtype;
  const void *k_pages, *v_pages;
  const float *k_scales, *v_scales;
  const int *lengths, *page_table;
  void* o;
  float* lse;
  float *part_o, *part_lse;  // [splits, B * Hq, D] and [splits, B * Hq] when splits > 1
  int B, Hq, Hkv, P, page_size, pages_per_seq, D, splits, pages_per_split;
  float sm_scale, softcap;
  const float* slopes;
  cudaStream_t stream;
};

constexpr int WD_HEADS = 2;                 // q heads a decode CTA serves
constexpr int WD_NB = WIDE_MAX_D / WCOLS;   // 128-column blocks of a row, at most

// Four elements (columns c .. c + 3) of a stored row of KIND at element
// `at` of `base`, as fp32 (exact), and for int8 / int4 as a __dp4a word.
template <int KIND>
__device__ __forceinline__ void four(const void* base, size_t at, int hi, float (&f)[4],
                                     uint32_t& s8) {
  if constexpr (KIND == kF32) {
    const float4 x = *reinterpret_cast<const float4*>(static_cast<const float*>(base) + at);
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  } else if constexpr (KIND == kBF16 || KIND == kF16) {
    const uint2 x = *reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(base) + at);
    const uint32_t w[2] = {x.x, x.y};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint16_t u = uint16_t(w[c / 2] >> (16 * (c % 2)));
      f[c] = KIND == kBF16 ? __bfloat162float(__ushort_as_bfloat16(u))
                           : __half2float(__ushort_as_half(u));
    }
  } else {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(static_cast<const uint8_t*>(base) + at);
    word_values(KIND, w, hi, f);
    if constexpr (KIND == kI8 || KIND == kI4) s8 = s8x4(KIND, w, hi);
  }
}

// Decode, split-KV on the CUDA cores: one CTA per (key split, kv head x
// pair of its q heads, sequence), 4 warps taking every 4th key of the
// split; lane l owns columns 128 i + 4 l .. + 3 of the row, so a warp reads
// each K / V row whole and coalesced and one shuffle tree makes a score.
// Each warp keeps its own running max, row sum and O; the warps merge in a
// fixed order at the end, and the splits in wide_combine_kernel.  The
// arithmetic is paged_decode.cuh's (value pools fp32 with P unrounded;
// quantized pools q pre-scaled in its dtype, int8 / int4 integer scores by
// __dp4a against per-row int8 q, fp8 an fp32 dot, K scales on S, V scales
// on P rounded to q's dtype).
template <int KIND>
__global__ void __launch_bounds__(WTHREADS)
wide_decode_kernel(const WideDecodeArgs a) {
  constexpr bool QUANT = is_quantized(KIND);
  constexpr bool INT = KIND == kI8 || KIND == kI4;
  extern __shared__ float sO[];  // [4 warps][WD_HEADS][D]
  __shared__ float sM[4][WD_HEADS], sL[4][WD_HEADS];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = a.D, nb = D / WCOLS;
  const int G = a.Hq / a.Hkv, ngroups = (G + WD_HEADS - 1) / WD_HEADS;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / ngroups, hg = blockIdx.y % ngroups;
  const int nh = min(WD_HEADS, G - WD_HEADS * hg);
  const int len = a.lengths[b];
  const int max_len = a.pages_per_seq * a.page_size;
  const int alen = min(max(len, 0), max_len);
  const int lo = split * a.pages_per_split * a.page_size;
  const int hi_pos = min(lo + a.pages_per_split * a.page_size, alen);
  const int dt = a.q_dtype;

  float qf[WD_HEADS][WD_NB][4];
  uint32_t q8[WD_HEADS][WD_NB];
  float qscale[WD_HEADS], slope[WD_HEADS];
#pragma unroll
  for (int hh = 0; hh < WD_HEADS; ++hh) {
    const int h = kvh * G + WD_HEADS * hg + hh;
    slope[hh] = a.slopes != nullptr && hh < nh ? a.slopes[h] : 0.f;
    float qa = 0.f;
#pragma unroll
    for (int i = 0; i < WD_NB; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = 0.f;
        if (i < nb && hh < nh) {
          x = load_as_float(a.q, (size_t(b) * a.Hq + h) * D + WCOLS * i + 4 * lane + c, dt);
          if (QUANT) x = round_to(x * a.sm_scale, dt);
        }
        qf[hh][i][c] = x;
        qa = fmaxf(qa, fabsf(x));
      }
    }
    if constexpr (INT) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) qa = fmaxf(qa, __shfl_xor_sync(0xffffffffu, qa, off));
      const float inv = qa > 0.f ? 127.f / qa : 0.f;
#pragma unroll
      for (int i = 0; i < WD_NB; ++i) {
        uint32_t w = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          w |= (uint32_t(int(rintf(qf[hh][i][c] * inv))) & 0xFFu) << (8 * c);
        q8[hh][i] = w;
      }
      qscale[hh] = qa * (1.f / 127.f);
    } else {
      qscale[hh] = 1.f;
    }
  }

  float m[WD_HEADS], l[WD_HEADS], acc[WD_HEADS][WD_NB][4];
#pragma unroll
  for (int hh = 0; hh < WD_HEADS; ++hh) {
    m[hh] = -INFINITY;
    l[hh] = 0.f;
#pragma unroll
    for (int i = 0; i < WD_NB; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[hh][i][c] = 0.f;
  }

  for (int pos = lo + warp; pos < hi_pos; pos += 4) {
    const int page = a.page_table[size_t(b) * a.pages_per_seq + pos / a.page_size];
    const int off = pos % a.page_size;
    const TokenAddr ta = token_addr(KIND, kvh, page, off, a.P, a.page_size, D);
    float ks = 1.f, vs = 1.f;
    if constexpr (QUANT) {
      const size_t si = scale_index(kvh, page, off, a.P, a.page_size);
      ks = a.k_scales[si];
      vs = a.v_scales[si];
    }
    float kf[WD_NB][4], vf[WD_NB][4];
    uint32_t k8[WD_NB], unused;
#pragma unroll
    for (int i = 0; i < WD_NB; ++i) {
      if (i < nb) {
        const size_t at = ta.row + WCOLS * i + 4 * lane;
        four<KIND>(a.k_pages, at, ta.hi, kf[i], k8[i]);
        four<KIND>(a.v_pages, at, ta.hi, vf[i], unused);
      }
    }
#pragma unroll
    for (int hh = 0; hh < WD_HEADS; ++hh) {
      float x;
      if constexpr (INT) {
        int dot = 0;
#pragma unroll
        for (int i = 0; i < WD_NB; ++i)
          if (i < nb) dot = __dp4a(int(q8[hh][i]), int(k8[i]), dot);
#pragma unroll
        for (int o2 = 16; o2 > 0; o2 >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o2);
        x = float(dot) * qscale[hh] * ks;
      } else {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < WD_NB; ++i)
          if (i < nb)
#pragma unroll
            for (int c = 0; c < 4; ++c) dot = fmaf(qf[hh][i][c], kf[i][c], dot);
#pragma unroll
        for (int o2 = 16; o2 > 0; o2 >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o2);
        x = QUANT ? dot * ks : dot * a.sm_scale;
      }
      if (a.softcap > 0.f)
        x = QUANT ? a.softcap * tanhf(x * (1.f / a.softcap)) : a.softcap * tanhf(x / a.softcap);
      if (a.slopes != nullptr) x -= slope[hh] * float(alen - 1 - pos);
      const float m_new = fmaxf(m[hh], x);
      const float alpha = expf(m[hh] - m_new);
      const float p = expf(x - m_new);
      l[hh] = l[hh] * alpha + p;
      m[hh] = m_new;
      const float pv = QUANT ? round_to(p * vs, dt) : p;
#pragma unroll
      for (int i = 0; i < WD_NB; ++i)
        if (i < nb)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[hh][i][c] = fmaf(pv, vf[i][c], acc[hh][i][c] * alpha);
    }
  }

  // The warps' states, merged in warp order.
#pragma unroll
  for (int hh = 0; hh < WD_HEADS; ++hh) {
    if (lane == 0) {
      sM[warp][hh] = m[hh];
      sL[warp][hh] = l[hh];
    }
#pragma unroll
    for (int i = 0; i < WD_NB; ++i)
      if (i < nb)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          sO[(warp * WD_HEADS + hh) * D + WCOLS * i + 4 * lane + c] = acc[hh][i][c];
  }
  __syncthreads();
  const bool split_out = a.splits > 1;
  for (int hh = 0; hh < nh; ++hh) {
    const int h = kvh * G + WD_HEADS * hg + hh;
    float mx = -INFINITY;
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, sM[w][hh]);
    const float m_use = mx == -INFINITY ? 0.f : mx;
    float wt[4], den = 0.f;
    for (int w = 0; w < 4; ++w) {
      wt[w] = sM[w][hh] == -INFINITY ? 0.f : expf(sM[w][hh] - m_use);
      den += wt[w] * sL[w][hh];
    }
    const size_t r = size_t(b) * a.Hq + h;
    for (int c = tid; c < D; c += WTHREADS) {
      float num = 0.f;
      for (int w = 0; w < 4; ++w) num += wt[w] * sO[(w * WD_HEADS + hh) * D + c];
      const float out = den > 0.f ? num / den : 0.f;
      if (split_out) {
        a.part_o[(size_t(split) * a.B * a.Hq + r) * D + c] = out;
      } else {
        store_as(a.o, r * D + c, dt, out);
      }
    }
    if (tid == 0) {
      if (split_out) {
        a.part_lse[size_t(split) * a.B * a.Hq + r] = den > 0.f ? mx + logf(den) : -INFINITY;
      } else if (a.lse != nullptr) {
        a.lse[r] = den > 0.f ? mx + logf(den) : kMaskValue;
      }
    }
  }
}

template <int KIND>
int launch_wide_decode(const WideDecodeArgs& a) {
  const int G = a.Hq / a.Hkv;
  dim3 grid(a.splits, a.Hkv * ((G + WD_HEADS - 1) / WD_HEADS), a.B);
  const size_t smem = size_t(4) * WD_HEADS * a.D * sizeof(float);
  wide_decode_kernel<KIND><<<grid, WTHREADS, smem, a.stream>>>(a);
  int err = int(cudaGetLastError());
  if (err || a.splits == 1) return err;
  return launch_combine(a.part_o, a.part_lse, a.o, a.q_dtype, a.lse, a.B * a.Hq, a.splits,
                        a.D, a.stream);
}

// Launches the forward-family kernel over `grid`.
template <typename T, bool PAGED>
int launch_wide_fwd(const WideArgs& a, dim3 grid) {
  auto kernel = wide_fwd_kernel<T, PAGED>;
  constexpr size_t smem = WideLayout<T>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, WTHREADS, smem, a.stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace
