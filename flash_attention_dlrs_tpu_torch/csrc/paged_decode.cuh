// Paged decode attention for Hopper, sm_90a: split-KV on asynchronous page
// copies.  The kernel, its launch and the C entry, included by
// paged_decode_d64.cu, paged_decode.cu (head dim 128) and
// paged_decode_d256.cu, which compile side by side.
//
// Replaces the single-token path of the TPU kernel
//   flash_attention_dlrs_tpu/ops/decode.py:44  _decode_kernel  (called at
//   decode.py:438 by _paged_decode, via paged_decode_attention)
// for every pool kind of paged.cuh: float32 / bfloat16 / float16 values and
// int8 / packed int4 / fp8 (e4m3fn, e5m2) payloads with per-token scales,
// with the logit softcap and ALiBi.  Its multi-token verify mode is
// paged_verify.cuh.
//
// Computes, for each sequence b and q head h,
//   O[b, h] = softmax(S[b, h, :len]) V[b, :len]
// where K/V rows are gathered through the page table.  q is [B, Hq, d];
// lengths [B] int32 (clamped to pages_per_seq * page_size); page_table
// [B, pages_per_seq] int32.  Optionally writes the natural-base logsumexp
// per (b, h).  A sequence of length 0 gets O = 0 and lse = kMaskValue.
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
//  shifted by +m_h * (len - 1), the JAX convention).
//
// Bound on this card.  Decode is bound by bytes: every step reads each live
// K/V row once (2 * len * d * bytes per kv head, plus 8 bytes of scales per
// token when quantized) and does about 2 operations per byte of bf16 K/V,
// far below the ~295 at which the tensor cores would matter, so the
// products stay on the CUDA cores and the design is about keeping the
// memory system busy.  The floor is those bytes over 3.35 TB/s.
// What the design does about it:
//  * Split-KV.  The grid is (splits x head pairs, Hkv, B): the host's
//    planner (ops/decode.py decode_splits, static shapes only) cuts each
//    page table into runs of whole pages so that a small batch still puts
//    about two CTAs on every SM.  One CTA serves two q heads of a GQA group,
//    so each K/V row is read from device memory once per step at G <= 2
//    (and from L2 by the neighbouring CTA beyond).  A CTA whose split
//    begins past its sequence's length exits at once with an empty partial;
//    the last CTA of each (b, kv head, head pair) to finish merges the
//    splits in split order (merge_rows), so a call is one launch.
//  * Asynchronous page copies.  K, V (and the scales) of a tile of 64 stored
//    rows land in a ring of 2-4 shared-memory stages tracked by mbarriers,
//    STAGES - 1 tiles in flight while one is computed.  A tile inside one
//    page is one 1-D bulk copy per tensor (a kv head's run of a page is
//    contiguous in the [Hkv, P, rows, d] pool); with pages smaller than the
//    tile each row takes 16-byte cp.asyncs at its own address.  K and V
//    stay in their stored type in shared memory and are converted in
//    registers; an int4 row is staged once and both its tokens are read
//    from it.
//  * No per-tile softmax barrier.  The 256 threads are 32 groups of 8
//    lanes; a group takes every 32nd row of each tile, its lanes d / 8
//    columns each (16-byte reads of one row), and keeps its own running
//    max, row sum and O for the CTA's two heads; the groups' states are
//    merged once at the end in a fixed order.  Each lane's work on a tile
//    is a chain of dependent shuffles and FMAs, so the CTA is wide (8
//    warps, two CTAs an SM) to hide their latency.  int8 / int4 scores stay
//    __dp4a; their V values convert by a byte permute (paged.cuh
//    word_values).
//  * The softcap and ALiBi are template flags, not per-score branches.
//  * Head dims 64, 128 and 256.  At d 256 (Gemma) a lane owns 32 columns,
//    so its q, O and row values take most of its registers: one CTA an SM
//    (255 registers a thread), and the ring keeps 128 KB of stages (fp32 1,
//    16-bit 2, 1-byte kinds 4); the softcap and ALiBi are flags there too.
// What is left: a small call (8 sequences of 2048 tokens of int8) takes
// ~15 us beyond its bytes whatever its arithmetic (copies of the kernel
// without the scores, or without P V, take as long): the prologue, the
// first cold page copies and the merge's round trips, which no split
// count hides.
// It does not carry over the TPU's cross-cell DMA hand-off, which relied on
// a strictly sequential grid; CUDA blocks run in no order.

#pragma once

#include "paged.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int GROUPS = THREADS / 8;   // 8 lanes each
constexpr int TILE = 64;              // stored rows a stage
constexpr int PASSES = TILE / GROUPS;  // rows of a tile each group takes
constexpr int HB = 2;                 // q heads a CTA serves

struct Args {
  const void* q;
  int q_dtype;
  const void *k_pages, *v_pages;
  const float *k_scales, *v_scales;
  const int *lengths, *page_table;
  void* o;
  float* lse;
  float *part_o, *part_lse;  // [splits, B * Hq, D] and [splits, B * Hq] when splits > 1
  unsigned* counters;        // [B * Hkv * head pairs], zero between calls, when splits > 1
  int B, Hq, Hkv, P, page_size, pages_per_seq, splits, pages_per_split;
  float sm_scale, softcap;
  const float* slopes;
  cudaStream_t stream;
};

// Shared memory of one CTA, in bytes from a 128-byte aligned base: the K and
// V stages (stored rows as they are in the pool), each stage's scales (K
// and V, low then high nibble's token for int4), q in lane order (fp32, and
// int8 words on the integer route), the groups' running maxima, the warps'
// merged O and row sums, then the stages' full barriers.
template <int KIND, int D>
struct Geometry {
  static constexpr int EB = stored_bytes(KIND);
  static constexpr bool QUANT = is_quantized(KIND);
  static constexpr bool INT_ROUTE = KIND == kI8 || KIND == kI4;
  static constexpr int NTOK = KIND == kI4 ? 2 : 1;  // tokens a stored row holds
  static constexpr int ROW_BYTES = D * EB;
  static constexpr int CB = ROW_BYTES / 8 < 16 ? ROW_BYTES / 8 : 16;  // bytes a lane reads at once
  static constexpr int NCH = ROW_BYTES / (8 * CB);  // reads a lane makes of a row
  static constexpr int VEC = CB / EB;               // elements of one read
  static constexpr int E = D / 8;                   // elements (columns) a lane owns
  static constexpr int STAGES = D == 256 ? (EB == 1 ? 4 : EB == 2 ? 2 : 1)
                                           : (EB == 1 ? 4 : EB == 2 ? 3 : 2);
  static constexpr uint32_t TILE_BYTES = TILE * ROW_BYTES;
  static constexpr uint32_t SC_BYTES = QUANT ? 2 * NTOK * TILE * 4 : 0;
  static constexpr uint32_t V_OFF = STAGES * TILE_BYTES;
  static constexpr uint32_t SC_OFF = 2 * STAGES * TILE_BYTES;
  static constexpr uint32_t Q_OFF = SC_OFF + STAGES * SC_BYTES;
  static constexpr uint32_t QI_OFF = Q_OFF + HB * D * 4;
  static constexpr uint32_t QC_OFF = QI_OFF + HB * D;
  static constexpr uint32_t M_OFF = QC_OFF + 16;
  static constexpr uint32_t ACC_OFF = M_OFF + GROUPS * HB * 4;
  static constexpr uint32_t L_OFF = ACC_OFF + (THREADS / 32) * HB * D * 4;
  static constexpr uint32_t BAR_OFF = (L_OFF + (THREADS / 32) * HB * 4 + 7) & ~7u;
  static constexpr size_t BYTES = BAR_OFF + 8 * STAGES;
};

// Column of element e (< D / 8) of lane l of a group.
template <int KIND, int D>
__device__ __forceinline__ int lane_col(int l, int e) {
  using Geo = Geometry<KIND, D>;
  return (l + 8 * (e / Geo::VEC)) * Geo::VEC + e % Geo::VEC;
}

// One lane's share of a stored row: NCH reads of CB bytes, as 32-bit words.
template <int KIND, int D>
__device__ __forceinline__ void read_row(const unsigned char* row, int l,
                                         uint32_t (&w)[D / 8 * stored_bytes(KIND) / 4]) {
  using Geo = Geometry<KIND, D>;
  constexpr int WPR = Geo::CB / 4;  // words a read
#pragma unroll
  for (int k = 0; k < Geo::NCH; ++k) {
    const unsigned char* p = row + (l + 8 * k) * Geo::CB;
    if constexpr (Geo::CB == 16) {
      const uint4 x = *reinterpret_cast<const uint4*>(p);
      w[k * WPR] = x.x;
      w[k * WPR + 1] = x.y;
      w[k * WPR + 2] = x.z;
      w[k * WPR + 3] = x.w;
    } else {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      w[k * WPR] = x.x;
      w[k * WPR + 1] = x.y;
    }
  }
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

__device__ __forceinline__ int group_sum(int x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

template <int KIND, int D, bool CAP, bool ALIBI>
__global__ void __launch_bounds__(THREADS, D == 256 ? 1 : 2)
paged_decode_kernel(const Args a, int bulk) {
  using Geo = Geometry<KIND, D>;
  constexpr bool QUANT = Geo::QUANT;
  constexpr bool INT_ROUTE = Geo::INT_ROUTE;
  constexpr int NTOK = Geo::NTOK;
  constexpr int E = Geo::E;
  constexpr int NW = E * Geo::EB / 4;  // words of a lane's share of a row
  constexpr int STAGES = Geo::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = tid / 8, l8 = tid % 8;
  const int G = a.Hq / a.Hkv, HG = (G + HB - 1) / HB;
  const int hg = blockIdx.x % HG, split = blockIdx.x / HG;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int nh = min(HB, G - hg * HB);
  const size_t out_row = size_t(b) * a.Hq + kvh * G + hg * HB;  // (b, first head)
  const size_t part_row = size_t(split) * a.B * a.Hq + out_row;
  const int ps = a.page_size;
  const int len = max(0, min(a.lengths[b], a.pages_per_seq * ps));
  const int p_lo = split * a.pages_per_split;
  // The last CTA of the group merges the splits' partials.
  auto merge = [&]() {
    unsigned* counter = a.counters + (size_t(b) * a.Hkv + kvh) * HG + hg;
    if (last_of_group(counter, a.splits))
      merge_rows(a.part_o, a.part_lse, a.splits, size_t(a.B) * a.Hq, nh, D,
                 [&](int h) { return out_row + h; }, a.o, a.q_dtype, a.lse,
                 reinterpret_cast<float*>(smem));  // the stages are free
  };
  if (p_lo * ps >= len) {  // no token of the sequence in this split
    if (a.splits > 1) {
      if (tid < nh) a.part_lse[part_row + tid] = -INFINITY;
      merge();
    } else {
      for (int i = tid; i < nh * D; i += THREADS) store_as(a.o, out_row * D + i, a.q_dtype, 0.f);
      if (a.lse != nullptr && tid < nh) a.lse[out_row + tid] = kMaskValue;
    }
    return;
  }
  // Stored rows of this split that hold a token below len: whole pages,
  // then the last page's first rows.
  const int SR = KIND == kI4 ? ps / 2 : ps;
  const int p_end = min(min(a.pages_per_seq, p_lo + a.pages_per_split), (len + ps - 1) / ps);
  const int n_rows = (p_end - 1 - p_lo) * SR + min(SR, len - (p_end - 1) * ps);
  const int n_tiles = (n_rows + TILE - 1) / TILE;
  const int* table = a.page_table + size_t(b) * a.pages_per_seq;
  const unsigned char* kb = static_cast<const unsigned char*>(a.k_pages);
  const unsigned char* vb = static_cast<const unsigned char*>(a.v_pages);

  const uint32_t s_base = sm90::smem_u32(smem);
  auto full = [&](int s) { return s_base + Geo::BAR_OFF + 8u * s; };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) sm90::mbar_init(full(s), bulk ? 1 : THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // Tile t (stored rows [t * TILE, + TILE) of the split) into stage t % STAGES.
  auto issue = [&](int t) {
    const int s = t % STAGES, v0 = t * TILE;
    const uint32_t dk = s_base + s * Geo::TILE_BYTES;
    const uint32_t dv = dk + Geo::V_OFF;
    const uint32_t dsc = s_base + Geo::SC_OFF + s * Geo::SC_BYTES;
    if (bulk) {  // the tile lies inside one page
      if (tid == 0) {
        const int page = table[p_lo + v0 / SR], r0 = v0 % SR;
        const size_t row = (size_t(kvh) * a.P + page) * SR + r0;
        sm90::fence_proxy_async();  // the stage's last reads come first
        sm90::mbar_expect_tx(full(s), 2 * Geo::TILE_BYTES + Geo::SC_BYTES);
        bulk_copy(dk, kb + row * Geo::ROW_BYTES, Geo::TILE_BYTES, full(s));
        bulk_copy(dv, vb + row * Geo::ROW_BYTES, Geo::TILE_BYTES, full(s));
        if constexpr (QUANT) {
#pragma unroll
          for (int tok = 0; tok < NTOK; ++tok) {
            const size_t si = scale_index(kvh, page, r0 + tok * SR, a.P, ps);
            bulk_copy(dsc + tok * TILE * 4, a.k_scales + si, TILE * 4, full(s));
            bulk_copy(dsc + (NTOK + tok) * TILE * 4, a.v_scales + si, TILE * 4, full(s));
          }
        }
      }
    } else {  // rows at their own addresses
      constexpr int CPR = Geo::ROW_BYTES / 16;
      for (int idx = tid; idx < TILE * CPR; idx += THREADS) {
        const int r = idx / CPR, c = idx % CPR, v = v0 + r;
        if (v < n_rows) {
          const size_t row = (size_t(kvh) * a.P + table[p_lo + v / SR]) * SR + v % SR;
          cp_async16(dk + r * Geo::ROW_BYTES + c * 16, kb + row * Geo::ROW_BYTES + c * 16, 16);
          cp_async16(dv + r * Geo::ROW_BYTES + c * 16, vb + row * Geo::ROW_BYTES + c * 16, 16);
        }
      }
      if constexpr (QUANT) {
        for (int idx = tid; idx < NTOK * TILE; idx += THREADS) {
          const int tok = idx / TILE, r = idx % TILE, v = v0 + r;
          if (v < n_rows) {
            const size_t si = scale_index(kvh, table[p_lo + v / SR], v % SR + tok * SR, a.P, ps);
            cp_async4(dsc + (tok * TILE + r) * 4, a.k_scales + si);
            cp_async4(dsc + ((NTOK + tok) * TILE + r) * 4, a.v_scales + si);
          }
        }
      }
      cp_async_arrive(full(s));
    }
  };

  // q of the CTA's heads in lane order (float4 (e / 4) * 8 + l holds lane
  // l's elements e..e+3); quantized pools: pre-scaled in q's dtype.
  float* sQ = reinterpret_cast<float*>(smem + Geo::Q_OFF);
  uint32_t* sQi = reinterpret_cast<uint32_t*>(smem + Geo::QI_OFF);
  float* sQc = reinterpret_cast<float*>(smem + Geo::QC_OFF);
  for (int i = tid; i < HB * D; i += THREADS) {
    const int h = i / D, c = i % D;
    float x = 0.f;
    if (h < nh) {
      x = load_as_float(a.q, out_row * D + i, a.q_dtype);
      if (QUANT) x = round_to(x * a.sm_scale, a.q_dtype);
    }
    const int ci = c / Geo::VEC, e = (ci / 8) * Geo::VEC + c % Geo::VEC;
    sQ[h * D + ((e / 4) * 8 + ci % 8) * 4 + e % 4] = x;
  }
  __syncthreads();  // q staged, barriers initialised
  for (int t = 0; t < min(STAGES - 1, n_tiles); ++t) issue(t);

  if (INT_ROUTE) {
    // Each head's q row as int8 words in lane order: word (e / 4) * 8 + l.
    for (int h = warp; h < HB; h += THREADS / 32) {
      const float* qh = sQ + h * D;
      float qa = 0.f;
      for (int c = lane; c < D; c += 32) qa = fmaxf(qa, fabsf(qh[c]));
#pragma unroll
      for (int off = 16; off > 0; off /= 2) qa = fmaxf(qa, __shfl_xor_sync(0xffffffffu, qa, off));
      const float inv = qa > 0.f ? 127.f / qa : 0.f;
      for (int w = lane; w < D / 4; w += 32) {  // w = (e / 4) * 8 + l
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int v = __float2int_rn(qh[w * 4 + j] * inv);
          word |= (uint32_t(v) & 0xFFu) << (8 * j);
        }
        sQi[h * (D / 4) + w] = word;
      }
      if (lane == 0) sQc[h] = qa * (1.0f / 127.0f);
    }
    __syncthreads();
  }
  float qf[HB][INT_ROUTE ? 1 : E];
  uint32_t qw[HB][INT_ROUTE ? E / 4 : 1];
  float qc[HB], slope[HB];
#pragma unroll
  for (int h = 0; h < HB; ++h) {
    if constexpr (INT_ROUTE) {
#pragma unroll
      for (int w = 0; w < E / 4; ++w) qw[h][w] = sQi[h * (D / 4) + w * 8 + l8];
      qc[h] = sQc[h];
    } else {
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        const float4 x = *reinterpret_cast<const float4*>(sQ + h * D + ((e / 4) * 8 + l8) * 4);
        qf[h][e] = x.x;
        qf[h][e + 1] = x.y;
        qf[h][e + 2] = x.z;
        qf[h][e + 3] = x.w;
      }
    }
    slope[h] = ALIBI && h < nh ? a.slopes[kvh * G + hg * HB + h] : 0.f;
  }

  float m[HB], l[HB], acc[HB][E];
#pragma unroll
  for (int h = 0; h < HB; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[h][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    // the stage refilled here was released by the barrier that ended tile t - 1
    if (t + STAGES - 1 < n_tiles) issue(t + STAGES - 1);
    const int s = t % STAGES;
    sm90::mbar_wait(full(s), (t / STAGES) & 1);
    const unsigned char* tk = smem + s * Geo::TILE_BYTES;
    const unsigned char* tv = tk + Geo::V_OFF;
    const float* tsc = reinterpret_cast<const float*>(smem + Geo::SC_OFF + s * Geo::SC_BYTES);

    // Scores of the group's rows (every token, in every lane of the group).
    float sc[PASSES][NTOK][HB];
    int pos0[PASSES];  // position of each row's first token, -1 past the split's rows
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int r = p * GROUPS + gid, v = t * TILE + r;
      pos0[p] = v < n_rows ? (p_lo + v / SR) * ps + v % SR : -1;
      uint32_t kw[NW];
      read_row<KIND, D>(tk + r * Geo::ROW_BYTES, l8, kw);
#pragma unroll
      for (int tok = 0; tok < NTOK; ++tok) {
        float kf[INT_ROUTE ? 1 : E];
        if constexpr (!INT_ROUTE) row_values<KIND>(kw, 0, kf);
        const float ks = QUANT ? tsc[tok * TILE + r] : 1.f;
        const int pos = pos0[p] + tok * SR;
#pragma unroll
        for (int h = 0; h < HB; ++h) {
          float x;
          if constexpr (INT_ROUTE) {
            int d = 0;
#pragma unroll
            for (int w = 0; w < E / 4; ++w)
              d = __dp4a(int(qw[h][w]), int(s8x4(KIND, kw[w], tok)), d);
            x = float(group_sum(d)) * qc[h] * ks;
          } else {
            float d0 = 0.f, d1 = 0.f;  // two FMA chains
#pragma unroll
            for (int e = 0; e < E; e += 2) {
              d0 = fmaf(qf[h][e], kf[e], d0);
              d1 = fmaf(qf[h][e + 1], kf[e + 1], d1);
            }
            const float dot = group_sum(d0 + d1);
            x = QUANT ? dot * ks : dot * a.sm_scale;
          }
          if (CAP) x = a.softcap * tanhf(x / a.softcap);
          if (ALIBI) x -= slope[h] * float(len - 1 - pos);
          sc[p][tok][h] = pos0[p] >= 0 && pos < len ? x : -INFINITY;
        }
      }
    }
    // The group's running max over the tile's rows; O and the row sum rescaled.
#pragma unroll
    for (int h = 0; h < HB; ++h) {
      float mt = m[h];
#pragma unroll
      for (int p = 0; p < PASSES; ++p)
#pragma unroll
        for (int tok = 0; tok < NTOK; ++tok) mt = fmaxf(mt, sc[p][tok][h]);
      if (mt > m[h]) {
        const float alpha = __expf(m[h] - mt);  // 0 while the group saw nothing
        l[h] *= alpha;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[h][e] *= alpha;
        m[h] = mt;
      }
    }
    // P V.  Quantized pools: the row sum takes P, the product P * v_scale
    // rounded to q's dtype.
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      if (pos0[p] < 0) continue;
      const int r = p * GROUPS + gid;
      uint32_t vw[NW];
      read_row<KIND, D>(tv + r * Geo::ROW_BYTES, l8, vw);
#pragma unroll
      for (int tok = 0; tok < NTOK; ++tok) {
        if (pos0[p] + tok * SR >= len) continue;
        float vf[E];
        row_values<KIND>(vw, tok, vf);
        const float vs = QUANT ? tsc[(NTOK + tok) * TILE + r] : 1.f;
#pragma unroll
        for (int h = 0; h < HB; ++h) {
          const float pe = __expf(sc[p][tok][h] - m[h]);
          l[h] += pe;
          const float pv = QUANT ? round_to(pe * vs, a.q_dtype) : pe;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[h][e] = fmaf(pv, vf[e], acc[h][e]);
        }
      }
    }
    __syncthreads();  // every group is done with stage s
  }

  // Merge the groups' states in a fixed order: the CTA's max, each
  // group rescaled to it, summed within a warp (lanes 8 and 16 apart), then
  // across the warps.
  float* sM = reinterpret_cast<float*>(smem + Geo::M_OFF);
  float* sAcc = reinterpret_cast<float*>(smem + Geo::ACC_OFF);
  float* sL = reinterpret_cast<float*>(smem + Geo::L_OFF);
  if (l8 == 0) {
#pragma unroll
    for (int h = 0; h < HB; ++h) sM[gid * HB + h] = m[h];
  }
  __syncthreads();
  float mx[HB];
#pragma unroll
  for (int h = 0; h < HB; ++h) {
    mx[h] = -INFINITY;
    for (int g = 0; g < GROUPS; ++g) mx[h] = fmaxf(mx[h], sM[g * HB + h]);
    const float f = m[h] == -INFINITY ? 0.f : __expf(m[h] - mx[h]);
    l[h] *= f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float x = acc[h][e] * f;
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      acc[h][e] = x + __shfl_xor_sync(0xffffffffu, x, 16);
    }
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 8);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 16);
  }
  if (lane < 8) {
#pragma unroll
    for (int h = 0; h < HB; ++h) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        sAcc[(warp * HB + h) * D + lane_col<KIND, D>(lane, e)] = acc[h][e];
      if (lane == 0) sL[warp * HB + h] = l[h];
    }
  }
  __syncthreads();
  for (int i = tid; i < nh * D; i += THREADS) {
    const int h = i / D, c = i % D;
    float sum_l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      sum_l += sL[w * HB + h];
      o += sAcc[(w * HB + h) * D + c];
    }
    const bool seen = sum_l > 0.f;
    if (a.splits == 1) {
      store_as(a.o, out_row * D + i, a.q_dtype, seen ? o / sum_l : 0.f);
      if (a.lse != nullptr && c == 0) a.lse[out_row + h] = seen ? mx[h] + logf(sum_l) : kMaskValue;
    } else {
      a.part_o[part_row * D + i] = seen ? o / sum_l : 0.f;
      if (c == 0) a.part_lse[part_row + h] = seen ? mx[h] + logf(sum_l) : -INFINITY;
    }
  }
  if (a.splits > 1) merge();
}

template <int KIND, int D, bool CAP, bool ALIBI>
int launch(const Args& a, int bulk) {
  auto kernel = paged_decode_kernel<KIND, D, CAP, ALIBI>;
  constexpr size_t smem = Geometry<KIND, D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int G = a.Hq / a.Hkv;
  dim3 grid(a.splits * ((G + HB - 1) / HB), a.Hkv, a.B);
  kernel<<<grid, THREADS, smem, a.stream>>>(a, bulk);
  return int(cudaGetLastError());
}

template <int KIND, int D>
int launch_modes(const Args& a, int bulk) {
  const bool cap = a.softcap > 0.f, alibi = a.slopes != nullptr;
  if (cap)
    return alibi ? launch<KIND, D, true, true>(a, bulk) : launch<KIND, D, true, false>(a, bulk);
  return alibi ? launch<KIND, D, false, true>(a, bulk) : launch<KIND, D, false, false>(a, bulk);
}

template <int KIND, int D>
int launch_kind(const Args& a) {
  // Bulk copies take a tile of stored rows that lies inside one page, and
  // 16-byte aligned scales.
  const int stored = KIND == kI4 ? a.page_size / 2 : a.page_size;
  const bool aligned = !is_quantized(KIND) ||
                       (reinterpret_cast<uintptr_t>(a.k_scales) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(a.v_scales) % 16 == 0);
  const int bulk = stored % TILE == 0 && aligned;
  return launch_modes<KIND, D>(a, bulk);
}

// kv_kind: a PoolKind of paged.cuh.  page_size is the LOGICAL page size (an
// int4 pool stores page_size/2 rows).  Quantized kinds need k_scales and
// v_scales [Hkv, P, page_size] fp32 and take sm_scale rounded to q's dtype;
// value kinds ignore the scale pointers.  lse may be null.  slopes: [Hq]
// fp32 ALiBi slopes on the device, or null.  splits: the key splits of
// paged.cuh (1 to pages_per_seq, as ops/decode.py decode_splits gives them:
// ceil(pages_per_seq / ceil(pages_per_seq / splits)) == splits); above 1
// part_o [splits, B, Hq, D] and part_lse [splits, B, Hq] fp32 scratch and
// counters [B, Hkv, ceil(Hq / Hkv / 2)] uint32, zero before the call and
// zero after it (no two calls may share them at once).  Pools
// must be 16-byte aligned.  D must be DIM, the build's head dim.  Returns
// cudaGetLastError() after the launch (0 on success); launches nothing for an
// empty batch.
template <int DIM>
int paged_decode_entry(const void* q, int q_dtype, const void* k_pages,
                       const void* v_pages, int kv_kind, const float* k_scales,
                       const float* v_scales, const int* lengths, const int* page_table,
                       void* o, float* lse, float* part_o, float* part_lse,
                       unsigned* counters, int B, int Hq, int Hkv, int P, int page_size,
                       int pages_per_seq, int D, int splits, float sm_scale, float softcap,
                       const float* slopes, void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  if (D != DIM || Hkv <= 0 || Hq % Hkv != 0 || page_size <= 0 || pages_per_seq <= 0 ||
      (kv_kind == kI4 && page_size % 2) ||
      (is_quantized(kv_kind) && (k_scales == nullptr || v_scales == nullptr)) ||
      splits < 1 || splits > pages_per_seq ||
      (splits > 1 && (part_o == nullptr || part_lse == nullptr || counters == nullptr)))
    return int(cudaErrorInvalidValue);
  const int per = (pages_per_seq + splits - 1) / splits;
  if ((pages_per_seq + per - 1) / per != splits) return int(cudaErrorInvalidValue);
  const Args a{q, q_dtype, k_pages, v_pages, k_scales, v_scales, lengths, page_table, o, lse,
               part_o, part_lse, counters, B, Hq, Hkv, P, page_size, pages_per_seq, splits, per,
               sm_scale, softcap, slopes, static_cast<cudaStream_t>(stream)};
  switch (kv_kind) {
    case kF32: return launch_kind<kF32, DIM>(a);
    case kBF16: return launch_kind<kBF16, DIM>(a);
    case kF16: return launch_kind<kF16, DIM>(a);
    case kI8: return launch_kind<kI8, DIM>(a);
    case kI4: return launch_kind<kI4, DIM>(a);
    case kE4M3: return launch_kind<kE4M3, DIM>(a);
    case kE5M2: return launch_kind<kE5M2, DIM>(a);
    default: return int(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of the kernel instance for (kv_kind, D), in bytes;
// 0 for a pair no instance of the build takes.
template <int DIM>
int paged_decode_shared_bytes_entry(int kv_kind, int D) {
  auto bytes = [&](auto kind) -> int {
    constexpr int K = decltype(kind)::value;
    return D == DIM ? int(Geometry<K, DIM>::BYTES) : 0;
  };
  switch (kv_kind) {
    case kF32: return bytes(std::integral_constant<int, kF32>{});
    case kBF16: return bytes(std::integral_constant<int, kBF16>{});
    case kF16: return bytes(std::integral_constant<int, kF16>{});
    case kI8: return bytes(std::integral_constant<int, kI8>{});
    case kI4: return bytes(std::integral_constant<int, kI4>{});
    case kE4M3: return bytes(std::integral_constant<int, kE4M3>{});
    case kE5M2: return bytes(std::integral_constant<int, kE5M2>{});
    default: return 0;
  }
}

}  // namespace
