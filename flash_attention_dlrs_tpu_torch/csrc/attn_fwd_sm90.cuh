// The half-precision attention forward redesigned for Hopper (sm_90a):
// warpgroup products (wgmma), TMA copies into a ring of shared-memory
// stages tracked by mbarriers, and a producer warpgroup apart from the
// consumers (warp specialisation, registers moved by setmaxnreg).  Included
// by the six forward sources after attn_fwd.cuh, whose C entry launches it
// on the "wgmma" route (ops/fwd_kernel.py fwd_route): every bf16 / fp16
// call.
//
// Replaces the forward of the TPU kernels
// flash_attention_dlrs_tpu/ops/fwd_kernel.py _fwd_kernel, fwd_mid.py
// _mid_kernel and _mid_strip_kernel, and fwd_small.py _small_kernel, with
// the contract of attn_fwd.cuh: causal aligned bottom-right, sliding
// window, logit softcap, GQA, ragged Nq and Nkv, d in {64, 128, 256}, the
// true ALiBi bias after the softcap, the dropout mask of common.cuh after the
// undropped row sum and before P is rounded to q's type, segment ids, fp8
// V (e4m3 / e5m2, dequantized exactly), an exact running max in fp32, and
// O = 0 with L = kMaskValue for a row that sees no key.  ALiBi, dropout,
// segment ids and fp8 V are template flags, built at every head dim.
//
// Bound on this card.  At the model paths' shapes the forward is bound by
// operations (4*d per visible pair and head on the tensor cores' 989
// TFLOP/s); the mma.sync kernel this one replaced ran at ~17% of that, its
// warps stalled on synchronous 16-byte loads, two block-wide barriers a
// tile, Ampere-era products and 64-row CTAs.  What this design does:
//  * A CTA owns 128 q rows: two consumer warpgroups of 64 rows, so each
//    K/V tile in shared memory serves 128 rows.  A third warpgroup is the
//    producer: one thread issues TMA copies and gives its registers to the
//    consumers (setmaxnreg 24 / 240; 32 / 232 where it stages segment ids,
//    56 / 224 where it converts fp8 V).
//  * Q is loaded once by TMA; K and V stream in tiles of BN = 128 keys (64
//    at d 256) through a ring of STAGES stages (2 at d 128: 32 KB of Q +
//    128 KB of K/V; 4 at d 64; 2 at d 256: 64 KB of Q + 128 KB of K/V),
//    each stage with a full and an empty barrier for K
//    and for V (so Q K^T starts before V lands, and K is refilled before
//    P V is done).  Loads of later tiles overlap the products.  The key
//    tile KT is a template parameter: attn_fwd_tiles.cu also builds 64-key
//    tiles at d 64 and 128 (4 stages each; mode-free), which the tuner
//    (tuning.py) may pick.
//  * The tensor maps are 3-D (d, N, B*H): a head's ragged tail reads TMA's
//    zero fill, never the next head's rows.  Maps and wgmma descriptors
//    use the 128-byte swizzle: a [rows][64] column chunk of 128-byte rows,
//    d / 64 chunks a tile.
//  * S = Q K^T is wgmma.m64n{BN}k16 with both operands in shared memory
//    (K-major); O += P V is wgmma.m64n{d}k16 (at d 256 two n128 halves)
//    with P from registers (the S accumulator re-packed) and V in shared
//    memory, MN-major (the transpose bit).  At d 256 the O accumulator
//    takes 128 registers a consumer thread, hence the 64-key tile: S and P
//    then take 48 more, within the consumers' 240 (224 with fp8 V, 232
//    with segment ids).  Per warp, the accumulator has the m16n8 fragment
//    pattern repeated over N/8, so the scale, softcap, ALiBi, mask,
//    dropout and online softmax are the mma.sync kernel's with row = m0 +
//    64*wg + 16*warp + g (+8), col = n0 + 8*j + 2*t (+1).
//  * Within a warpgroup, S of tile i is issued beside P V of tile i - 1,
//    and the softmax of S(i) runs while that P V finishes (two wgmma
//    groups in flight, P(i - 1) kept in registers until its product is
//    done); K(i) is released to the producer as soon as S(i) is done,
//    V(i - 1) once its P V is.  The two consumer warpgroups run
//    unsynchronised, so one's softmax (and dropout hash) also overlaps the
//    other's products.  Ordering them with named barriers (ping-pong)
//    made ptxas serialize the wgmmas (its warning C7515, which
//    chip_smoke.py reports) and was slower, so there is none.
//  * The softcap (tanhf and an IEEE divide) and the mask are compiled out
//    of the score loop when the call or the tile needs neither: as
//    per-element branches they took most of the kernel's time.  The
//    exponentials are ex2.approx.ftz.
//  * KV tiles wholly above the causal diagonal or outside the window are
//    skipped (kv_tiles at 128 x 128), causal q tiles run heaviest first,
//    and interior tiles skip the mask (tile_unmasked per warpgroup).
//  * Segment ids: each consumer thread holds its two rows' ids; the
//    producer's first warp writes each K tile's 128 ids beside it before
//    K's full barrier completes, and K's stage is released after the
//    softmax has read them.  Every tile evaluates the mask.
//  * fp8 V: wgmma takes no fp8 beside 16-bit A, so TMA loads the fp8 tile
//    (half the bytes) into a staging buffer and the producer warpgroup
//    converts it exactly (common.cuh fp8x2_to) into the swizzled 16-bit V
//    stage, then fences the async proxy and arrives on V's full barrier.
//    At d 256 the two 16 KB fp8 stages and the segment ids' 512 bytes
//    bring a CTA to 231,000 of the 232,448 bytes it may opt into
//    (Layout<256, true, true>::BYTES).
// The host builds the three tensor maps on every call with
// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (no -lcuda), and passes them as __grid_constant__ parameters; the launch
// allocates nothing on the device and does not synchronise.

#pragma once

#include "sm90.cuh"

namespace {
namespace sm90 {

constexpr int BM = 128;       // q rows per CTA: two consumer warpgroups of 64

// Shared memory of a CTA's layout, in bytes: Q, STAGES stages of K and of V
// (KT keys each), with fp8 V the fp8 tiles as loaded, with segment ids each K
// tile's ids, the barriers, and 1024 bytes of alignment.
__host__ __device__ constexpr size_t layout_bytes(int D, int KT, int STAGES, bool SEG,
                                                  bool V8) {
  return size_t(BM) * D * 2 + 2 * size_t(STAGES) * KT * D * 2 +
         (V8 ? size_t(STAGES) * KT * D : 0) + (SEG ? size_t(STAGES) * KT * 4 : 0) +
         8 * (1 + 5 * STAGES) + 1024;
}

// Stages of a key tile: the head dim's own tile (key_tile, attn_fwd.cuh) keeps
// its 4 at d 64 and 2 above; another tile (attn_fwd_tiles.cu) takes as many as
// fit in the 232,448 bytes a CTA may opt into, at most 4 and at least 2 (4 for
// 64 keys at d 64 and d 128: 165,032 bytes at d 128).
__host__ __device__ constexpr int fwd_stages(int D, int KT, bool SEG, bool V8) {
  if (KT == key_tile(D)) return D == 64 ? 4 : 2;
  int stages = 4;
  while (stages > 2 && layout_bytes(D, KT, stages, SEG, V8) > 232448) --stages;
  return stages;
}

// Shared memory of one CTA, in bytes from a 1024-byte aligned base: Q, the
// K stages, the V stages, with fp8 V (V8) the fp8 tiles as loaded, with
// segment ids (SEG) each K tile's ids, then the barriers (Q full; per
// stage K full, V full, K empty, V empty and fp8 V full).  KT keys a tile.
template <int D, bool SEG, bool V8, int KT = key_tile(D)>
struct Layout {
  static constexpr int BN = KT;
  static constexpr int STAGES = fwd_stages(D, KT, SEG, V8);
  static constexpr uint32_t Q_BYTES = BM * D * 2;
  static constexpr uint32_t KV_BYTES = BN * D * 2;  // one K or V tile
  static constexpr uint32_t V8_BYTES = BN * D;      // one fp8 V tile
  static constexpr uint32_t K_OFF = Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t V8_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t IDS_OFF = V8_OFF + (V8 ? STAGES * V8_BYTES : 0);
  static constexpr uint32_t BAR_OFF = IDS_OFF + (SEG ? STAGES * BN * 4 : 0);
  static constexpr size_t BYTES = BAR_OFF + 8 * (1 + 5 * STAGES) + 1024;  // + alignment
  static_assert(BYTES == layout_bytes(D, KT, STAGES, SEG, V8), "the layout's byte count");
  static_assert(BYTES <= 232448, "a CTA has 227 KB of shared memory");
};

template <typename T, int D, bool ALIBI, bool DROP, bool SEG, bool V8, int KT>
__global__ void __launch_bounds__(THREADS, 1)
attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, int v_kind,
                      T* __restrict__ o, float* __restrict__ lse, int Hq, int Hkv, int Nq,
                      int Nkv, float sm_scale, int causal, int window, float softcap,
                      Mods md) {
  using L = Layout<D, SEG, V8, KT>;
  constexpr int BN = L::BN;
  constexpr int STAGES = L::STAGES;
  constexpr int CHUNKS = D / CHUNK;  // 128-byte column chunks of a row
  constexpr int NS = BN / 8;         // score n-tiles of 8 columns per warp
  constexpr int NO = D / 8;          // output n-tiles per warp

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle atom
  unsigned char* const smem = smem_raw + (base - smem_u32(smem_raw));  // generic view
  const uint32_t sQ = base, sK = base + L::K_OFF, sV = base + L::V_OFF;
  const uint32_t bar_q = base + L::BAR_OFF;
  auto full_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto full_v = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };
  auto empty_k = [&](int s) { return bar_q + 8u * (1 + 2 * STAGES + s); };
  auto empty_v = [&](int s) { return bar_q + 8u * (1 + 3 * STAGES + s); };
  auto full_v8 = [&](int s) { return bar_q + 8u * (1 + 4 * STAGES + s); };
  auto tile_ids = [&](int s) {  // the segment ids of the K tile in stage s (SEG)
    return reinterpret_cast<int*>(smem + L::IDS_OFF) + s * BN;
  };

  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const TileRange tiles = kv_tiles<BM, BN>(m0, Nq, Nkv, causal, window);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), V8 ? 4 : 1);  // fp8 V: one arrival per producer warp
      mbar_init(empty_k(s), 8);          // one arrival per consumer warp
      mbar_init(empty_v(s), 8);
      mbar_init(full_v8(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Producer warpgroup: thread 0 issues every copy; with segment ids its
  // warp stages each K tile's ids, and with fp8 V all four warps convert
  // each loaded fp8 tile into the 16-bit, swizzled V stage (wgmma takes no
  // fp8 beside bf16 / fp16).  Threads with nothing to do leave.
  constexpr int PRODUCERS = V8 ? 128 : SEG ? 32 : 1;
  // Registers a thread: the producer's work sets its share, the consumers
  // take the rest.  setmaxnreg moves registers only within what the CTA
  // was launched with, 384 threads x 168 (__launch_bounds__(384, 1)): a
  // split that asks for more leaves the consumers waiting forever.
  constexpr int PRODUCER_REGS = V8 ? 56 : SEG ? 32 : 24;
  constexpr int CONSUMER_REGS = V8 ? 224 : SEG ? 232 : 240;
  static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= THREADS * LAUNCH_REGS,
                "the register split exceeds the CTA's registers");
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x < PRODUCERS) {
      const bool leader = threadIdx.x == 0;
      if (leader) {
        mbar_expect_tx(bar_q, L::Q_BYTES);
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c)
          tma_load_3d(sQ + c * (BM * 128), &tm_q, bar_q, c * CHUNK, m0, bh);
      }
      const int kv_bh = b * Hkv + kvh;
      for (int kt = tiles.lo, i = 0; kt < tiles.hi; ++kt, ++i) {
        const int s = i % STAGES;
        // the stage's previous K / V released (passes at once on the first lap)
        const uint32_t parity = ((i / STAGES) & 1) ^ 1;
        mbar_wait(empty_k(s), parity);
        if constexpr (SEG) {
          if (threadIdx.x < 32) {
            for (int x = threadIdx.x; x < BN; x += 32)
              tile_ids(s)[x] = seg_id(md.kv_seg, b, Nkv, kt * BN + x);
            __syncwarp();  // the ids are written before K's full barrier completes
          }
        }
        if (leader) {
          mbar_expect_tx(full_k(s), L::KV_BYTES);
#pragma unroll
          for (int c = 0; c < CHUNKS; ++c)
            tma_load_3d(sK + s * L::KV_BYTES + c * (BN * 128), &tm_k, full_k(s), c * CHUNK,
                        kt * BN, kv_bh);
        }
        if constexpr (V8) {
          const uint32_t v8_tile = base + L::V8_OFF + s * L::V8_BYTES;
          if (leader) {
            fence_proxy_async();  // the last lap's reads of this fp8 tile come first
            mbar_expect_tx(full_v8(s), L::V8_BYTES);
            tma_load_3d(v8_tile, &tm_v, full_v8(s), 0, kt * BN, kv_bh);
          }
          mbar_wait(empty_v(s), parity);
          mbar_wait(full_v8(s), (i / STAGES) & 1);
          // 16 fp8 values (one row's 16-byte chunk c16) become 32 bytes of
          // T: units 2 * (c16 % 4) and + 1 of column chunk c16 / 4, XOR
          // the row's swizzle.
          constexpr int ROW_CHUNKS = D / 16;
#pragma unroll
          for (int it = 0; it < BN * ROW_CHUNKS / 128; ++it) {
            const int x = threadIdx.x + it * 128;
            const int r = x / ROW_CHUNKS, c16 = x % ROW_CHUNKS;
            const uint4 w = *reinterpret_cast<const uint4*>(smem + L::V8_OFF +
                                                            s * L::V8_BYTES + x * 16);
            const uint32_t in[4] = {w.x, w.y, w.z, w.w};
            uint32_t out[8];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              out[2 * q] = fp8x2_to<T>(in[q], v_kind);
              out[2 * q + 1] = fp8x2_to<T>(in[q] >> 16, v_kind);
            }
            unsigned char* row = smem + L::V_OFF + s * L::KV_BYTES +
                                 (c16 / 4) * (BN * 128) + r * 128;
            const int u = 2 * (c16 % 4);
            *reinterpret_cast<uint4*>(row + ((u ^ (r & 7)) * 16)) =
                make_uint4(out[0], out[1], out[2], out[3]);
            *reinterpret_cast<uint4*>(row + (((u + 1) ^ (r & 7)) * 16)) =
                make_uint4(out[4], out[5], out[6], out[7]);
          }
          fence_proxy_async();  // the V stage is read by wgmma
          __syncwarp();
          if (threadIdx.x % 32 == 0) mbar_arrive(full_v(s));
          // every warp is done with this fp8 tile before it is loaded again
          asm volatile("bar.sync 1, 128;\n" ::: "memory");
        } else if (leader) {
          mbar_wait(empty_v(s), parity);
          mbar_expect_tx(full_v(s), L::KV_BYTES);
#pragma unroll
          for (int c = 0; c < CHUNKS; ++c)
            tma_load_3d(sV + s * L::KV_BYTES + c * (BN * 128), &tm_v, full_v(s), c * CHUNK,
                        kt * BN, kv_bh);
        }
      }
    }
  } else {
    // Consumer warpgroups 0 and 1: q rows [m0 + 64 * cw, + 64).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;  // accumulator row group / column pair
    const int mw = m0 + 64 * cw;
    const int row0 = mw + 16 * warp + g;  // this thread's rows: row0, row0 + 8
    const int q_off = Nkv - Nq;
    const float scale_log2 = sm_scale * kLog2e;
    const float slope = ALIBI ? md.slopes[h] : 0.f;
    const float slope_log2 = slope * kLog2e;
    const uint32_t stream = DROP ? dropout_stream(md.seed, b, h) : 0u;
    int qseg[2] = {0, 0};  // segment ids of this thread's rows (SEG)
    if (SEG) {
      qseg[0] = seg_id(md.q_seg, b, Nq, row0);
      qseg[1] = seg_id(md.q_seg, b, Nq, row0 + 8);
    }

    float s[BN / 2], acc[D / 2];
    uint32_t pa[BN / 16][4];  // P as the A fragments of P V, 16 keys a k-step
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};  // running max, base-2 units
    float l_r[2] = {0.f, 0.f};              // this thread's share of the row sum
    float alpha[2] = {1.f, 1.f};            // O's rescale before the next P V

    // S = Q K^T of the tile in stage st, issued (not awaited): d / 16
    // k-steps, 32 bytes apart inside a 128-byte chunk.
    const uint32_t q_rows = sQ + cw * (64 * 128);  // this warpgroup's rows of chunk 0
    auto issue_s = [&](int st) {
      const uint32_t k_tile = sK + st * L::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t in_chunk = (ks % 4) * 32;
        WgmmaSS<BN, T>::run(
            s, smem_desc(q_rows + (ks / 4) * (BM * 128) + in_chunk, 16, 1024),
            smem_desc(k_tile + (ks / 4) * (BN * 128) + in_chunk, 16, 1024), ks > 0);
      }
      wgmma_commit();
    };
    // O *= alpha, before any product of the step is issued (a register a
    // pending wgmma accumulates into must not be written meanwhile).
    auto rescale_o = [&]() {
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        acc[4 * i] *= alpha[0];
        acc[4 * i + 1] *= alpha[0];
        acc[4 * i + 2] *= alpha[1];
        acc[4 * i + 3] *= alpha[1];
      }
    };
    // O += P V of the tile in stage st, issued: V MN-major, 16 key rows
    // (2048 bytes) a k-step.
    auto issue_pv = [&](int st) {
      const uint32_t v_tile = sV + st * L::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        WgmmaRS<D, T>::run(acc, pa[kk], smem_desc(v_tile + kk * 2048, BN * 128, 1024));
      wgmma_commit();
    };
    // Scale, softcap, ALiBi bias and mask of the scores of keys [n0, n0 +
    // BN) (with segment ids, ids[col - n0] their ids), into base-2 units;
    // the softcap and the mask are compiled out of the element loop when
    // the call or the tile needs neither.  The bias
    // distance q_pos - col is an exact integer in fp32, taken from a per-row
    // base minus the element's constant column offset (no int-to-float
    // conversion per score).
    auto scores = [&](int n0, const int* ids, auto cap, auto masked) {
      const float dist0[2] = {float(row0 + q_off - n0 - 2 * t),
                              float(row0 + 8 + q_off - n0 - 2 * t)};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dist = dist0[e >> 1] - float(j * 8 + (e & 1));
          float x;
          if constexpr (decltype(cap)::value) {
            x = s[4 * j + e] * sm_scale;
            x = softcap * tanhf(x / softcap);
            if (ALIBI) x -= slope * dist;
            x *= kLog2e;
          } else {
            x = s[4 * j + e] * scale_log2;
            if (ALIBI) x -= slope_log2 * dist;
          }
          if constexpr (decltype(masked)::value) {
            const int row = row0 + (e >= 2 ? 8 : 0);
            const int col = n0 + j * 8 + 2 * t + (e & 1);
            if (!visible(row, col, Nq, Nkv, causal, window) ||
                (SEG && qseg[e >> 1] != ids[col - n0]))
              x = -INFINITY;
          }
          s[4 * j + e] = x;
        }
      }
    };
    // Dropout of P (common.cuh dropout_factor, bit for bit): the column's
    // inner hash is shared by the thread's two rows, and the keep test
    // u * 2^-24 >= rate on the 24-bit u is the exact integer test u >=
    // ceil(rate * 2^24).
    const uint32_t keep_min = DROP ? uint32_t(ceilf(md.rate * 16777216.f)) : 0u;
    auto drop_p = [&](int n0) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const uint32_t inner = lowbias32(uint32_t(n0 + j * 8 + 2 * t + c) + stream);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint32_t bits = lowbias32(uint32_t(row0 + 8 * r) ^ inner);
            float& p = s[4 * j + 2 * r + c];
            p = (bits & 0xFFFFFFu) >= keep_min ? p * md.keep_scale : 0.f;
          }
        }
      }
    };
    // The online softmax of one tile's scores: new running max, alpha (O's
    // rescale, applied before the tile's P V), P in place of S (dropped
    // after the undropped row sum).  With segment ids every tile is masked
    // (ids are arbitrary: no tile is known to be interior).
    auto softmax = [&](int n0, const int* ids) {
      const bool masked = SEG || !tile_unmasked<64, BN>(mw, n0, Nq, Nkv, causal, window);
      const std::true_type yes{};
      const std::false_type no{};
      if (softcap > 0.f) {
        if (masked) scores(n0, ids, yes, yes); else scores(n0, ids, yes, no);
      } else {
        if (masked) scores(n0, ids, no, yes); else scores(n0, ids, no, no);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
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
            sum += s[4 * j + e];  // the row sum is undropped
          }
        }
        l_r[r] = l_r[r] * alpha[r] + sum;
      }
      if (DROP) drop_p(n0);
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pa[kk][x] = Mma<T>::pack(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
      }
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    // Tile i: S(i) is issued beside P V of tile i - 1, and the softmax of
    // S(i) runs while that P V finishes; K(i) is released once S(i) is
    // done (with segment ids, once its ids are read too), V(i - 1) once its
    // P V is.
    mbar_wait(bar_q, 0);
    const int n_tiles = tiles.hi - tiles.lo;
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % STAGES, prev = (i + STAGES - 1) % STAGES;
      if (i > 0) rescale_o();
      mbar_wait(full_k(st), (i / STAGES) & 1);
      issue_s(st);
      if (i > 0) {
        mbar_wait(full_v(prev), ((i - 1) / STAGES) & 1);
        issue_pv(prev);
      }
      if (i > 0) {
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      } else {
        wgmma_wait_all();
      }
      fence_regs(s);
      if (!SEG) release(empty_k(st));
      softmax((tiles.lo + i) * BN, SEG ? tile_ids(st) : nullptr);
      if (SEG) release(empty_k(st));
      if (i > 0) {
        wgmma_wait_all();
        fence_regs(acc);
        release(empty_v(prev));
      }
      pack_p();
    }
    if (n_tiles > 0) {
      const int last = (n_tiles - 1) % STAGES;
      rescale_o();
      mbar_wait(full_v(last), ((n_tiles - 1) / STAGES) & 1);
      issue_pv(last);
      wgmma_wait_all();
      fence_regs(acc);
      release(empty_v(last));
    }

    T* ob = o + (size_t(b) * Hq + h) * size_t(Nq) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_r[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row0 + 8 * r;
      if (row >= Nq) continue;
      const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        *reinterpret_cast<uint32_t*>(ob + size_t(row) * D + j * 8 + 2 * t) =
            Mma<T>::pack(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      }
      if (t == 0) {
        lse[(size_t(b) * Hq + h) * Nq + row] =
            l > 0.f ? (m_r[r] + log2f(l)) * kLn2 : kMaskValue;
      }
    }
  }
}

}  // namespace sm90

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// Declared in attn_fwd.cuh: the "wgmma" route of its C entry, on tiles of KT
// keys.  The head dim's own tile (key_tile) is built with every mode; another
// tile (attn_fwd_tiles.cu) only mode-free, and a mode there is refused.
template <bool SEG, typename T, int D, int KT>
int launch_wgmma(const Args& a) {
  CUtensorMap tm_q, tm_k, tm_v;
  // With no keys the K / V maps cover q instead: no tile is ever loaded.
  const bool keys = a.Nkv > 0;
  const bool fp8_v = keys && a.v_kind != kVSame;
  const int kv_heads = keys ? a.B * a.Hkv : a.B * a.Hq;
  constexpr bool OWN_TILE = KT == key_tile(D);
  static_assert(OWN_TILE || !SEG, "another key tile is built without segment ids");
  if (!OWN_TILE && (fp8_v || a.md.slopes != nullptr || a.md.rate > 0.f))
    return int(cudaErrorInvalidValue);
  if (!sm90::encode_map<T>(&tm_q, a.q, D, a.Nq, a.B * a.Hq, sm90::BM) ||
      !sm90::encode_map<T>(&tm_k, keys ? a.k : a.q, D, keys ? a.Nkv : a.Nq, kv_heads, KT) ||
      !sm90::encode_map<T>(&tm_v, keys ? a.v : a.q, D, keys ? a.Nkv : a.Nq, kv_heads, KT,
                           fp8_v))
    return int(cudaErrorInvalidValue);
  auto run = [&](auto alibi, auto drop, auto v8) {
    auto kernel = sm90::attn_fwd_wgmma_kernel<T, D, decltype(alibi)::value,
                                              decltype(drop)::value, SEG,
                                              decltype(v8)::value, KT>;
    constexpr size_t smem = sm90::Layout<D, SEG, decltype(v8)::value, KT>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    dim3 grid((a.Nq + sm90::BM - 1) / sm90::BM, a.B * a.Hq);
    kernel<<<grid, sm90::THREADS, smem, a.stream>>>(
        tm_q, tm_k, tm_v, a.v_kind, static_cast<T*>(a.o), a.lse, a.Hq, a.Hkv, a.Nq,
        a.Nkv, a.sm_scale, a.causal, a.window, a.softcap, a.md);
    return int(cudaGetLastError());
  };
  if constexpr (!OWN_TILE) {
    return run(std::false_type{}, std::false_type{}, std::false_type{});
  } else {
    return dispatch_mods<SEG>(a.md, [&](auto alibi, auto drop, auto) {
      return dispatch_v8(a.v_kind, [&](auto v8) { return run(alibi, drop, v8); });
    });
  }
}

// Dynamic shared memory of a kernel of the build at head dim D on tiles of
// KT keys (route kRouteF32 or kRouteWgmma; v8: fp8 V), in bytes.  The fp32
// route has one tile of its own.
template <bool SEG, int D, int KT = key_tile(D)>
int fwd_shared_bytes(int route, int v8) {
  if (route == kRouteF32) return int(f32_smem_bytes<D, SEG>());
  return v8 ? int(sm90::Layout<D, SEG, true, KT>::BYTES)
            : int(sm90::Layout<D, SEG, false, KT>::BYTES);
}

}  // namespace
