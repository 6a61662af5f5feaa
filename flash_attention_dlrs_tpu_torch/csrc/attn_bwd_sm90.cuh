// The half-precision attention backward sweeps redesigned for Hopper
// (sm_90a): warpgroup products (wgmma), TMA copies into a ring of
// shared-memory stages tracked by mbarriers, and a producer warpgroup apart
// from two consumer warpgroups (registers moved by setmaxnreg).  Included by
// the six backward sources after attn_bwd.cuh, whose C entries launch them
// on the "wgmma" route (ops/bwd_kernel.py bwd_route): every bf16 / fp16
// call.
//
// Replaces the dK/dV and dQ sweeps of the TPU kernels
// flash_attention_dlrs_tpu/ops/bwd_kernel.py _bwd_dkv_kernel and
// _bwd_dq_kernel, and with them the backward of fwd_small.py
// _small_bwd_kernel, bwd_fused.py _bwd_fused_kernel and bwd_mid.py
// _bwd_mid_kernel, under the contract of attn_bwd.cuh: P rebuilt from the
// passed natural-base lse, dS = P o (M o dP - D) times the softcap's
// 1 - (S_c / cap)^2, the true ALiBi bias after the softcap, the dropout mask
// of common.cuh regenerated bit for bit, P and dS rounded to the input type
// before each product, dK scaled by sm_scale once at the end, and P = 0 for
// a row that sees no key before any exponent is taken.  ALiBi, dropout and
// segment ids are template flags.
//
// Bound on this card.  At the training shape the sweeps are bound by
// operations (8 d and 6 d per visible pair and q head on the tensor cores'
// 989 TFLOP/s); the mma.sync sweeps these replaced ran at ~18% and ~21% of
// that, with synchronous register-staged loads, one buffer and two
// block-wide barriers a step, Ampere-era products and 4-warp CTAs.  What
// this design does:
//  * Both sweeps have one shape.  A CTA holds BR = 128 rows of two resident
//    tiles (K and V in dK/dV; Q and dO in dQ), 64 for each consumer
//    warpgroup, loaded once by TMA, and streams BS = 64-row tiles of the
//    other two (Q and dO; K and V) through a ring of 4 stages with a full
//    and an empty barrier each (BS is a template parameter: attn_bwd_tiles.cu
//    also builds 32-row stages at d 64 and 128, mode-free, which the tuner,
//    tuning.py, may pick).  The third warpgroup is the producer: one
//    thread issues the copies; in dK/dV its first warp also stages each
//    step's lse (in base-2 units), D and q segment ids beside Q and dO, and
//    in dQ each K tile's segment ids.  Rows past Nq read Q = dO = 0 (TMA's
//    zero fill) and lse = D = 0, so their P is finite and adds nothing.
//  * The score products S = X U^T and dP = Y W^T (X, Y the warpgroup's
//    resident rows, U, W the stage) are wgmma.m64n64k16 with both operands
//    in shared memory, K-major.  P and dS are built in registers, rounded to
//    T and re-packed as A fragments (the accumulator's m16n8 pattern is the
//    A fragment's), and the update products (dV += P^T dO and dK += dS^T Q;
//    dQ += dS K) are wgmma.m64n{d}k16 with A from registers and the stage
//    read MN-major (the transpose bit): one 128-byte-swizzled tile is read
//    K-major by the score product and MN-major by the update, with the
//    descriptors' leading and stride offsets of each reading.
//  * In dK/dV the roles are transposed: a thread's accumulator rows are its
//    two keys and its columns q rows, so lse, D and the q ids are read per
//    column from the stage, and the dropout hash's inner half
//    lowbias32(key + stream) is computed once per key and q head.  In dQ
//    the rows are q rows (lse, D and ids in registers) and the inner half is
//    computed once per column of a tile, shared by the thread's two rows.
//    The keep test is the integer compare u >= ceil(rate 2^24) on the 24
//    bits; the mask is the forward's, bit for bit.
//  * The softcap and the mask are compiled-out variants of one element loop
//    (cap x masked), chosen per call and per warpgroup tile (tile_unmasked);
//    ALiBi is one FMA on a per-thread base distance; exponentials are
//    ex2.approx.ftz.  A warpgroup tile with no visible pair (above the
//    causal diagonal or outside the window) runs no product and only
//    releases its stage.  With segment ids every tile evaluates the mask
//    and none is skipped by id.
//  * Each stage is released as soon as the last product that reads it (the
//    update from Q, or K in dQ) is done; the two consumer warpgroups run
//    unsynchronised, so one's element loop overlaps the other's products
//    (named barriers between them made ptxas serialize the forward's
//    wgmmas, so there are none).  Within a warpgroup the steps run in
//    order: the dK/dV consumer holds dK and dV (2 x d/2 fp32) beside S^T
//    and dP^T (2 x 32), with no room at d 128 for a second step's scores,
//    and in dQ issuing the next tile's scores into a second buffer before
//    the element loop made ptxas serialize every wgmma (C7514 / C7515) in
//    each form tried (a wait for all groups but the newest, a copy out of
//    the buffer, the loop unrolled over two buffers), at 1.4-1.6x the
//    in-order sweep's time.
//  * Determinism stays structural: a dK/dV CTA owns its 128 keys and walks
//    the q heads of its GQA group and then their q steps in order; a dQ CTA
//    owns its 128 rows and walks its key tiles in order; no atomics.
//  * Head dim 256 (Gemma; built in attn_bwd_d256.cu and, with segment ids,
//    attn_bwd_d256_seg.cu, every mode a flag as at d 64 and 128) keeps the
//    CTA shape and changes two things.  Registers:
//    a dK/dV warpgroup cannot hold dK and dV for its 64 keys (2 x 128 fp32 a
//    thread past the consumers' 232), so the sweep runs twice over the same
//    q steps, dV in the first pass (S recomputed) and dK in the second (S
//    and dP recomputed): 10 d operations a visible pair in place of 8, the
//    products and the order of every sum otherwise as at d 128; the dQ
//    accumulator (128 registers) fits as the forward's O does.  Shared
//    memory: the two resident tiles take 128 KB, so the streamed stages
//    carry 32 rows (16 KB a tile) in 3 stages, 96 KB, 224 KB in all (with
//    segment ids the dK/dV stages' three row arrays bring it to 231,608 of
//    the 232,448 bytes a CTA may opt into).  With dropout both dK/dV passes
//    regenerate the keep mask at the same (seed, b, h, row, key): the first
//    builds P o M for dV, the second dS = P o (M o dP - D) for dK.
// The host builds the four tensor maps (3-D: d, N, B * H; zero fill past a
// head's tail) on every call and passes them as __grid_constant__
// parameters; the launch allocates nothing and does not synchronise.

#pragma once

#include "sm90.cuh"

namespace {
namespace sm90 {

constexpr int BR = 128;  // resident rows per CTA: keys (dK/dV), q rows (dQ)
constexpr int WG_ROWS = 64;  // resident rows of one consumer warpgroup

// Shared memory of a sweep's CTA, in bytes from a 1024-byte aligned base:
// the two resident tiles, the stages of the two streamed tiles, each
// stage's row data (dK/dV: lse, D and with segment ids the q ids; dQ: with
// segment ids the key ids), then the barriers (resident full; per stage
// full and empty).
template <int D, bool SEG, bool DKV, int ST = stream_tile(D)>
struct BwdLayout {
  // streamed rows per stage (q rows in dK/dV, keys in dQ) and stages: 64 x 4,
  // and 32 x 3 at d 256; attn_bwd_tiles.cu's 32-row stages at d 64 and 128
  // keep 4
  static constexpr int BS = ST;
  static constexpr int STAGES = D == 256 ? 3 : 4;
  static constexpr uint32_t RES_BYTES = BR * D * 2;   // one resident tile
  static constexpr uint32_t STEP_BYTES = BS * D * 2;  // one streamed tile
  static constexpr uint32_t U_OFF = 2 * RES_BYTES;
  static constexpr uint32_t W_OFF = U_OFF + STAGES * STEP_BYTES;
  static constexpr int ROW_ARRAYS = (DKV ? 2 : 0) + (SEG ? 1 : 0);
  static constexpr uint32_t ROWS_OFF = W_OFF + STAGES * STEP_BYTES;
  static constexpr uint32_t BAR_OFF = ROWS_OFF + STAGES * ROW_ARRAYS * BS * 4;
  static constexpr size_t BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + alignment
  static_assert(BYTES <= 232448, "a CTA has 227 KB of shared memory");
};

// S = A B^T of one warpgroup over d, issued (not committed): A the
// warpgroup's 64 rows of a resident tile at `a_rows`, B the streamed tile of
// BS = 2 HALF rows at `b_tile`, both K-major (16 columns a k-step, 32 bytes
// apart inside a 128-byte chunk of 64 columns).
template <typename T, int D, int HALF>
__device__ __forceinline__ void issue_scores(float (&acc)[HALF], uint32_t a_rows,
                                             uint32_t b_tile) {
  constexpr int BS = 2 * HALF;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t in_chunk = (ks % 4) * 32;
    WgmmaSS<BS, T>::run(acc, smem_desc(a_rows + (ks / 4) * (BR * 128) + in_chunk, 16, 1024),
                        smem_desc(b_tile + (ks / 4) * (BS * 128) + in_chunk, 16, 1024),
                        ks > 0);
  }
}

// acc += A B over the BS = 16 KS streamed rows, issued: A from registers
// (a[kk], 16 rows a k-step), B the streamed tile at `b_tile` read MN-major
// (2048 bytes a k-step; 64-column chunks BS * 128 bytes apart).
template <typename T, int D, int KS>
__device__ __forceinline__ void issue_update(float (&acc)[D / 2], const uint32_t (&a)[KS][4],
                                             uint32_t b_tile) {
  constexpr int BS = 16 * KS;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    WgmmaRS<D, T>::run(acc, a[kk], smem_desc(b_tile + kk * 2048, BS * 128, 1024));
}

// A score accumulator as the A fragments of an update product (its columns,
// the streamed rows, become the k dimension), rounded to T.
template <typename T, int HALF>
__device__ __forceinline__ void pack_frags(const float (&acc)[HALF], uint32_t (&a)[HALF / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < HALF / 8; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x)
      a[kk][x] = Mma<T>::pack(acc[8 * kk + 2 * x], acc[8 * kk + 2 * x + 1]);
  }
}

// One arrival per warp on an empty barrier (count 8: both consumer
// warpgroups), after every lane's reads of the stage.
__device__ __forceinline__ void release(uint32_t bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// Whether no pair of q rows [m0, m0 + M) x keys [n0, n0 + N) is visible.
template <int M, int N>
__device__ __forceinline__ bool tile_hidden(int m0, int n0, int Nq, int Nkv, int causal,
                                            int window) {
  if (n0 >= Nkv || m0 >= Nq) return true;
  if (!causal) return false;
  const int q_off = Nkv - Nq;
  if (min(m0 + M, Nq) - 1 + q_off < n0) return true;  // every key after every row
  return window > 0 && m0 + q_off - (min(n0 + N, Nkv) - 1) >= window;
}

template <typename T, int D, bool ALIBI, bool DROP, bool SEG, int ST>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv, int Nq,
                          int Nkv, float sm_scale, int causal, int window, float softcap,
                          Mods md) {
  using L = BwdLayout<D, SEG, true, ST>;
  constexpr int STAGES = L::STAGES;
  constexpr int BS = L::BS;
  constexpr int CHUNKS = D / CHUNK;
  // sweeps over the q steps: 1 (dK and dV together), 2 at d 256 (dV, then dK)
  constexpr int PASSES = D == 256 ? 2 : 1;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle atom
  unsigned char* const smem = smem_raw + (base - smem_u32(smem_raw));  // generic view
  const uint32_t sK = base, sV = base + L::RES_BYTES;
  auto q_tile = [&](int s) { return base + L::U_OFF + s * L::STEP_BYTES; };
  auto do_tile = [&](int s) { return base + L::W_OFF + s * L::STEP_BYTES; };
  // the stage's rows: 0 lse (base 2), 1 D, 2 q segment ids
  auto rows_of = [&](int s, int a) {
    return reinterpret_cast<float*>(smem + L::ROWS_OFF) + (s * L::ROW_ARRAYS + a) * BS;
  };
  const uint32_t bar_kv = base + L::BAR_OFF;
  auto full = [&](int s) { return bar_kv + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_kv + 8u * (1 + STAGES + s); };

  const int n0 = blockIdx.x * BR;  // causal: the first key tiles see the most q rows
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;
  const int group = Hq / Hkv;
  const TileRange steps = q_tiles<BS, BR>(n0, Nq, Nkv, causal, window);
  const int per_head = steps.hi - steps.lo;
  const int n_steps = group * per_head;  // q heads of the group, then their steps
  // every pass streams the same steps through the ring, one after another

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // setmaxnreg moves registers only within what the CTA was launched with,
  // 384 threads x 168 (__launch_bounds__(384, 1)): a split that asks for
  // more leaves the consumers waiting forever.
  constexpr int PRODUCER_REGS = 32, CONSUMER_REGS = 232;
  static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= THREADS * LAUNCH_REGS,
                "the register split exceeds the CTA's registers");
  if (threadIdx.x < 128) {
    // Producer warpgroup: thread 0 issues every copy, its warp stages each
    // step's lse, D and q ids; the other warps leave.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 2 * L::RES_BYTES);
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c) {
          tma_load_3d(sK + c * (BR * 128), &tm_k, bar_kv, c * CHUNK, n0, blockIdx.y);
          tma_load_3d(sV + c * (BR * 128), &tm_v, bar_kv, c * CHUNK, n0, blockIdx.y);
        }
      }
      for (int i = 0; i < PASSES * n_steps; ++i) {
        const int s = i % STAGES, step = i % n_steps;
        // the stage's previous step released (passes at once on the first lap)
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        const int bh = b * Hq + kvh * group + step / per_head;
        const int m0 = (steps.lo + step % per_head) * BS;
        for (int x = lane; x < BS; x += 32) {
          const int row = m0 + x;
          const bool in = row < Nq;
          rows_of(s, 0)[x] = in ? lse[size_t(bh) * Nq + row] * kLog2e : 0.f;
          rows_of(s, 1)[x] = in ? delta[size_t(bh) * Nq + row] : 0.f;
          if (SEG) reinterpret_cast<int*>(rows_of(s, 2))[x] = seg_id(md.q_seg, b, Nq, row);
        }
        __syncwarp();  // the rows are written before the full barrier completes
        if (lane == 0) {
          mbar_expect_tx(full(s), 2 * L::STEP_BYTES);
#pragma unroll
          for (int c = 0; c < CHUNKS; ++c) {
            tma_load_3d(q_tile(s) + c * (BS * 128), &tm_q, full(s), c * CHUNK, m0, bh);
            tma_load_3d(do_tile(s) + c * (BS * 128), &tm_do, full(s), c * CHUNK, m0, bh);
          }
        }
      }
    }
  } else {
    // Consumer warpgroups 0 and 1: keys [n0 + 64 * cw, + 64).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;  // accumulator row group / column pair
    const int nw = n0 + WG_ROWS * cw;
    const int key0 = nw + 16 * warp + g;  // this thread's keys: key0, key0 + 8
    const int q_off = Nkv - Nq;
    const float scale_log2 = sm_scale * kLog2e;
    const uint32_t keep_min = DROP ? uint32_t(ceilf(md.rate * 16777216.f)) : 0u;
    int kseg[2] = {0, 0};  // segment ids of this thread's keys (SEG)
    if (SEG) {
      kseg[0] = seg_id(md.kv_seg, b, Nkv, key0);
      kseg[1] = seg_id(md.kv_seg, b, Nkv, key0 + 8);
    }

    // S^T, then P^T o M; dP^T, then dS^T: element e of n-tile j is key
    // key0 + 8 (e >> 1), q row m0 + 8 j + 2 t + (e & 1).
    float s[BS / 2], dp[BS / 2];
    uint32_t pa[BS / 16][4], da[BS / 16][4];
    const uint32_t k_rows = sK + cw * (WG_ROWS * 128), v_rows = sV + cw * (WG_ROWS * 128);
    const size_t out = (size_t(b) * Hkv + kvh) * size_t(Nkv) * D;

    // P^T o M and (with_ds) dS^T of q step m0 (stage st) in place of S^T and
    // dP^T, in base-2 units; the softcap and the mask are compiled out of
    // the loop when the call or the tile needs neither.
    auto grads = [&](int m0, int st, float slope, uint32_t stream, auto cap, auto masked,
                     auto with_ds) {
      const float* lse2 = rows_of(st, 0);
      const float* dlt = rows_of(st, 1);
      const int* qseg = reinterpret_cast<const int*>(rows_of(st, 2));
      const float slope_log2 = slope * kLog2e;
      // the ALiBi distance q_pos - key, exact in fp32: a per-key base plus
      // the element's constant column offset
      const float dist0[2] = {float(m0 + 2 * t + q_off - key0),
                              float(m0 + 2 * t + q_off - key0 - 8)};
      uint32_t inner[2] = {0u, 0u};  // the dropout hash's half of each key
      if (DROP) {
        inner[0] = lowbias32(uint32_t(key0) + stream);
        inner[1] = lowbias32(uint32_t(key0 + 8) + stream);
      }
#pragma unroll
      for (int j = 0; j < BS / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
        const float2 d2 = *reinterpret_cast<const float2*>(dlt + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = e & 1;
          const int col = 8 * j + 2 * t + c;  // q row - m0
          const float dist = dist0[r] + float(8 * j + c);
          float x, dcap = 1.f;
          if constexpr (decltype(cap)::value) {
            const float th = tanhf(s[4 * j + e] * sm_scale / softcap);
            x = softcap * th;
            dcap = 1.f - th * th;
            if (ALIBI) x -= slope * dist;
            x = x * kLog2e - (c ? l2.y : l2.x);
          } else {
            x = s[4 * j + e] * scale_log2 - (c ? l2.y : l2.x);
            if (ALIBI) x -= slope_log2 * dist;
          }
          float p = exp2_ftz(x);
          if constexpr (decltype(masked)::value) {
            if (!visible(m0 + col, key0 + 8 * r, Nq, Nkv, causal, window) ||
                (SEG && kseg[r] != qseg[col]))
              p = 0.f;
          }
          float keep = 1.f;
          if (DROP) {
            const uint32_t bits = lowbias32(uint32_t(m0 + col) ^ inner[r]);
            keep = (bits & 0xFFFFFFu) >= keep_min ? md.keep_scale : 0.f;
          }
          s[4 * j + e] = DROP ? p * keep : p;
          if constexpr (decltype(with_ds)::value) {
            const float dpv = DROP ? dp[4 * j + e] * keep : dp[4 * j + e];
            dp[4 * j + e] = p * (dpv - (c ? d2.y : d2.x)) * dcap;
          }
        }
      }
    };

    // Ring index i's q step in the stage st: S^T (and with_ds dP^T), then
    // P^T o M (and dS^T) in their place; false, and nothing run, when the
    // warpgroup's keys see no row of the step.
    auto step_grads = [&](int i, int st, auto with_ds) -> bool {
      const int step = i % n_steps;
      const int m0 = (steps.lo + step % per_head) * BS;
      if (tile_hidden<BS, WG_ROWS>(m0, nw, Nq, Nkv, causal, window)) return false;
      wgmma_fence();
      issue_scores<T, D>(s, k_rows, q_tile(st));
      if constexpr (decltype(with_ds)::value) issue_scores<T, D>(dp, v_rows, do_tile(st));
      wgmma_commit();
      const int h = kvh * group + step / per_head;  // the q head: slope, dropout stream
      const float slope = ALIBI ? md.slopes[h] : 0.f;
      const uint32_t stream = DROP ? dropout_stream(md.seed, b, h) : 0u;
      const bool masked =
          SEG || !tile_unmasked<BS, WG_ROWS>(m0, nw, Nq, Nkv, causal, window);
      const std::true_type yes{};
      const std::false_type no{};
      wgmma_wait_all();
      fence_regs(s);
      if constexpr (decltype(with_ds)::value) fence_regs(dp);
      if (softcap > 0.f) {
        if (masked) grads(m0, st, slope, stream, yes, yes, with_ds);
        else grads(m0, st, slope, stream, yes, no, with_ds);
      } else {
        if (masked) grads(m0, st, slope, stream, no, yes, with_ds);
        else grads(m0, st, slope, stream, no, no, with_ds);
      }
      return true;
    };

    // this thread's rows of dK (times sm_scale) or dV from an accumulator
    auto store = [&](T* dst, const float (&acc)[D / 2], float scale) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= Nkv) continue;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<uint32_t*>(dst + out + size_t(key) * D + 8 * j + 2 * t) =
              Mma<T>::pack(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
        }
      }
    };

    mbar_wait(bar_kv, 0);
    if constexpr (PASSES == 1) {
      float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
      for (int i = 0; i < n_steps; ++i) {
        const int st = i % STAGES;
        mbar_wait(full(st), (i / STAGES) & 1);
        if (step_grads(i, st, std::true_type{})) {
          pack_frags<T>(s, pa);
          wgmma_fence();
          issue_update<T, D>(dv_acc, pa, do_tile(st));
          wgmma_commit();
          pack_frags<T>(dp, da);
          wgmma_fence();
          issue_update<T, D>(dk_acc, da, q_tile(st));
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(dv_acc);
          fence_regs(dk_acc);
        }
        release(empty(st));  // dK's product has read Q, dV's dO
      }
      store(dk, dk_acc, sm_scale);
      store(dv, dv_acc, 1.f);
    } else {
      // d 256: dV += (P o M)^T dO over every step, then dK += dS^T Q over
      // the same steps streamed again (ring indices n_steps .. 2 n_steps).
      auto pass = [&](auto dk_pass) {
        constexpr bool DK = decltype(dk_pass)::value;
        float acc[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
        for (int i = DK ? n_steps : 0; i < (DK ? 2 : 1) * n_steps; ++i) {
          const int st = i % STAGES;
          mbar_wait(full(st), (i / STAGES) & 1);
          if (step_grads(i, st, dk_pass)) {
            if constexpr (DK) pack_frags<T>(dp, da);
            else pack_frags<T>(s, pa);
            wgmma_fence();
            if constexpr (DK) issue_update<T, D>(acc, da, q_tile(st));
            else issue_update<T, D>(acc, pa, do_tile(st));
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(acc);
          }
          release(empty(st));  // this pass's product has read its stage
        }
        store(DK ? dk : dv, acc, DK ? sm_scale : 1.f);
      };
      pass(std::false_type{});
      pass(std::true_type{});
    }
  }
}

template <typename T, int D, bool ALIBI, bool DROP, bool SEG, int ST>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dq, int Hq, int Hkv, int Nq, int Nkv, float sm_scale,
                         int causal, int window, float softcap, Mods md) {
  using L = BwdLayout<D, SEG, false, ST>;
  constexpr int STAGES = L::STAGES;
  constexpr int BS = L::BS;
  constexpr int CHUNKS = D / CHUNK;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sQ = base, sdO = base + L::RES_BYTES;
  auto k_tile = [&](int s) { return base + L::U_OFF + s * L::STEP_BYTES; };
  auto v_tile = [&](int s) { return base + L::W_OFF + s * L::STEP_BYTES; };
  auto tile_ids = [&](int s) {  // the segment ids of the K tile in stage s (SEG)
    return reinterpret_cast<int*>(smem + L::ROWS_OFF) + s * BS;
  };
  const uint32_t bar_q = base + L::BAR_OFF;
  auto full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };

  const int m0 = (gridDim.x - 1 - blockIdx.x) * BR;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int kv_bh = b * Hkv + h / (Hq / Hkv);
  const TileRange tiles = kv_tiles<BR, BS>(m0, Nq, Nkv, causal, window);
  const int n_tiles = tiles.hi - tiles.lo;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  constexpr int PRODUCERS = SEG ? 32 : 1;
  constexpr int PRODUCER_REGS = SEG ? 32 : 24;
  constexpr int CONSUMER_REGS = SEG ? 232 : 240;
  static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= THREADS * LAUNCH_REGS,
                "the register split exceeds the CTA's registers");
  if (threadIdx.x < 128) {
    // Producer warpgroup: thread 0 issues every copy; with segment ids its
    // warp stages each K tile's ids.  Threads with nothing to do leave.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x < PRODUCERS) {
      const bool leader = threadIdx.x == 0;
      if (leader) {
        mbar_expect_tx(bar_q, 2 * L::RES_BYTES);
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c) {
          tma_load_3d(sQ + c * (BR * 128), &tm_q, bar_q, c * CHUNK, m0, bh);
          tma_load_3d(sdO + c * (BR * 128), &tm_do, bar_q, c * CHUNK, m0, bh);
        }
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const int n0 = (tiles.lo + i) * BS;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        if constexpr (SEG) {
          for (int x = threadIdx.x; x < BS; x += 32)
            tile_ids(s)[x] = seg_id(md.kv_seg, b, Nkv, n0 + x);
          __syncwarp();  // the ids are written before the full barrier completes
        }
        if (leader) {
          mbar_expect_tx(full(s), 2 * L::STEP_BYTES);
#pragma unroll
          for (int c = 0; c < CHUNKS; ++c) {
            tma_load_3d(k_tile(s) + c * (BS * 128), &tm_k, full(s), c * CHUNK, n0, kv_bh);
            tma_load_3d(v_tile(s) + c * (BS * 128), &tm_v, full(s), c * CHUNK, n0, kv_bh);
          }
        }
      }
    }
  } else {
    // Consumer warpgroups 0 and 1: q rows [m0 + 64 * cw, + 64).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int mw = m0 + WG_ROWS * cw;
    const int row0 = mw + 16 * warp + g;  // this thread's rows: row0, row0 + 8
    const int q_off = Nkv - Nq;
    const float scale_log2 = sm_scale * kLog2e;
    const float slope = ALIBI ? md.slopes[h] : 0.f;
    const float slope_log2 = slope * kLog2e;
    const uint32_t stream = DROP ? dropout_stream(md.seed, b, h) : 0u;
    const uint32_t keep_min = DROP ? uint32_t(ceilf(md.rate * 16777216.f)) : 0u;
    // this thread's rows' lse (base 2), D and segment ids; 0 past Nq
    float lse2[2], dlt[2];
    int qseg[2] = {0, 0};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lse2[r] = row < Nq ? lse[size_t(bh) * Nq + row] * kLog2e : 0.f;
      dlt[r] = row < Nq ? delta[size_t(bh) * Nq + row] : 0.f;
      if (SEG) qseg[r] = seg_id(md.q_seg, b, Nq, row);
    }

    // S, then P; dP, then dS: element e of n-tile j is row row0 + 8 (e >> 1),
    // key n0 + 8 j + 2 t + (e & 1).
    float s[BS / 2], dp[BS / 2], acc[D / 2];
    uint32_t da[BS / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint32_t q_rows = sQ + cw * (WG_ROWS * 128), do_rows = sdO + cw * (WG_ROWS * 128);

    // dS of keys [n0, n0 + BS) (stage st) in place of dP.
    auto grads = [&](int n0, int st, auto cap, auto masked) {
      const int* ids = tile_ids(st);
      const float dist0[2] = {float(row0 + q_off - n0 - 2 * t),
                              float(row0 + 8 + q_off - n0 - 2 * t)};
#pragma unroll
      for (int j = 0; j < BS / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = n0 + 8 * j + 2 * t + c;
          // the dropout hash's column half, shared by the thread's two rows
          const uint32_t inner = DROP ? lowbias32(uint32_t(col) + stream) : 0u;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + c;
            const float dist = dist0[r] - float(8 * j + c);
            float x, dcap = 1.f;
            if constexpr (decltype(cap)::value) {
              const float th = tanhf(s[4 * j + e] * sm_scale / softcap);
              x = softcap * th;
              dcap = 1.f - th * th;
              if (ALIBI) x -= slope * dist;
              x = x * kLog2e - lse2[r];
            } else {
              x = s[4 * j + e] * scale_log2 - lse2[r];
              if (ALIBI) x -= slope_log2 * dist;
            }
            float p = exp2_ftz(x);
            if constexpr (decltype(masked)::value) {
              if (!visible(row0 + 8 * r, col, Nq, Nkv, causal, window) ||
                  (SEG && qseg[r] != ids[col - n0]))
                p = 0.f;
            }
            float dpv = dp[4 * j + e];
            if (DROP) {
              const uint32_t bits = lowbias32(uint32_t(row0 + 8 * r) ^ inner);
              dpv = (bits & 0xFFFFFFu) >= keep_min ? dpv * md.keep_scale : 0.f;
            }
            dp[4 * j + e] = p * (dpv - dlt[r]) * dcap;
          }
        }
      }
    };

    mbar_wait(bar_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % STAGES;
      const int n0 = (tiles.lo + i) * BS;
      mbar_wait(full(st), (i / STAGES) & 1);
      if (!tile_hidden<WG_ROWS, BS>(mw, n0, Nq, Nkv, causal, window)) {
        wgmma_fence();
        issue_scores<T, D>(s, q_rows, k_tile(st));
        issue_scores<T, D>(dp, do_rows, v_tile(st));
        wgmma_commit();
        const bool masked =
            SEG || !tile_unmasked<WG_ROWS, BS>(mw, n0, Nq, Nkv, causal, window);
        const std::true_type yes{};
        const std::false_type no{};
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);
        if (softcap > 0.f) {
          if (masked) grads(n0, st, yes, yes);
          else grads(n0, st, yes, no);
        } else {
          if (masked) grads(n0, st, no, yes);
          else grads(n0, st, no, no);
        }
        pack_frags<T>(dp, da);
        wgmma_fence();
        issue_update<T, D>(acc, da, k_tile(st));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }
      release(empty(st));  // dQ's product has read K
    }

    T* dqb = dq + size_t(bh) * Nq * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Nq) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dqb + size_t(row) * D + 8 * j + 2 * t) =
            Mma<T>::pack(acc[4 * j + 2 * r] * sm_scale, acc[4 * j + 2 * r + 1] * sm_scale);
      }
    }
  }
}

}  // namespace sm90

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// The tensor maps of a sweep: q and dO in boxes of `q_rows` rows, k and v
// in boxes of `kv_rows`.
template <typename T, int D>
bool encode_sweep_maps(const Args& a, int q_rows, int kv_rows, CUtensorMap* tm_q,
                       CUtensorMap* tm_k, CUtensorMap* tm_v, CUtensorMap* tm_do) {
  return sm90::encode_map<T>(tm_q, a.q, D, a.Nq, a.B * a.Hq, q_rows) &&
         sm90::encode_map<T>(tm_do, a.dout, D, a.Nq, a.B * a.Hq, q_rows) &&
         sm90::encode_map<T>(tm_k, a.k, D, a.Nkv, a.B * a.Hkv, kv_rows) &&
         sm90::encode_map<T>(tm_v, a.v, D, a.Nkv, a.B * a.Hkv, kv_rows);
}

// Calls fn(alibi, drop) with the call's modes as std::integral_constants:
// every mode on the head dim's own streamed tile (stream_tile), none on
// another (attn_bwd_tiles.cu builds those mode-free, and refuses a mode).
template <bool SEG, int D, int ST, typename Fn>
int dispatch_sweep_mods(const Mods& md, Fn&& fn) {
  if constexpr (ST != stream_tile(D)) {
    static_assert(!SEG, "another streamed tile is built without segment ids");
    if (md.q_seg != nullptr || md.slopes != nullptr || md.rate > 0.f)
      return int(cudaErrorInvalidValue);
    return fn(std::false_type{}, std::false_type{});
  } else {
    return dispatch_mods<SEG>(md, [&](auto alibi, auto drop, auto) { return fn(alibi, drop); });
  }
}

// Declared in attn_bwd.cuh: the "wgmma" route of the dK/dV entry, streaming
// ST q rows a stage.
template <bool SEG, typename T, int D, int ST>
int launch_dkv_wgmma(const Args& a, void* dk, void* dv) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  using L = sm90::BwdLayout<D, SEG, true, ST>;
  if (!encode_sweep_maps<T, D>(a, L::BS, sm90::BR, &tm_q, &tm_k, &tm_v, &tm_do))
    return int(cudaErrorInvalidValue);
  return dispatch_sweep_mods<SEG, D, ST>(a.md, [&](auto alibi, auto drop) {
    return launch(sm90::attn_bwd_dkv_wgmma_kernel<T, D, decltype(alibi)::value,
                                                  decltype(drop)::value, SEG, ST>,
                  L::BYTES,
                  dim3((a.Nkv + sm90::BR - 1) / sm90::BR, a.B * a.Hkv), sm90::THREADS,
                  a.stream, tm_q, tm_k, tm_v, tm_do, a.lse, a.delta, static_cast<T*>(dk),
                  static_cast<T*>(dv), a.Hq, a.Hkv, a.Nq, a.Nkv, a.sm_scale, a.causal,
                  a.window, a.softcap, a.md);
  });
}

// Dynamic shared memory of a sweep of the build at head dim D streaming ST
// rows a stage (dkv 1: the dK/dV sweep, 0: dQ) on a route (kRouteF32 or
// kRouteWgmma), in bytes.  The fp32 route has one step of its own.
template <bool SEG, int D, int ST = stream_tile(D)>
int bwd_shared_bytes(int dkv, int route) {
  if (route == kRouteF32)
    return dkv ? int(dkv_f32_smem_bytes<D, SEG>()) : int(dq_f32_smem_bytes<D, SEG>());
  return dkv ? int(sm90::BwdLayout<D, SEG, true, ST>::BYTES)
             : int(sm90::BwdLayout<D, SEG, false, ST>::BYTES);
}

// Declared in attn_bwd.cuh: the "wgmma" route of the dQ entry, streaming ST
// keys a stage.
template <bool SEG, typename T, int D, int ST>
int launch_dq_wgmma(const Args& a, void* dq) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  using L = sm90::BwdLayout<D, SEG, false, ST>;
  if (!encode_sweep_maps<T, D>(a, sm90::BR, L::BS, &tm_q, &tm_k, &tm_v, &tm_do))
    return int(cudaErrorInvalidValue);
  return dispatch_sweep_mods<SEG, D, ST>(a.md, [&](auto alibi, auto drop) {
    return launch(sm90::attn_bwd_dq_wgmma_kernel<T, D, decltype(alibi)::value,
                                                 decltype(drop)::value, SEG, ST>,
                  L::BYTES,
                  dim3((a.Nq + sm90::BR - 1) / sm90::BR, a.B * a.Hq), sm90::THREADS,
                  a.stream, tm_q, tm_k, tm_v, tm_do, a.lse, a.delta, static_cast<T*>(dq),
                  a.Hq, a.Hkv, a.Nq, a.Nkv, a.sm_scale, a.causal, a.window, a.softcap,
                  a.md);
  });
}

}  // namespace
