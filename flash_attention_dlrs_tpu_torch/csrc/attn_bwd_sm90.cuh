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
//    attn_bwd_d256_seg.cu, every mode a flag as at d 64 and 128) has sweeps
//    of its own shape, since a warpgroup of 64 keys cannot hold dK and dV
//    (2 x 128 fp32 a thread) and two resident 128-row tiles leave room for
//    32-row stages only.  dK/dV (attn_bwd_dkv_split_wgmma_kernel, layout
//    DkvD256Layout) makes one pass, 8 d operations a visible pair: a CTA
//    owns 64 keys (K and V resident, 64 KB) and streams 64-row Q / dO
//    stages, 2 deep.  The scores are split by keys: each consumer
//    warpgroup computes S = Q K^T and dP = dO V^T for the stage's 64 q
//    rows (the wgmma's M, not transposed) against its own 32 keys, over all
//    256 columns, and runs the element loop once on them (lse and D per
//    row, the dropout hash's key half per column).  It writes P o M and dS,
//    rounded to T, into a shared 64 x 64 tile each; after an mbarrier that
//    both warpgroups arrive on, the updates are split by columns: each
//    warpgroup adds dV[:, its 128 columns] += (P o M)^T dO and dK[:, its
//    128] += dS^T Q, A the P / dS tile and B the stage, both read MN-major
//    (64 + 64 fp32 accumulators a thread).  A step runs in order (scores,
//    element loop, exchange, updates) and its stage is released once both
//    updates are done; the tiles are rewritten once both warpgroups'
//    updates from them are done (a second mbarrier).  dQ keeps the CTA of
//    two 64-row owners of all 256 columns (Q and dO resident, 128 KB) and
//    32-key stages, 3 deep, and is pipelined: tile i's S and dP are issued
//    beside tile i - 1's dQ += dS K (wait_group 1), and tile i's element
//    loop runs while that update finishes; a K / V stage is released once
//    its update is done.  Both sweeps take the softcap's tanh and
//    1 - tanh^2 from one ex2 and one rcp (softcap_tanh: no divide or tanhf
//    a score), the forward's P within a few 2^-24 of the logit's cap.
//    Shared memory: dK/dV 215,096 bytes (215,608 with segment ids), dQ
//    230,456 (230,840).  With dropout the one pass regenerates the keep
//    mask once a pair, for P o M and dS alike.
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
template <int D, bool SEG, bool DKV, int ST = stream_tile(D, DKV)>
struct BwdLayout {
  // streamed rows per stage (q rows in dK/dV, keys in dQ) and stages: 64 x 4,
  // and 32 x 3 in the d 256 dQ sweep (the d 256 dK/dV sweep has a layout of
  // its own, DkvD256Layout); attn_bwd_tiles.cu's 32-row stages at d 64 and
  // 128 keep 4
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
  static_assert(!(DKV && D == 256), "the d 256 dK/dV sweep is laid out by DkvD256Layout");
};

// Shared memory of the d 256 dK/dV sweep's CTA, in bytes from a 1024-byte
// aligned base: K and V for its 64 keys, the Q and dO stages of 64 q rows,
// the P o M and dS tiles (64 q rows x 64 keys, one 128-byte swizzled row a
// q row), each stage's lse (base 2), D and with segment ids q ids, then the
// barriers (resident full; per stage full and empty; the tiles' full and
// empty).
template <bool SEG>
struct DkvD256Layout {
  static constexpr int D = 256;
  static constexpr int BN = 64;      // keys a CTA
  static constexpr int BS = 64;      // q rows a stage
  static constexpr int STAGES = 2;
  static constexpr uint32_t RES_BYTES = BN * D * 2;   // K or V
  static constexpr uint32_t STEP_BYTES = BS * D * 2;  // Q or dO of a stage
  static constexpr uint32_t TILE_BYTES = BS * BN * 2; // P o M or dS
  static constexpr uint32_t U_OFF = 2 * RES_BYTES;
  static constexpr uint32_t W_OFF = U_OFF + STAGES * STEP_BYTES;
  static constexpr uint32_t P_OFF = W_OFF + STAGES * STEP_BYTES;
  static constexpr uint32_t DS_OFF = P_OFF + TILE_BYTES;
  static constexpr int ROW_ARRAYS = 2 + (SEG ? 1 : 0);
  static constexpr uint32_t ROWS_OFF = DS_OFF + TILE_BYTES;
  static constexpr uint32_t BAR_OFF = ROWS_OFF + STAGES * ROW_ARRAYS * BS * 4;
  static constexpr size_t BYTES = BAR_OFF + 8 * (1 + 2 * STAGES + 2) + 1024;  // + alignment
  static_assert(BYTES <= 232448, "a CTA has 227 KB of shared memory");
};

// S = A B^T over d, issued (not committed): A 64 rows at `a_rows` and B N
// rows at `b_rows`, both K-major in 64-column chunks A_CHUNK and B_CHUNK
// bytes apart (the d 256 dK/dV sweep's scores: a stage's q rows against a
// warpgroup's keys of the resident K or V).
template <typename T, int D, int N, uint32_t A_CHUNK, uint32_t B_CHUNK>
__device__ __forceinline__ void issue_scores_to(float (&acc)[N / 2], uint32_t a_rows,
                                                uint32_t b_rows) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t in_chunk = (ks % 4) * 32;
    WgmmaSS<N, T>::run(acc, smem_desc(a_rows + (ks / 4) * A_CHUNK + in_chunk, 16, 1024),
                       smem_desc(b_rows + (ks / 4) * B_CHUNK + in_chunk, 16, 1024), ks > 0);
  }
}

// S = A B^T of one warpgroup over d, issued (not committed): A the
// warpgroup's 64 rows of a resident tile at `a_rows`, B the streamed tile of
// BS = 2 HALF rows at `b_tile`, both K-major (16 columns a k-step, 32 bytes
// apart inside a 128-byte chunk of 64 columns).
template <typename T, int D, int HALF>
__device__ __forceinline__ void issue_scores(float (&acc)[HALF], uint32_t a_rows,
                                             uint32_t b_tile) {
  issue_scores_to<T, D, 2 * HALF, BR * 128, 2 * HALF * 128>(acc, a_rows, b_tile);
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

// One arrival per warp on a barrier of both consumer warpgroups' warps
// (count 8), after every lane's part: its reads of a stage (an empty
// barrier), or its writes of the d 256 dK/dV sweep's P o M and dS tiles.
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
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % STAGES, step = i;
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

    // P^T o M and dS^T of q step m0 (stage st) in place of S^T and dP^T, in
    // base-2 units; the softcap and the mask are compiled out of the loop
    // when the call or the tile needs neither.
    auto grads = [&](int m0, int st, float slope, uint32_t stream, auto cap, auto masked) {
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
          const float dpv = DROP ? dp[4 * j + e] * keep : dp[4 * j + e];
          dp[4 * j + e] = p * (dpv - (c ? d2.y : d2.x)) * dcap;
        }
      }
    };

    // q step `step` in the stage st: S^T and dP^T, then P^T o M and dS^T in
    // their place; false, and nothing run, when the warpgroup's keys see no
    // row of the step.
    auto step_grads = [&](int step, int st) -> bool {
      const int m0 = (steps.lo + step % per_head) * BS;
      if (tile_hidden<BS, WG_ROWS>(m0, nw, Nq, Nkv, causal, window)) return false;
      wgmma_fence();
      issue_scores<T, D>(s, k_rows, q_tile(st));
      issue_scores<T, D>(dp, v_rows, do_tile(st));
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
      fence_regs(dp);
      if (softcap > 0.f) {
        if (masked) grads(m0, st, slope, stream, yes, yes);
        else grads(m0, st, slope, stream, yes, no);
      } else {
        if (masked) grads(m0, st, slope, stream, no, yes);
        else grads(m0, st, slope, stream, no, no);
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
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    for (int i = 0; i < n_steps; ++i) {
      const int st = i % STAGES;
      mbar_wait(full(st), (i / STAGES) & 1);
      if (step_grads(i, st)) {
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
  }
}

// The d 256 dK/dV sweep in T = bf16 / fp16, one pass (8 d operations a
// visible pair): one CTA per (64-key tile, batch x kv head), laid out by
// DkvD256Layout.  Consumer warpgroup cw computes S and dP for a stage's 64
// q rows against its keys [n0 + 32 cw, + 32), builds P o M and dS there and
// writes them, rounded to T, into the shared tiles; both warpgroups then
// add dV[:, 128 cw + (0..128)] += (P o M)^T dO and dK[:, ...] += dS^T Q over
// all 64 keys.
template <typename T, int D, bool ALIBI, bool DROP, bool SEG>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dkv_split_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const __grid_constant__ CUtensorMap tm_do,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv, int Nq,
                                int Nkv, float sm_scale, int causal, int window, float softcap,
                                Mods md) {
  static_assert(D == 256, "the split dK/dV sweep is the d 256 build's");
  using L = DkvD256Layout<SEG>;
  constexpr int STAGES = L::STAGES, BS = L::BS, BN = L::BN;
  constexpr int CHUNKS = D / CHUNK;
  constexpr int HALF = BN / 2;  // keys of a warpgroup's scores

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
  const uint32_t tiles_full = bar_kv + 8u * (1 + 2 * STAGES);  // P o M and dS written
  const uint32_t tiles_empty = tiles_full + 8u;                 // both updates read them

  const int n0 = blockIdx.x * BN;  // causal: the first key tiles see the most q rows
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;
  const int group = Hq / Hkv;
  const TileRange steps = q_tiles<BS, BN>(n0, Nq, Nkv, causal, window);
  const int per_head = steps.hi - steps.lo;
  const int n_steps = group * per_head;  // q heads of the group, then their steps

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    mbar_init(tiles_full, 8);
    mbar_init(tiles_empty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

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
          tma_load_3d(sK + c * (BN * 128), &tm_k, bar_kv, c * CHUNK, n0, blockIdx.y);
          tma_load_3d(sV + c * (BN * 128), &tm_v, bar_kv, c * CHUNK, n0, blockIdx.y);
        }
      }
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % STAGES;
        // the stage's previous step released (passes at once on the first lap)
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        const int bh = b * Hq + kvh * group + i / per_head;
        const int m0 = (steps.lo + i % per_head) * BS;
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
    // Consumer warpgroups 0 and 1: scores against keys [n0 + 32 cw, + 32),
    // updates of columns [128 cw, + 128).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;  // accumulator row group / column pair
    const int nw = n0 + HALF * cw;
    const int r0 = 16 * warp + g;  // this thread's rows of a step: r0, r0 + 8
    const int q_off = Nkv - Nq;
    const float scale_log2 = sm_scale * kLog2e;
    // the softcap folded once: tanh's argument in ex2 units, the cap in log2
    const float cap_k2 = softcap > 0.f ? 2.f * kLog2e * sm_scale / softcap : 0.f;
    const float cap_log2 = softcap * kLog2e;
    const uint32_t keep_min = DROP ? uint32_t(ceilf(md.rate * 16777216.f)) : 0u;
    // segment ids of this thread's score columns, key nw + 8 j + 2 t + c at
    // index 2 j + c (SEG)
    int kseg[HALF / 4];
#pragma unroll
    for (int x = 0; x < HALF / 4; ++x)
      kseg[x] = SEG ? seg_id(md.kv_seg, b, Nkv, nw + 8 * (x / 2) + 2 * t + x % 2) : 0;
    uint32_t inner[HALF / 4];  // the dropout hash's key half, for the q head `inner_h`
    int inner_h = -1;

    // S, then P o M; dP, then dS: element e of n-tile j is q row
    // m0 + r0 + 8 (e >> 1), key nw + 8 j + 2 t + (e & 1).
    float s[HALF / 2], dp[HALF / 2], dk_acc[64], dv_acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const uint32_t k_keys = sK + cw * (HALF * 128), v_keys = sV + cw * (HALF * 128);
    const uint32_t p_tile = base + L::P_OFF, ds_tile = base + L::DS_OFF;

    // P o M and dS of q step m0 (stage st) in place of S and dP, in base-2
    // units; the softcap and the mask compiled out where the call or the
    // tile needs neither.
    auto grads = [&](int m0, int st, float slope, auto cap, auto masked) {
      const float* lse2 = rows_of(st, 0);
      const float* dlt = rows_of(st, 1);
      const int* qseg = reinterpret_cast<const int*>(rows_of(st, 2));
      const float slope_log2 = slope * kLog2e;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + r0 + 8 * r;
        const float l2 = lse2[r0 + 8 * r], d2 = dlt[r0 + 8 * r];
        const int qs = SEG ? qseg[r0 + 8 * r] : 0;
        // the ALiBi distance q_pos - key, exact in fp32
        const float dist0 = float(row + q_off - nw - 2 * t);
#pragma unroll
        for (int j = 0; j < HALF / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * r + c;
            const int key = nw + 8 * j + 2 * t + c;
            const float dist = dist0 - float(8 * j + c);
            float x, dcap = 1.f;
            if constexpr (decltype(cap)::value) {
              const float th = softcap_tanh(s[e], cap_k2);
              dcap = fmaf(-th, th, 1.f);
              x = th * cap_log2 - l2;
            } else {
              x = s[e] * scale_log2 - l2;
            }
            if (ALIBI) x -= slope_log2 * dist;
            float p = exp2_ftz(x);
            if constexpr (decltype(masked)::value) {
              if (!visible(row, key, Nq, Nkv, causal, window) || (SEG && kseg[2 * j + c] != qs))
                p = 0.f;
            }
            float keep = 1.f;
            if (DROP) {
              const uint32_t bits = lowbias32(uint32_t(row) ^ inner[2 * j + c]);
              keep = (bits & 0xFFFFFFu) >= keep_min ? md.keep_scale : 0.f;
            }
            s[e] = DROP ? p * keep : p;
            const float dpv = DROP ? dp[e] * keep : dp[e];
            dp[e] = p * (dpv - d2) * dcap;
          }
        }
      }
    };

    // P o M and dS, rounded to T, into the tiles: q row r0 + 8 r is a
    // 128-byte row, its 16-byte unit u (keys 8 u ..) stored at u ^ (row % 8)
    // (the 128-byte swizzle the updates' descriptors read).
    auto write_tiles = [&]() {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
#pragma unroll
        for (int j = 0; j < HALF / 8; ++j) {
          const uint32_t at =
              row * 128 + ((((HALF / 8) * cw + j) ^ (row & 7)) << 4) + 4 * t;
          *reinterpret_cast<uint32_t*>(smem + L::P_OFF + at) =
              Mma<T>::pack(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
          *reinterpret_cast<uint32_t*>(smem + L::DS_OFF + at) =
              Mma<T>::pack(dp[4 * j + 2 * r], dp[4 * j + 2 * r + 1]);
        }
      }
    };

    // The update products of the stage st from the tiles, issued: 4
    // k-steps of 16 q rows each, A (64 keys) and B (the warpgroup's 128
    // columns, two 64-column chunks BS * 128 bytes apart) read MN-major.
    auto issue_updates = [&](int st) {
      const uint32_t cols = cw * 2 * (BS * 128);
#pragma unroll
      for (int kk = 0; kk < BS / 16; ++kk)
        WgmmaSSt<T>::run(dv_acc, smem_desc(p_tile + kk * 2048, BS * 128, 1024),
                         smem_desc(do_tile(st) + cols + kk * 2048, BS * 128, 1024));
#pragma unroll
      for (int kk = 0; kk < BS / 16; ++kk)
        WgmmaSSt<T>::run(dk_acc, smem_desc(ds_tile + kk * 2048, BS * 128, 1024),
                         smem_desc(q_tile(st) + cols + kk * 2048, BS * 128, 1024));
    };

    // Each step in order: the scores, the element loop, the tiles
    // exchanged, the updates; the stage is released once both updates are
    // done (2 stages: the next but one step's copies then have a whole
    // step to land).  A warpgroup whose keys see no row of a step still
    // runs it, masked (P = 0): every wgmma is issued and waited on one
    // path, which keeps ptxas from serializing them.
    mbar_wait(bar_kv, 0);
    int x = 0;  // tiles exchanged so far
    for (int i = 0; i < n_steps; ++i) {
      const int st = i % STAGES;
      const int m0 = (steps.lo + i % per_head) * BS;
      mbar_wait(full(st), (i / STAGES) & 1);
      if (tile_hidden<BS, BN>(m0, n0, Nq, Nkv, causal, window)) {  // both warpgroups alike
        release(empty(st));
        continue;
      }
      const int h = kvh * group + i / per_head;  // the q head: slope, dropout stream
      const float slope = ALIBI ? md.slopes[h] : 0.f;
      if (DROP && h != inner_h) {
        const uint32_t stream = dropout_stream(md.seed, b, h);
#pragma unroll
        for (int y = 0; y < HALF / 4; ++y)
          inner[y] = lowbias32(uint32_t(nw + 8 * (y / 2) + 2 * t + y % 2) + stream);
        inner_h = h;
      }
      const bool masked = SEG || !tile_unmasked<BS, HALF>(m0, nw, Nq, Nkv, causal, window);
      const std::true_type yes{};
      const std::false_type no{};
      wgmma_fence();
      issue_scores_to<T, D, HALF, BS * 128, BN * 128>(s, q_tile(st), k_keys);
      issue_scores_to<T, D, HALF, BS * 128, BN * 128>(dp, do_tile(st), v_keys);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      if (softcap > 0.f) {
        if (masked) grads(m0, st, slope, yes, yes);
        else grads(m0, st, slope, yes, no);
      } else {
        if (masked) grads(m0, st, slope, no, yes);
        else grads(m0, st, slope, no, no);
      }
      // both warpgroups' updates from the tiles' last contents done
      if (x > 0) mbar_wait(tiles_empty, (x - 1) & 1);
      write_tiles();
      fence_proxy_async();  // the tiles' stores before the updates' reads
      release(tiles_full);
      mbar_wait(tiles_full, x & 1);
      wgmma_fence();
      issue_updates(st);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      release(tiles_empty);
      release(empty(st));  // both updates have read Q and dO
      ++x;
    }

    // this thread's rows (keys n0 + r0, + 8) of dK (times sm_scale) and dV,
    // columns 128 cw + 8 j + 2 t
    const size_t out = (size_t(b) * Hkv + kvh) * size_t(Nkv) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = n0 + r0 + 8 * r;
      if (key >= Nkv) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const size_t at = out + size_t(key) * D + 128 * cw + 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(dk + at) = Mma<T>::pack(
            dk_acc[4 * j + 2 * r] * sm_scale, dk_acc[4 * j + 2 * r + 1] * sm_scale);
        *reinterpret_cast<uint32_t*>(dv + at) =
            Mma<T>::pack(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
      }
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
    // d 256: the softcap folded once (softcap_tanh's argument, the cap in log2)
    const float cap_k2 = softcap > 0.f ? 2.f * kLog2e * sm_scale / softcap : 0.f;
    const float cap_log2 = softcap * kLog2e;
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
            if constexpr (decltype(cap)::value && D == 256) {
              const float th = softcap_tanh(s[4 * j + e], cap_k2);
              dcap = fmaf(-th, th, 1.f);
              x = th * cap_log2 - lse2[r];
              if (ALIBI) x -= slope_log2 * dist;
            } else if constexpr (decltype(cap)::value) {
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

    // dS of the tile at n0 (stage st) in place of dP, S and dP read: the
    // softcap and the mask compiled out where the call or the tile needs
    // neither.
    auto elements = [&](int n0, int st) {
      const bool masked = SEG || !tile_unmasked<WG_ROWS, BS>(mw, n0, Nq, Nkv, causal, window);
      const std::true_type yes{};
      const std::false_type no{};
      if (softcap > 0.f) {
        if (masked) grads(n0, st, yes, yes);
        else grads(n0, st, yes, no);
      } else {
        if (masked) grads(n0, st, no, yes);
        else grads(n0, st, no, no);
      }
    };

    mbar_wait(bar_q, 0);
    if constexpr (D == 256) {
      // Pipelined: tile i's S and dP are issued beside dQ's update from
      // tile i - 1, and tile i's element loop runs while that update
      // finishes; stage i - 1 is released once it is done.  Every tile of
      // the CTA's range runs, a warpgroup's hidden ones masked (P = 0), so
      // that every wgmma is issued and waited on one path.
      if (n_tiles > 0) {
        mbar_wait(full(0), 0);
        wgmma_fence();
        issue_scores<T, D>(s, q_rows, k_tile(0));
        issue_scores<T, D>(dp, do_rows, v_tile(0));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);
        elements(tiles.lo * BS, 0);
        pack_frags<T>(dp, da);
        for (int i = 1; i < n_tiles; ++i) {
          const int st = i % STAGES, prev = (i - 1) % STAGES;
          const int n0 = (tiles.lo + i) * BS;
          mbar_wait(full(st), (i / STAGES) & 1);
          wgmma_fence();
          issue_scores<T, D>(s, q_rows, k_tile(st));
          issue_scores<T, D>(dp, do_rows, v_tile(st));
          wgmma_commit();
          issue_update<T, D>(acc, da, k_tile(prev));  // dQ: tile i - 1
          wgmma_commit();
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          fence_regs(s);
          fence_regs(dp);
          elements(n0, st);
          wgmma_wait_all();
          fence_regs(acc);
          release(empty(prev));
          pack_frags<T>(dp, da);
        }
        const int last = (n_tiles - 1) % STAGES;
        wgmma_fence();
        issue_update<T, D>(acc, da, k_tile(last));  // dQ: the last tile
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        release(empty(last));
      }
    } else {
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES;
        const int n0 = (tiles.lo + i) * BS;
        mbar_wait(full(st), (i / STAGES) & 1);
        if (!tile_hidden<WG_ROWS, BS>(mw, n0, Nq, Nkv, causal, window)) {
          wgmma_fence();
          issue_scores<T, D>(s, q_rows, k_tile(st));
          issue_scores<T, D>(dp, do_rows, v_tile(st));
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(s);
          fence_regs(dp);
          elements(n0, st);
          pack_frags<T>(dp, da);
          wgmma_fence();
          issue_update<T, D>(acc, da, k_tile(st));
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(acc);
        }
        release(empty(st));  // dQ's product has read K
      }
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
// every mode on the sweep's own streamed tile at the head dim (stream_tile),
// none on another (attn_bwd_tiles.cu builds those mode-free, and refuses a
// mode).
template <bool SEG, int D, int ST, bool DKV, typename Fn>
int dispatch_sweep_mods(const Mods& md, Fn&& fn) {
  if constexpr (ST != stream_tile(D, DKV)) {
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
  if constexpr (D == 256) {
    using L = sm90::DkvD256Layout<SEG>;
    static_assert(ST == L::BS, "the d 256 dK/dV sweep streams its layout's q rows");
    if (!encode_sweep_maps<T, D>(a, L::BS, L::BN, &tm_q, &tm_k, &tm_v, &tm_do))
      return int(cudaErrorInvalidValue);
    return dispatch_sweep_mods<SEG, D, ST, true>(a.md, [&](auto alibi, auto drop) {
      return launch(sm90::attn_bwd_dkv_split_wgmma_kernel<T, D, decltype(alibi)::value,
                                                          decltype(drop)::value, SEG>,
                    L::BYTES, dim3((a.Nkv + L::BN - 1) / L::BN, a.B * a.Hkv), sm90::THREADS,
                    a.stream, tm_q, tm_k, tm_v, tm_do, a.lse, a.delta, static_cast<T*>(dk),
                    static_cast<T*>(dv), a.Hq, a.Hkv, a.Nq, a.Nkv, a.sm_scale, a.causal,
                    a.window, a.softcap, a.md);
    });
  } else {
    using L = sm90::BwdLayout<D, SEG, true, ST>;
    if (!encode_sweep_maps<T, D>(a, L::BS, sm90::BR, &tm_q, &tm_k, &tm_v, &tm_do))
      return int(cudaErrorInvalidValue);
    return dispatch_sweep_mods<SEG, D, ST, true>(a.md, [&](auto alibi, auto drop) {
      return launch(sm90::attn_bwd_dkv_wgmma_kernel<T, D, decltype(alibi)::value,
                                                    decltype(drop)::value, SEG, ST>,
                    L::BYTES,
                    dim3((a.Nkv + sm90::BR - 1) / sm90::BR, a.B * a.Hkv), sm90::THREADS,
                    a.stream, tm_q, tm_k, tm_v, tm_do, a.lse, a.delta, static_cast<T*>(dk),
                    static_cast<T*>(dv), a.Hq, a.Hkv, a.Nq, a.Nkv, a.sm_scale, a.causal,
                    a.window, a.softcap, a.md);
    });
  }
}

// Dynamic shared memory of a sweep of the build at head dim D (dkv 1: the
// dK/dV sweep, streaming DKV_ST q rows a stage; 0: dQ, DQ_ST keys) on a
// route (kRouteF32 or kRouteWgmma), in bytes.  The fp32 route has one step
// of its own.
template <bool SEG, int D, int DKV_ST = stream_tile(D, true),
          int DQ_ST = stream_tile(D, false)>
int bwd_shared_bytes(int dkv, int route) {
  if (route == kRouteF32)
    return dkv ? int(dkv_f32_smem_bytes<D, SEG>()) : int(dq_f32_smem_bytes<D, SEG>());
  if (!dkv) return int(sm90::BwdLayout<D, SEG, false, DQ_ST>::BYTES);
  if constexpr (D == 256) return int(sm90::DkvD256Layout<SEG>::BYTES);
  else return int(sm90::BwdLayout<D, SEG, true, DKV_ST>::BYTES);
}

// Declared in attn_bwd.cuh: the "wgmma" route of the dQ entry, streaming ST
// keys a stage.
template <bool SEG, typename T, int D, int ST>
int launch_dq_wgmma(const Args& a, void* dq) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  using L = sm90::BwdLayout<D, SEG, false, ST>;
  if (!encode_sweep_maps<T, D>(a, sm90::BR, L::BS, &tm_q, &tm_k, &tm_v, &tm_do))
    return int(cudaErrorInvalidValue);
  return dispatch_sweep_mods<SEG, D, ST, false>(a.md, [&](auto alibi, auto drop) {
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
