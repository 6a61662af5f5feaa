// Attention kernels for head dims above 256, sm_90a: the 16-bit forward,
// paged verify and both backward sweeps on Hopper's warpgroup products
// (route "wide_wgmma"), the fp32 forward, verify and sweeps on
// column-chunked tiles, paged decode on asynchronous page copies, and
// verify's merge of key splits.  Included by
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
// O accumulator 256 registers a thread of a warpgroup; at d 1024 a 64-row
// O is all 256 KB of an SM's registers.  So D is a runtime width here (any
// multiple of 128) and the work is cut by columns: among the owners of a
// CTA or cluster to 1024 (the wgmma kernels), or one 128-column chunk of
// the output a CTA (the column-chunked kernels, any width).
//
// The 16-bit forward and verify ("wide_wgmma").  Bound on this card by
// operations: at the bench models' d 512 shapes 4 d flops per visible
// (row, key) pair on the tensor cores' 989 TFLOP/s, against 4 d bytes of
// K and V per key.  The mma.sync kernel this one replaced reached ~9% of
// that: a CTA owned one 128-column chunk of O and recomputed S over the
// whole head dim for it (2.5x the flops of one pass at d 512), restaged Q
// for every key tile, and streamed both operands through two cp.async
// stages with a block-wide barrier a chunk.  What this design does:
//  * S once a key tile, the head dim split among owners.  A CTA holds 64 q
//    rows; each of its consumer warpgroups (an owner) owns 64 C of its
//    columns (C <= 4: at most 256, so O takes at most 128 registers a
//    thread, as in the d 256 forward).  Each owner computes a partial S
//    over its own columns of Q and K (wgmma.m64n32k16, both operands in
//    shared memory) and writes it to shared memory; every owner then sums
//    all partials in owner order, so S, the running max, the row sum and P
//    are the same bits in every owner, and runs O[:, its columns] += P
//    V[:, its columns] (wgmma with P from registers, V MN-major).  One
//    owner writes lse.  The flops are one pass's.
//  * Above 512 columns Q, K and V of a 64-row tile outgrow a CTA, so a
//    thread-block cluster splits the columns (cudaLaunchKernelEx with a
//    cluster dimension) and each owner reads its peers' partials from their
//    shared memory (DSMEM), in the same owner order: d 640 and 896 as 5 and
//    7 CTAs of one 128-column owner, d 768 and 1024 as 2 CTAs of two owners
//    (wide_cut).
//  * Q is loaded once: by TMA (3-D maps, so other heads' rows are never
//    read and ragged tails are zero-filled), or in verify staged by each
//    owner, pre-scaled in q's dtype.  K and V stream in tiles of 32 keys
//    through a ring of stages with full / empty mbarriers, filled by a
//    producer warpgroup (setmaxnreg 40 / 232 where a CTA has two owners):
//    TMA boxes, or for paged rows TMA boxes of a page / 16-byte cp.asyncs,
//    and fp8 V or quantized pools converted exactly by the producer from
//    device memory into the 16-bit stage (no staging buffer).  Shared
//    memory (WgLayout): Q, the K and V stages, the owners' 64 x 32 fp32
//    partials, with segment ids each K tile's ids, in verify each stage's
//    K and V scales: at d 512 two stages, 214,112 bytes of the 232,448 a
//    CTA may opt into (214,624 in verify; d 384: three stages).
//  * Carried over from attn_fwd_sm90.cuh: S(i) is issued beside P V(i - 1);
//    the softcap, ALiBi and the mask are compiled out of a tile that needs
//    none; key tiles above the diagonal or outside the window are skipped;
//    causal row tiles run heaviest first; the running max is exact in fp32
//    and the exponentials are ex2.approx.ftz.
//
// The 16-bit backward sweeps ("wide_wgmma": wide_bwd_dkv_kernel,
// wide_bwd_dq_kernel).  Bound on this card by operations: 8 d (dK/dV) and
// 6 d (dQ) flops per visible pair and q head on the tensor cores.  The
// mma.sync sweeps these replaced reached 2-3% of that: a CTA owned one
// 128-column chunk of dK, dV or dQ and recomputed S (and dP) over the whole
// head dim for it, the dK/dV sweep running dV and dK as separate CTAs (at
// d 512 14 units of work against 4; dQ 9 against 3), with every operand
// restaged per tile through two cp.async stages and a block-wide barrier a
// chunk.  What this design does:
//  * S and dP once a tile, the head dim split among owners (consumer
//    warpgroups; wide_bwd_cut): a dK/dV owner holds dK and dV for 128
//    columns, a dQ owner dQ for 256 where D is a multiple of 256 (else
//    128); one owner a CTA, two in the dK/dV sweep at d 512, the rest a
//    thread-block cluster.  Each owner computes partial S and dP over its
//    columns (wgmma.m64n32k16, both operands in shared memory, one commit
//    group) and BwdExchange sums every owner's partials, S then dP, in owner
//    order, in one round trip a tile: each owner writes its partials to its
//    own CTA's shared memory and bulk-copies them into every peer's (DSMEM),
//    so every read is local; every owner then builds the same P and dS.
//  * dK/dV: a cluster holds 64 keys (K and V by TMA, once) and streams
//    32-row Q and dO tiles of each q head of the GQA group in turn (q_tiles
//    skips the rows that see none of the keys), the producer staging each
//    tile's lse (base 2), D and q segment ids beside it; dV += (P o M)^T dO
//    and dK += dS^T Q in one pass (8 d a pair where the old sweeps spent 28
//    d), the stage read MN-major.  dQ: a cluster holds 64 q rows (Q and dO
//    by TMA, heaviest causal tiles first) and streams the 32-key K and V
//    tiles the rows see (kv_tiles); dQ += dS K (K read MN-major) runs beside
//    the next tile's score products, exchange and element loop.
//  * The element loop is attn_bwd_sm90.cuh's: P from the passed natural-base
//    lse in base 2 (ex2.approx.ftz), the softcap, the mask and ALiBi
//    compiled out of a tile that needs none (with_flags), the dropout mask
//    regenerated bit for bit, P and dS rounded to T for the products, dK and
//    dQ scaled by sm_scale once at the end.  A producer warpgroup fills an
//    mbarrier ring (2-4 stages, as many as fit); setmaxnreg 40 / 232 where
//    a CTA has two owners.
//  * What bounds them now (wide_breakdown_torch.py): the exchange, whose
//    cross-CTA round trip a 32-row tile waits on, and the element loop
//    every owner repeats on the whole tile; the products are the smaller
//    part (PERF.md).
//
// The column-chunked forward, verify and sweeps: fp32 at every wide width
// ("wide_fp32"); the cluster cuts end at 1024 (a dK/dV owner of 128
// columns a CTA, 8 CTAs at 1024, and every CTA holds every owner's
// partials: no cut reaches 1152), and the bf16 / fp16 forward, sweeps and
// paged verify above 1024 are wide_scores.cuh's score and product passes
// ("wide_scores").  No width cap:
//  * Products over the head dim (S = Q K^T, dP = dO V^T and their
//    transposes) stream both operands through shared memory in chunks of
//    128 bytes a row (32 fp32 columns), double-buffered by cp.async, into
//    a warp's 16 x 64 block of scores in true fp32 on the CUDA cores.
//    Every CTA sums the chunks in column order, so every CTA that
//    recomputes a tile's scores gets the same bits.
//  * Each CTA owns 64 rows and one 128-column chunk of its output (O, dQ,
//    dK or dV): the update product multiplies the 64-key tile of
//    probabilities (or dS) into that chunk only.  Scores are recomputed
//    for each output chunk: the dK/dV sweep runs dV and dK as separate
//    CTAs (dV needs no dP).
//  * Every output element has one owner and every sum runs in a fixed
//    order (the 16-bit kernels' too); there are no atomics.
//
// Paged decode (wide_decode_kernel), every pool kind.  Bound on this card
// by bytes: each live K / V row is read once (2 d bytes a token a kv head
// per stored byte, plus 8 bytes of scales a token when quantized) for
// about 2 operations a byte, so the design is about keeping copies in
// flight.  The kernel this one replaced reached 26% of that bound (bf16 at
// the serving-d512 heads): each of a CTA's 4 warps took one key at a time,
// loaded its page id, then its K and V rows from device memory, then ran a
// shuffle tree, so every key waited on two dependent trips (~16 KB in
// flight an SM); its registers were sized for 1024 columns at every width,
// and its key splits merged in a second kernel.  What this design does
// (paged_decode.cuh's, at the wide widths):
//  * Templated on the pool kind and the number of 128-column blocks, so
//    registers follow the width: a lane owns D / 32 columns, read from
//    shared memory 16 bytes at a time where the row allows (8 or 4 else).
//    Up to 512 columns two CTAs of 8 warps share an SM (about 100 KB of
//    shared memory and at most 128 registers a thread), above it one.
//  * The split's page ids (and q) land in shared memory beside the
//    length's load; K, V (and the scales) of each tile of 32 D bytes a
//    tensor (16 rows of a 16-bit pool, 32 of int8 / int4, 8 of fp32; 8 rows
//    of fp8, whose float dots of more rows would not fit the registers)
//    land in an mbarrier ring of 2-8 stages, STAGES - 1 tiles in flight
//    while one is reduced: one 1-D bulk copy a tensor where the tile lies
//    in one page, 16-byte cp.asyncs a row where pages are smaller.  Rows
//    stay in their stored type in shared memory, converted in registers;
//    an int4 row is staged once for its two tokens.
//  * A warp reduces whole rows (the tile's rows are spread over the 8
//    warps); the partial dots of all its rows and both heads of the CTA's
//    pair are summed over the warp by one spread_sum, after which each lane
//    makes the one score it holds (scales, softcap, ALiBi, mask: once, not
//    once a score), and every lane takes them all; a token's position comes
//    from its stored row (no division by the page size but for int4).  A
//    warp keeps its own running max, row sum and O, releasing each stage
//    through an empty barrier: no CTA-wide barrier a tile.  The warps merge
//    in warp order.
//  * Key splits merge inside the launch (paged.cuh merge_rows, by the last
//    CTA of each group through a counter it resets), so a call is one
//    launch and CUDA-graph replays stay right.
// What is left (wide_breakdown_torch.py decode, at the serving-d512 heads,
// 8 sequences of 2048 tokens): of ~0.037 ms (bf16) a copy of the kernel
// that only copies takes ~0.030 (an empty call ~0.006 of it), the merge
// of the splits ~0.005 and the reduction the rest; int8 ~0.030 against
// ~0.021 copies only.  Each CTA streams one page (the split planner's two
// CTAs an SM), so the first copy's round trip and the merge's serial L2
// round trips are a large share; fewer, longer splits leave SMs idle.

#pragma once

#include "paged.cuh"

namespace {

constexpr int WROWS = 64;       // rows a CTA owns (q rows; keys in the dK/dV sweep)
constexpr int WKEYS = 64;       // rows of a streamed tile (keys; q rows in the dK/dV sweep)
constexpr int WCOLS = 128;      // output columns a CTA owns
constexpr int WTHREADS = 128;   // 4 warps of 16 rows
// The widest head dim the cluster cuts of the 16-bit wgmma kernels and the
// register-sized decode take; above it the column-chunked kernels carry
// fp32, decode its own column-chunked kernel, and the 16-bit forward,
// sweeps and verify wide_scores.cuh's passes.
constexpr int WIDE_CUT_MAX_D = 1024;

// Route codes of the wide C entries (ops/fwd_kernel.py ROUTE_CODES,
// ops/decode.py VERIFY_ROUTE_CODES): fp32 column-chunked on the CUDA cores,
// and the 16-bit forward, verify and sweeps on wgmma (to 1024; above it
// wide_scores.cuh's passes, code 6).
constexpr int kRouteWideF32 = 2, kRouteWideWgmma = 4;

// Whether D is a head dim of these kernels: any multiple of 128 above 256.
__host__ __device__ constexpr bool wide_head_dim(int D) {
  return D > 256 && D % WCOLS == 0;
}

// Whether D is a head dim of the wgmma cuts and the register-sized decode.
__host__ __device__ constexpr bool wide_cut_head_dim(int D) {
  return wide_head_dim(D) && D <= WIDE_CUT_MAX_D;
}

// Whether D is above them: this header's kernels column-chunked.
__host__ __device__ constexpr bool chunked_head_dim(int D) {
  return wide_head_dim(D) && D > WIDE_CUT_MAX_D;
}

// Shared memory of the column-chunked kernels (fp32), in bytes from an
// aligned base, whatever the head dim: two stages of each streamed operand
// (64 rows x 128 bytes, padded), the update tile (64 rows x 128 columns),
// P of each warp, six vectors of 64 (segment ids, scales, lse, D) and the
// paged tile's stored-row offsets (geometry.py wide_chunk_smem_bytes).
struct WideLayout {
  static constexpr int KC = 32;          // columns of a streamed chunk
  static constexpr int SA = KC + 4;      // its row stride
  static constexpr int ST = WCOLS + 4;   // the update tile's row stride
  static constexpr int PS = WKEYS + 4;   // P's row stride
  static constexpr size_t CHUNK = size_t(WROWS) * SA * 4;
  static constexpr size_t A_OFF = 0;
  static constexpr size_t B_OFF = 2 * CHUNK;
  static constexpr size_t T_OFF = 4 * CHUNK;
  static constexpr size_t P_OFF = T_OFF + size_t(WKEYS) * ST * 4;
  static constexpr size_t VEC_OFF = P_OFF + size_t(4) * 16 * PS * 4;
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

// Rows [0, 64) x columns [c0, c0 + W) of a row source of fp32 into a shared
// tile of row stride S, 16 bytes a cp.async; `row(r)` is the row's first
// element, or null for a row of zeros.  `any` is a valid address the
// zero-filled copies name.
template <int W, int S, typename RowFn>
__device__ __forceinline__ void stage_async(float* dst, RowFn row, int c0, const void* any) {
  constexpr int EPP = 4;
  constexpr int PER_ROW = W / EPP;
  for (int i = threadIdx.x; i < WROWS * PER_ROW; i += WTHREADS) {
    const int r = i / PER_ROW, p = i % PER_ROW;
    const float* src = row(r);
    cp_async16(sm90::smem_u32(dst + r * S + p * EPP), src ? src + c0 + p * EPP : any,
               src ? 16 : 0);
  }
}

// The same from rows of any stored kind (paged.cuh PoolKind; fp8 V of the
// forward as kE4M3 / kE5M2), converted exactly to fp32, payloads unscaled:
// row r starts at element `off[r]` of `base` (-1: zeros), int4 rows read
// their high nibbles where `hi[r]`.  Synchronous: a __syncthreads() makes
// the tile visible.
template <int W, int S>
__device__ __forceinline__ void stage_convert(float* dst, const void* base, int kind,
                                              const long long* off, const int* hi, int c0) {
  const int eb = stored_bytes(kind);
  const int epp = 16 / eb;
  const int per_row = W / epp;
  const uint8_t* bytes = static_cast<const uint8_t*>(base);
  for (int i = threadIdx.x; i < WROWS * per_row; i += WTHREADS) {
    const int r = i / per_row, p = i % per_row;
    float* out = dst + r * S + p * epp;
    float f[16];
    if (off[r] < 0) {
#pragma unroll
      for (int e = 0; e < 16; ++e) f[e] = 0.f;
    } else {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          bytes + size_t(off[r] + c0 + p * epp) * eb);
      chunk_values(kind, raw, hi[r], f);
    }
    for (int e = 0; e < epp; ++e) out[e] = f[e];
  }
}

// Rows of fp32 times `scale` (the paged kernels pre-scale q in its own
// dtype, as the TPU kernel does); null rows give zeros.
template <int W, int S, typename RowFn>
__device__ __forceinline__ void stage_scaled(float* dst, RowFn row, int c0, float scale) {
  constexpr int EPP = 4;
  constexpr int PER_ROW = W / EPP;
  for (int i = threadIdx.x; i < WROWS * PER_ROW; i += WTHREADS) {
    const int r = i / PER_ROW, p = i % PER_ROW;
    const float* src = row(r);
    float* out = dst + r * S + p * EPP;
    if (src == nullptr) {
#pragma unroll
      for (int e = 0; e < EPP; ++e) out[e] = 0.f;
      continue;
    }
    const float4 v = *reinterpret_cast<const float4*>(src + c0 + p * EPP);
    out[0] = v.x * scale;
    out[1] = v.y * scale;
    out[2] = v.z * scale;
    out[3] = v.w * scale;
  }
}

// A warp's 16 x 64 block of scores from one staged chunk: rows
// [16 warp, 16 warp + 16) of sA against the 64 rows of sB, over the chunk's
// KC columns, added to s, in true fp32 on the CUDA cores.  Element (j, e)
// of s is row lane/4 (+8 for e >= 2) and column 8 j + 2 (lane % 4) + (e & 1)
// of the block (the mma.sync accumulator layout).
__device__ __forceinline__ void score_chunk(float (&s)[8][4], const float* sA, const float* sB,
                                            int warp, int lane) {
  using L = WideLayout;
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
}

// s = the warp's 16 x 64 block of A B^T over `cols` columns of the head dim,
// streamed in chunks through two stages, always in column order, so every
// CTA that recomputes a tile's scores gets the same bits: `load_a(dst, c0)`
// / `load_b(dst, c0)` stage a chunk (cp.async ones are committed here;
// synchronous ones are made visible by the barrier).  Every thread of the
// CTA calls it.
template <typename LoadA, typename LoadB>
__device__ __forceinline__ void scores(float (&s)[8][4], float* sA, float* sB, LoadA load_a,
                                       LoadB load_b, int cols, int warp, int lane) {
  using L = WideLayout;
  constexpr int STAGE = WROWS * L::SA;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  const int nc = cols / L::KC;  // the head dim's slices, every one summed
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

// o (the warp's 16 rows x 128 columns) += p (its 16 x 64 block) times the
// staged 64 x 128 tile, in fp32 through the warp's rows of sP (row stride
// PS).
__device__ __forceinline__ void update_product(float (&o)[16][4], const float (&p)[8][4],
                                               const float* sT, float* sPw, int lane) {
  using L = WideLayout;
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
}

// A pair of fp32 values stored at `p` (two consecutive elements).
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
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

// The column-chunked forward (PAGED false) and paged verify (PAGED true),
// one CTA per (64-row tile, output column chunk [and key split], batch x
// head): fp32 ("wide_fp32") at every wide head dim.  The forward's rows
// are one q head's; verify's are the T x G (token, q head) rows of a kv
// head, row r = t * G + g, as the TPU kernel folds them.
template <bool PAGED>
__global__ void __launch_bounds__(WTHREADS)
wide_fwd_chunk_kernel(const WideArgs a) {
  using L = WideLayout;
  extern __shared__ __align__(128) unsigned char wsmem[];
  float* sA = reinterpret_cast<float*>(wsmem + L::A_OFF);
  float* sB = reinterpret_cast<float*>(wsmem + L::B_OFF);
  float* sT = reinterpret_cast<float*>(wsmem + L::T_OFF);
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

  const float* qT = static_cast<const float*>(a.q);
  const float* kT = static_cast<const float*>(a.k);
  const float* vT = static_cast<const float*>(a.v);
  auto q_row = [&](int r) -> const float* {
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
    auto k_row = [&](int r) -> const float* {
      return n0 + r < a.Nkv ? kT + kv_base + size_t(n0 + r) * D : nullptr;
    };
    if (!PAGED && !v8) {
      stage_async<WCOLS, L::ST>(
          sT, [&](int r) { return n0 + r < a.Nkv ? vT + kv_base + size_t(n0 + r) * D : nullptr; },
          c0, a.v);
    }
    float s[8][4];
    if constexpr (PAGED) {
      scores(s, sA, sB,
             [&](float* dst, int c) { stage_scaled<L::KC, L::SA>(dst, q_row, c, a.sm_scale); },
             [&](float* dst, int c) {
               stage_convert<L::KC, L::SA>(dst, a.k, a.kind, sOff, sHi, c);
             },
             score_cols, warp, lane);
      stage_convert<WCOLS, L::ST>(sT, a.v, a.kind, sOff, sHi, c0);
    } else {
      scores(s, sA, sB,
             [&](float* dst, int c) { stage_async<L::KC, L::SA>(dst, q_row, c, a.q); },
             [&](float* dst, int c) { stage_async<L::KC, L::SA>(dst, k_row, c, a.k); },
             score_cols, warp, lane);
      if (v8) stage_convert<WCOLS, L::ST>(sT, a.v, a.v_kind == kVE4M3 ? kE4M3 : kE5M2,
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
      float* po = static_cast<float*>(a.o) + out_row * D + cb;
#pragma unroll
      for (int j = 0; j < 16; ++j) store_pair(po + 8 * j, o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
      if (!PAGED && cc == 0 && lane % 4 == 0)
        a.lse[out_row] = l > 0.f ? m_i[i] + logf(l) : kMaskValue;
    }
  }
}

// ---------------------------------------------------------------------------
// The 16-bit forward and paged verify on wgmma ("wide_wgmma")
// ---------------------------------------------------------------------------

namespace sm90 {

constexpr int WBN = 32;  // keys a K / V tile
// Registers a thread where a CTA has two owners (384 threads launched at
// LAUNCH_REGS = 168): the producer keeps 40, converting one 16-byte chunk
// at a time; the owners take the rest, 232: with fewer the owners of the
// d 512 forward spill (wide_breakdown_torch.py builds the 72 / 216 split).
// A CTA of one owner (256 threads) launches with enough.
constexpr int WG_PRODUCER_REGS = 40, WG_CONSUMER_REGS = 232;
static_assert(128 * WG_PRODUCER_REGS + 256 * WG_CONSUMER_REGS <= THREADS * LAUNCH_REGS,
              "the register split exceeds the CTA's registers");

// How head dim D is cut: a cluster of nc CTAs, nw owners (consumer
// warpgroups) a CTA, c 64-column chunks an owner (geometry.py wide_cut).
struct WideCut {
  int nc, nw, c;
};
__host__ __device__ constexpr WideCut wide_cut(int D) {
  return D == 384   ? WideCut{1, 2, 3}
         : D == 512 ? WideCut{1, 2, 4}
         : D == 640 ? WideCut{5, 1, 2}
         : D == 768 ? WideCut{2, 2, 3}
         : D == 896 ? WideCut{7, 1, 2}
                    : WideCut{2, 2, 4};
}

// Shared memory of one CTA of NW owners of C chunks, in bytes from a
// 1024-byte aligned base: Q (64 rows x CW columns), STAGES stages of K and
// of V (32 keys x CW), the owners' partial scores (64 x 32 fp32 each), then
// with segment ids each K tile's ids or in verify each stage's K and V
// scales, then the barriers (a Q barrier per owner; per stage K full, V
// full, K empty and V empty; the partials' full and empty), and 1024 bytes
// of alignment.  Every tile is [CW / 64 chunks][rows][128 bytes], swizzled.
template <int NW, int C>
struct WgLayout {
  static constexpr int CW = 64 * NW * C;                  // the CTA's columns
  static constexpr uint32_t Q_BYTES = 64 * CW * 2;
  static constexpr uint32_t KV_BYTES = WBN * CW * 2;     // one K or V tile
  static constexpr uint32_t X_BYTES = NW * 64 * WBN * 4;
  __host__ __device__ static constexpr uint32_t extra(int stages, bool seg, bool paged) {
    return paged ? stages * 2 * WBN * 4 : seg ? stages * WBN * 4 : 0;
  }
  __host__ __device__ static constexpr size_t bytes(int stages, bool seg, bool paged) {
    return size_t(Q_BYTES) + 2 * size_t(stages) * KV_BYTES + X_BYTES +
           extra(stages, seg, paged) + 8 * (NW + 4 * stages + 2) + 1024;
  }
  // as many stages as fit, at most 4 (the paged scales are the larger extra)
  __host__ __device__ static constexpr int fit() {
    int s = 4;
    while (s > 2 && bytes(s, false, true) > 232448) --s;
    return s;
  }
  static constexpr int STAGES = fit();
  static_assert(bytes(STAGES, false, true) <= 232448 && bytes(STAGES, true, false) <= 232448,
                "a CTA has 227 KB of shared memory");
  static constexpr uint32_t K_OFF = Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t X_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t E_OFF = X_OFF + X_BYTES;  // segment ids or scales
};

// Byte offset of 16-byte unit u of row r of 64-column chunk c in a swizzled
// tile of `rows` rows.
__device__ __forceinline__ uint32_t swz(int rows, int c, int r, int u) {
  return c * (rows * 128) + r * 128 + ((u ^ (r & 7)) * 16);
}

// One stored 16-byte chunk c16 (16 one-byte elements of paged.cuh `kind`:
// int8, int4 nibbles, e4m3, e5m2) of row r of a K or V tile, converted
// exactly and unscaled to T into the swizzled stage.
template <typename T>
__device__ __forceinline__ void store_converted(unsigned char* tile, int r, int c16,
                                                const uint4& raw, int hi, int kind) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t p[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float f[4];
    word_values(kind, w[j], hi, f);
    p[2 * j] = Mma<T>::pack(f[0], f[1]);
    p[2 * j + 1] = Mma<T>::pack(f[2], f[3]);
  }
  const int c = c16 / 4, u = 2 * (c16 % 4);
  *reinterpret_cast<uint4*>(tile + swz(WBN, c, r, u)) = make_uint4(p[0], p[1], p[2], p[3]);
  *reinterpret_cast<uint4*>(tile + swz(WBN, c, r, u + 1)) = make_uint4(p[4], p[5], p[6], p[7]);
}

// O += P V over `C` 64-column chunks of V (MN-major, chunks `lbo` bytes
// apart): n128 products, and an n64 one for an odd chunk.
template <int C, typename T>
__device__ __forceinline__ void pv_product(float (&acc)[32 * C], const uint32_t (&a)[4],
                                           uint32_t v, uint32_t lbo) {
#pragma unroll
  for (int h = 0; h < C / 2; ++h)
    WgmmaRS<128, T>::run(*reinterpret_cast<float(*)[64]>(acc + 64 * h), a,
                         smem_desc(v + 2 * h * lbo, lbo, 1024));
  if constexpr (C % 2 == 1)
    WgmmaRS<64, T>::run(*reinterpret_cast<float(*)[32]>(acc + 64 * (C / 2)), a,
                        smem_desc(v + (C - 1) * lbo, lbo, 1024));
}

// Calls f with std::true_type / std::false_type for each of three flags, so
// that a tile's element loop is compiled without what it does not need.
template <typename F>
__device__ __forceinline__ void with_flags(bool x, bool y, bool z, F&& f) {
  const std::true_type Y{};
  const std::false_type N{};
  if (x) {
    if (y) { if (z) f(Y, Y, Y); else f(Y, Y, N); }
    else { if (z) f(Y, N, Y); else f(Y, N, N); }
  } else {
    if (y) { if (z) f(N, Y, Y); else f(N, Y, N); }
    else { if (z) f(N, N, Y); else f(N, N, N); }
  }
}

// Thread-block clusters: this CTA's rank, a shared address in a peer's
// window, the cluster-wide barrier, and mbarrier operations across CTAs.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return int(r);
}
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// `bytes` of this CTA's shared memory at `src` copied to `dst` in a CTA of
// the cluster by the bulk-copy engine, completing a transaction on that
// CTA's barrier `bar` (dst and bar: mapa addresses).
__device__ __forceinline__ void bulk_copy_peer(uint32_t dst, uint32_t src, uint32_t bytes,
                                               uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ float4 ld_peer_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// The forward (PAGED false) and paged verify (PAGED true) in T = bf16 /
// fp16: one cluster of NC CTAs per (64-row tile [and key split], batch x
// head) of the forward, (key split x 64-row block, kv head, batch) of
// verify, whose rows are the T x G (token, q head) rows of a kv head, row r
// = t * G + g.  CTA `rank` of a cluster owns columns [rank CW, + CW), owner
// w of it columns [w 64 C, + 64 C) of those; the owner's place in the sum
// order is rank NW + w.  tma (verify): the pools are read by TMA boxes of
// tm_k / tm_v where a tile lies in one page.
template <typename T, bool PAGED, int NC, int NW, int C>
__global__ void __launch_bounds__(128 * (NW + 1), 1)
wide_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const WideArgs a, int tma) {
  using L = WgLayout<NW, C>;
  constexpr int BN = WBN, STAGES = L::STAGES, CW = L::CW, OC = 64 * C;
  constexpr int OWNERS = NC * NW;
  constexpr int NS = BN / 8;  // score n-tiles of 8 keys per warp
  constexpr int NO = OC / 8;  // output n-tiles per warp (the owner's columns)

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle atom
  unsigned char* const smem = smem_raw + (base - smem_u32(smem_raw));  // generic view
  const uint32_t sQ = base, sK = base + L::K_OFF, sV = base + L::V_OFF;

  const int D = a.D, G = a.Hq / a.Hkv;
  const int rank = NC > 1 ? cluster_rank() : 0;
  const int c_lo = rank * CW;       // the CTA's first column
  const int cta = blockIdx.x / NC;  // the cluster's place along x
  const bool seg = !PAGED && a.md.q_seg != nullptr;
  const bool v8 = !PAGED && a.v_kind != kVSame;

  int b, h = 0, kvh, m0, rows, n_tiles, k_first, split = 0, len = 0, alen = 0, key_hi = 0;
  if constexpr (PAGED) {
    const int row_blocks = (a.T * G + 63) / 64;
    split = cta / row_blocks;
    m0 = (cta % row_blocks) * 64;
    kvh = blockIdx.y;
    b = blockIdx.z;
    rows = a.T * G;
    len = a.lengths[b];
    const int max_len = a.pages_per_seq * a.page_size;
    alen = min(max(len, 0), max_len);
    const int t_hi = min(a.T - 1, (min(m0 + 64, rows) - 1) / G);
    k_first = split * a.pages_per_split * a.page_size;
    key_hi = min(min(k_first + a.pages_per_split * a.page_size, max_len),
                 max(0, len - a.T + 1 + t_hi));
    n_tiles = key_hi > k_first ? (key_hi - k_first + BN - 1) / BN : 0;
  } else {
    b = blockIdx.y / a.Hq;
    h = blockIdx.y % a.Hq;
    kvh = h / G;
    m0 = (a.causal ? int(gridDim.x) / NC - 1 - cta : cta) * 64;  // heaviest causal tiles first
    rows = a.Nq;
    const TileRange tr = kv_tiles<64, BN>(m0, a.Nq, a.Nkv, a.causal, a.window);
    k_first = tr.lo * BN;
    n_tiles = max(tr.hi - tr.lo, 0);
  }
  auto out_row = [&](int r) -> size_t {  // row r of the CTA's rows in O (and lse)
    if constexpr (PAGED) {
      return (size_t(b) * a.Hq + kvh * G + r % G) * a.T + r / G;
    } else {
      return (size_t(b) * a.Hq + h) * a.Nq + r;
    }
  };
  const size_t all_rows = size_t(a.B) * a.Hq * a.T;
  const bool split_out = PAGED && a.splits > 1;

  if (n_tiles == 0) {  // the rows see no key (of this split): every CTA of the cluster
    for (int idx = threadIdx.x; idx < 64 * (CW / 8); idx += blockDim.x) {
      const int r = m0 + idx / (CW / 8);
      if (r >= rows) continue;
      if (!split_out)
        *reinterpret_cast<uint4*>(static_cast<T*>(a.o) + out_row(r) * D + c_lo +
                                  (idx % (CW / 8)) * 8) = make_uint4(0, 0, 0, 0);
      if (rank == 0 && idx % (CW / 8) == 0) {
        if (split_out) a.part_lse[split * all_rows + out_row(r)] = -INFINITY;
        else if (!PAGED) a.lse[out_row(r)] = kMaskValue;
      }
    }
    return;
  }

  const uint32_t bars = base + L::E_OFF + L::extra(STAGES, seg, PAGED);
  auto bar_q = [&](int w) { return bars + 8u * w; };
  auto full_k = [&](int s) { return bars + 8u * (NW + s); };
  auto full_v = [&](int s) { return bars + 8u * (NW + STAGES + s); };
  auto empty_k = [&](int s) { return bars + 8u * (NW + 2 * STAGES + s); };
  auto empty_v = [&](int s) { return bars + 8u * (NW + 3 * STAGES + s); };
  const uint32_t x_full = bars + 8u * (NW + 4 * STAGES), x_empty = x_full + 8u;
  auto tile_ids = [&](int s) {  // the segment ids of the K tile in stage s
    return reinterpret_cast<int*>(smem + L::E_OFF) + s * BN;
  };
  auto scales = [&](int s) {  // verify: stage s's K scales, then its V scales
    return reinterpret_cast<float*>(smem + L::E_OFF) + s * 2 * BN;
  };

  if (threadIdx.x == 0) {
    for (int w = 0; w < NW; ++w) mbar_init(bar_q(w), PAGED ? 128 : 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), PAGED ? 128 : 1);
      mbar_init(full_v(s), PAGED ? 128 : v8 ? 4 : 1);  // converted fp8 V: a producer warp each
      mbar_init(empty_k(s), 4 * NW);                   // one arrival per owner warp
      mbar_init(empty_v(s), 4 * NW);
    }
    mbar_init(x_full, 4 * OWNERS);  // one arrival per owner warp of the cluster
    mbar_init(x_empty, 4 * OWNERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (PAGED && !is_quantized(a.kind)) {  // value pools: every scale 1
    for (int i = threadIdx.x; i < STAGES * 2 * BN; i += blockDim.x) scales(0)[i] = 1.f;
  }
  __syncthreads();
  if constexpr (NC > 1) cluster_sync();  // the peers' barriers exist before any arrival

  if (threadIdx.x < 128) {
    // Producer warpgroup.
    if constexpr (NW > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_PRODUCER_REGS));
    const int tid = threadIdx.x;
    constexpr int CPR = CW / 16;         // 16-byte stored chunks of a 1-byte row
    constexpr int PER = BN * CPR / 128;  // of a tile, a producer thread's
    if constexpr (!PAGED) {
      // Thread 0 issues every TMA copy; with segment ids warp 0 writes each K
      // tile's ids, with fp8 V every warp converts V.  The rest have no work.
      const int producers = v8 ? 128 : seg ? 32 : 1;
      if (tid < producers) {
        const bool leader = tid == 0;
        const int bh = b * a.Hq + h, kv_bh = b * a.Hkv + kvh;
        if (leader) {
          mbar_expect_tx(bar_q(0), L::Q_BYTES);
#pragma unroll
          for (int c = 0; c < CW / 64; ++c)
            tma_load_3d(sQ + c * (64 * 128), &tm_q, bar_q(0), c_lo + 64 * c, m0, bh);
        }
        const uint8_t* v_bytes = static_cast<const uint8_t*>(a.v);
        const int v_fmt = a.v_kind == kVE4M3 ? kE4M3 : kE5M2;
        for (int i = 0; i < n_tiles; ++i) {
          const int s = i % STAGES, n0 = k_first + i * BN;
          const uint32_t parity = ((i / STAGES) & 1) ^ 1;  // passes at once on the first lap
          mbar_wait(empty_k(s), parity);
          if (seg && tid < 32) {
            for (int x = tid; x < BN; x += 32) tile_ids(s)[x] = seg_id(a.md.kv_seg, b, a.Nkv, n0 + x);
            __syncwarp();  // the ids are written before K's full barrier completes
          }
          if (leader) {
            mbar_expect_tx(full_k(s), L::KV_BYTES);
#pragma unroll
            for (int c = 0; c < CW / 64; ++c)
              tma_load_3d(sK + s * L::KV_BYTES + c * (BN * 128), &tm_k, full_k(s), c_lo + 64 * c,
                          n0, kv_bh);
          }
          if (v8) {
            for (int part = 0; part < PER; ++part) {
              const int idx = tid + part * 128, r = idx / CPR, c16 = idx % CPR;
              const uint4 raw =
                  n0 + r < a.Nkv
                      ? *reinterpret_cast<const uint4*>(
                            v_bytes + (size_t(kv_bh) * a.Nkv + n0 + r) * D + c_lo + c16 * 16)
                      : make_uint4(0, 0, 0, 0);
              if (part == 0) mbar_wait(empty_v(s), parity);  // the first load in flight
              store_converted<T>(smem + L::V_OFF + s * L::KV_BYTES, r, c16, raw, 0, v_fmt);
            }
            fence_proxy_async();  // the V stage is read by wgmma
            __syncwarp();
            if (tid % 32 == 0) mbar_arrive(full_v(s));
          } else if (leader) {
            mbar_wait(empty_v(s), parity);
            mbar_expect_tx(full_v(s), L::KV_BYTES);
#pragma unroll
            for (int c = 0; c < CW / 64; ++c)
              tma_load_3d(sV + s * L::KV_BYTES + c * (BN * 128), &tm_v, full_v(s), c_lo + 64 * c,
                          n0, kv_bh);
          }
        }
      }
    } else {
      // Every producer thread: each tile's rows through the page table.
      const int ps = a.page_size;
      const int* table = a.page_table + size_t(b) * a.pages_per_seq;
      const bool quant = is_quantized(a.kind);
      const int data_end = min(k_first + a.pages_per_split * ps, alen);  // keys whose pages hold data
      const unsigned char* kb = static_cast<const unsigned char*>(a.k);
      const unsigned char* vb = static_cast<const unsigned char*>(a.v);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, n0 = k_first + i * BN;
        const uint32_t parity = ((i / STAGES) & 1) ^ 1;
        const uint32_t dk = sK + s * L::KV_BYTES, dv = sV + s * L::KV_BYTES;
        if (!quant) {
          mbar_wait(empty_k(s), parity);
          mbar_wait(empty_v(s), parity);
          if (tma && n0 + BN <= data_end) {  // a whole tile inside one page
            if (tid == 0) {
              const int row = (kvh * a.P + table[n0 / ps]) * ps + n0 % ps;
              mbar_expect_tx(full_k(s), L::KV_BYTES);
              mbar_expect_tx(full_v(s), L::KV_BYTES);
#pragma unroll
              for (int c = 0; c < CW / 64; ++c) {
                tma_load_2d(dk + c * (BN * 128), &tm_k, full_k(s), c_lo + 64 * c, row);
                tma_load_2d(dv + c * (BN * 128), &tm_v, full_v(s), c_lo + 64 * c, row);
              }
            } else {
              mbar_arrive(full_k(s));
              mbar_arrive(full_v(s));
            }
          } else {  // each row at its own address; zeros past the visible keys
            const T* kp = static_cast<const T*>(a.k);
            const T* vp = static_cast<const T*>(a.v);
            for (int idx = tid; idx < BN * (CW / 8); idx += 128) {
              const int r = idx / (CW / 8), u16 = idx % (CW / 8), key = n0 + r;
              const bool live = key < key_hi;
              const size_t off =
                  live ? (size_t(kvh * a.P + table[key / ps]) * ps + key % ps) * D + c_lo + u16 * 8
                       : 0;
              const uint32_t at = swz(BN, u16 / 8, r, u16 % 8);
              cp_async16(dk + at, kp + off, live ? 16 : 0);
              cp_async16(dv + at, vp + off, live ? 16 : 0);
            }
            cp_async_arrive(full_k(s));
            cp_async_arrive(full_v(s));
          }
        } else {
          // Quantized pools: each stored chunk converted once the stage is
          // free (the first loads in flight meanwhile); zeros past the
          // visible keys.
          float ks = 0.f, vs = 0.f;
          if (tid < BN && n0 + tid < key_hi) {
            const int key = n0 + tid;
            const size_t si = scale_index(kvh, table[key / ps], key % ps, a.P, ps);
            ks = a.k_scales[si];
            vs = a.v_scales[si];
          }
          for (int part = 0; part < PER; ++part) {
            const int idx = tid + part * 128, r = idx / CPR, c16 = idx % CPR, key = n0 + r;
            uint4 kr = make_uint4(0, 0, 0, 0), vr = kr;
            int hi = 0;
            if (key < key_hi) {
              const TokenAddr ta = token_addr(a.kind, kvh, table[key / ps], key % ps, a.P, ps, D);
              kr = *reinterpret_cast<const uint4*>(kb + ta.row + c_lo + c16 * 16);
              vr = *reinterpret_cast<const uint4*>(vb + ta.row + c_lo + c16 * 16);
              hi = ta.hi;
            }
            if (part == 0) {
              mbar_wait(empty_k(s), parity);
              mbar_wait(empty_v(s), parity);
            }
            store_converted<T>(smem + L::K_OFF + s * L::KV_BYTES, r, c16, kr, hi, a.kind);
            store_converted<T>(smem + L::V_OFF + s * L::KV_BYTES, r, c16, vr, hi, a.kind);
          }
          if (tid < BN) {
            scales(s)[tid] = ks;
            scales(s)[BN + tid] = vs;
          }
          fence_proxy_async();  // the stage is read by wgmma
          mbar_arrive(full_k(s));
          mbar_arrive(full_v(s));
        }
      }
    }
  } else {
    // Owners: consumer warpgroup w of the CTA, 64 rows x its OC columns.
    if constexpr (NW > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONSUMER_REGS));
    const int w = threadIdx.x / 128 - 1;
    const int me = rank * NW + w;  // the owner's place in the sum order
    const int wt = threadIdx.x % 128, warp = wt / 32, lane = wt % 32;
    const int g = lane / 4, t = lane % 4;  // accumulator row group / column pair
    const int row0 = m0 + 16 * warp + g;   // this thread's rows: row0, row0 + 8
    const uint32_t q_own = sQ + w * C * (64 * 128);  // the owner's chunks of Q

    if constexpr (PAGED) {
      // The owner's 64 x OC block of q, pre-scaled and rounded to T (the TPU
      // kernel scales q in its own dtype), padding rows zero.
      const T* q = static_cast<const T*>(a.q);
#pragma unroll 4
      for (int idx = wt; idx < 64 * (OC / 8); idx += 128) {
        const int r = idx / (OC / 8), u16 = idx % (OC / 8);
        uint4 raw = make_uint4(0, 0, 0, 0);
        if (m0 + r < rows)
          raw = *reinterpret_cast<const uint4*>(q + out_row(m0 + r) * D + c_lo + w * OC + u16 * 8);
        const T* e = reinterpret_cast<const T*>(&raw);
        uint32_t p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[i] = Mma<T>::pack(to_float(e[2 * i]) * a.sm_scale, to_float(e[2 * i + 1]) * a.sm_scale);
        *reinterpret_cast<uint4*>(smem + swz(64, w * C + u16 / 8, r, u16 % 8)) =
            make_uint4(p[0], p[1], p[2], p[3]);
      }
      fence_proxy_async();  // Q is read by wgmma
      mbar_arrive(bar_q(w));
    }

    // Per row: forward segment ids and ALiBi slope; verify the key limit,
    // the ALiBi position and slope.
    int qseg[2] = {0, 0}, lim[2] = {0, 0}, qpos[2] = {0, 0};
    float slope[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if constexpr (PAGED) {
        const int tt = row / G;
        lim[r] = min(len - a.T + 1 + tt, key_hi);  // the row's horizon, within the split
        qpos[r] = alen - a.T + tt;
        if (a.md.slopes != nullptr && row < rows) slope[r] = a.md.slopes[kvh * G + row % G];
      } else {
        if (seg) qseg[r] = seg_id(a.md.q_seg, b, a.Nq, row);
        if (a.md.slopes != nullptr) slope[r] = a.md.slopes[h] * kLog2e;
      }
    }
    // verify: keys below `open` are visible to every row of the CTA (its
    // first row's horizon is the nearest) and lie in the split
    const int open = PAGED ? min(len - a.T + 1 + m0 / G, key_hi) : 0;
    const uint32_t stream = !PAGED && a.md.rate > 0.f ? dropout_stream(a.md.seed, b, h) : 0u;
    const int q_off = a.Nkv - a.Nq;
    const float scale_log2 = a.sm_scale * kLog2e;

    float s[BN / 2], acc[OC / 2];
    uint32_t pa[BN / 16][4];  // P as the A fragments of P V, 16 keys a k-step
#pragma unroll
    for (int i = 0; i < OC / 2; ++i) acc[i] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};  // running max, base-2 units
    float l_r[2] = {0.f, 0.f};              // this thread's share of the row sum
    float alpha[2] = {1.f, 1.f};            // O's rescale before the next P V

    // The owner's partial S = Q K^T over its OC columns of the tile in
    // stage st, issued (not awaited).
    auto issue_s = [&](int st) {
      const uint32_t k_own = sK + st * L::KV_BYTES + w * C * (BN * 128);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < OC / 16; ++ks) {
        const uint32_t in_chunk = (ks % 4) * 32;
        WgmmaSS<BN, T>::run(s, smem_desc(q_own + (ks / 4) * (64 * 128) + in_chunk, 16, 1024),
                            smem_desc(k_own + (ks / 4) * (BN * 128) + in_chunk, 16, 1024),
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
    // O[:, the owner's columns] += P V of the tile in stage st, issued.
    auto issue_pv = [&](int st) {
      const uint32_t v_own = sV + st * L::KV_BYTES + w * C * (BN * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) pv_product<C, T>(acc, pa[kk], v_own + kk * 2048, BN * 128);
      wgmma_commit();
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    // The exchange: each thread's 16 partial scores as float4 j of owner p
    // at X_OFF + ((p % NW) * NS + j) * 2048 + 16 * wt of rank p / NW.
    auto x_read = [&](int p, int j) -> float4 {
      const uint32_t off = L::X_OFF + (((p % NW) * NS + j) * 128 + wt) * 16;
      if constexpr (NC == 1) {
        return *reinterpret_cast<const float4*>(smem + off);
      } else {
        return ld_peer_f4(peer_addr(base + off, p / NW));
      }
    };
    auto x_arrive = [&](uint32_t bar) {  // on the barrier of every CTA of the cluster
      __syncwarp();
      if (lane == 0) {
        if constexpr (NC == 1) {
          mbar_arrive(bar);
        } else {
          for (int c = 0; c < NC; ++c) mbar_arrive_peer(peer_addr(bar, c));
        }
      }
    };
    auto x_wait = [&](uint32_t bar, uint32_t parity) {
      if constexpr (NC == 1) {
        mbar_wait(bar, parity);
      } else {
        mbar_wait_cluster(bar, parity);
      }
    };
    // S of tile i: the owners' partials summed in owner order, so every
    // owner gets the same bits.
    auto exchange = [&](int i) {
      if (i > 0) x_wait(x_empty, (i - 1) & 1);  // every owner has read tile i - 1's
      float4* own = reinterpret_cast<float4*>(smem + L::X_OFF) + w * NS * 128 + wt;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        own[j * 128] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
      x_arrive(x_full);
      x_wait(x_full, i & 1);
#pragma unroll
      for (int p = 0; p < OWNERS; ++p) {  // every owner's partial, in owner order
        const int src = p;  // the owner whose partial is added
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float4 x = x_read(src, j);
          if (p == 0) {
            s[4 * j] = x.x, s[4 * j + 1] = x.y, s[4 * j + 2] = x.z, s[4 * j + 3] = x.w;
          } else {
            s[4 * j] += x.x, s[4 * j + 1] += x.y, s[4 * j + 2] += x.z, s[4 * j + 3] += x.w;
          }
        }
      }
      x_arrive(x_empty);
    };

    // The forward's scale, softcap, ALiBi bias and mask of the scores of keys
    // [n0, n0 + BN) into base-2 units (attn_fwd_sm90.cuh's arithmetic); the
    // bias distance q_pos - col is an exact integer in fp32.
    auto scores_fwd = [&](int n0, const int* ids, auto cap, auto masked, auto alibi) {
      const float dist0[2] = {float(row0 + q_off - n0 - 2 * t),
                              float(row0 + 8 + q_off - n0 - 2 * t)};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dist = dist0[e >> 1] - float(j * 8 + (e & 1));
          float x;
          if constexpr (decltype(cap)::value) {
            x = s[4 * j + e] * a.sm_scale;
            x = a.softcap * tanhf(x / a.softcap) * kLog2e;
          } else {
            x = s[4 * j + e] * scale_log2;
          }
          if constexpr (decltype(alibi)::value) x -= slope[0] * dist;
          if constexpr (decltype(masked)::value) {
            const int row = row0 + (e >= 2 ? 8 : 0);
            const int col = n0 + j * 8 + 2 * t + (e & 1);
            if (!visible(row, col, a.Nq, a.Nkv, a.causal, a.window) ||
                (seg && qseg[e >> 1] != ids[col - n0]))
              x = -INFINITY;
          }
          s[4 * j + e] = x;
        }
      }
    };
    // Verify's: the K scale, softcap, ALiBi bias -m (q_pos - pos) and the
    // row's horizon (paged_verify.cuh's arithmetic), into base-2 units.
    auto scores_paged = [&](int n0, const float* ksc, auto cap, auto masked, auto alibi) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1), r = e >> 1;
          float x = s[4 * j + e] * ksc[c];
          if constexpr (decltype(cap)::value) x = a.softcap * tanhf(x * (1.f / a.softcap));
          if constexpr (decltype(alibi)::value) x -= slope[r] * float(qpos[r] - (n0 + c));
          x *= kLog2e;
          if constexpr (decltype(masked)::value) {
            if (n0 + c >= lim[r]) x = -INFINITY;
          }
          s[4 * j + e] = x;
        }
      }
    };
    // Dropout of P (common.cuh dropout_factor, bit for bit: the keep test
    // u * 2^-24 >= rate on the 24-bit u is the integer test u >= ceil(rate
    // * 2^24)).
    const uint32_t keep_min = a.md.rate > 0.f ? uint32_t(ceilf(a.md.rate * 16777216.f)) : 0u;
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
            p = (bits & 0xFFFFFFu) >= keep_min ? p * a.md.keep_scale : 0.f;
          }
        }
      }
    };
    // The online softmax of tile (n0, stage st): new running max, alpha, P
    // in place of S (dropped after the undropped row sum).
    auto softmax = [&](int n0, int st) {
      const bool masked = PAGED ? n0 + BN > open
                                : seg || !tile_unmasked<64, BN>(m0, n0, a.Nq, a.Nkv, a.causal,
                                                               a.window);
      with_flags(a.softcap > 0.f, masked, a.md.slopes != nullptr,
                 [&](auto cap, auto msk, auto alibi) {
                   if constexpr (PAGED) {
                     scores_paged(n0, scales(st), cap, msk, alibi);
                   } else {
                     scores_fwd(n0, tile_ids(st), cap, msk, alibi);
                   }
                 });
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
            sum += s[4 * j + e];  // the row sum is undropped and unscaled
          }
        }
        l_r[r] = l_r[r] * alpha[r] + sum;
      }
      if (!PAGED && a.md.rate > 0.f) drop_p(n0);
    };
    // P (in verify times the V scale) rounded to T, as P V's A fragments.
    auto pack_p = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float p0 = s[8 * kk + 2 * x], p1 = s[8 * kk + 2 * x + 1];
          if constexpr (PAGED) {
            const float* vsc = scales(st) + BN + 8 * (2 * kk + x / 2) + 2 * t;
            p0 *= vsc[0];
            p1 *= vsc[1];
          }
          pa[kk][x] = Mma<T>::pack(p0, p1);
        }
      }
    };

    // Tile i: the partial S(i) is issued beside P V of tile i - 1; the
    // exchange and the softmax of S(i) run while that P V finishes.  K(i) is
    // released once S(i) is done (with segment ids, once its ids are read
    // too), V(i - 1) once its P V is.
    mbar_wait(bar_q(PAGED ? w : 0), 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % STAGES, prev = (i + STAGES - 1) % STAGES;
      const int n0 = k_first + i * BN;
      if (i > 0) rescale_o();
      mbar_wait(full_k(st), (i / STAGES) & 1);
      if constexpr (PAGED) fence_proxy_async();  // rows written by cp.async, read by wgmma
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
      if (!seg) release(empty_k(st));
      exchange(i);
      softmax(n0, st);
      if (seg) release(empty_k(st));
      if (i > 0) {
        wgmma_wait_all();
        fence_regs(acc);
        release(empty_v(prev));
      }
      pack_p(st);
    }
    // n_tiles > 0 here (an empty CTA returned above); without the guard
    // ptxas serializes every wgmma of the kernel (C7514).
    if (n_tiles > 0) {
      const int last = (n_tiles - 1) % STAGES;
      rescale_o();
      mbar_wait(full_v(last), ((n_tiles - 1) / STAGES) & 1);
      issue_pv(last);
      wgmma_wait_all();
      fence_regs(acc);
      release(empty_v(last));
    }

    // O / l for the owner's columns; lse (verify with splits: the partial's)
    // from the first owner.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_r[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row0 + 8 * r;
      if (row >= rows) continue;
      const size_t orow = out_row(row);
      const float inv = l > 0.f ? 1.f / l : 0.f;
      const int col0 = c_lo + w * OC + 2 * t;
      if (split_out) {
        float* dst = a.part_o + (split * all_rows + orow) * D + col0;
#pragma unroll
        for (int j = 0; j < NO; ++j)
          *reinterpret_cast<float2*>(dst + j * 8) =
              make_float2(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
        if (me == 0 && t == 0)
          a.part_lse[split * all_rows + orow] = l > 0.f ? (m_r[r] + log2f(l)) * kLn2 : -INFINITY;
      } else {
        T* dst = static_cast<T*>(a.o) + orow * D + col0;
#pragma unroll
        for (int j = 0; j < NO; ++j)
          *reinterpret_cast<uint32_t*>(dst + j * 8) =
              Mma<T>::pack(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
        if (!PAGED && me == 0 && t == 0)
          a.lse[orow] = l > 0.f ? (m_r[r] + log2f(l)) * kLn2 : kMaskValue;
      }
    }
  }
  // No CTA leaves while a peer may still read its partials or arrive on its
  // barriers.
  if constexpr (NC > 1) cluster_sync();
}

}  // namespace sm90

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

// The column-chunked dK/dV sweep (fp32, "wide_fp32"): one CTA per (64-key
// tile, output column chunk and pass, batch x kv head).  Pass 0 keeps dV +=
// (P o M)^T dO, pass 1 dK += dS^T Q (times sm_scale at the end), each for
// its 128 columns, over the q heads of the GQA group and, in order, the q
// tiles that see the keys.  The warp's rows are keys: S^T = K Q^T and dP^T
// = V dO^T.
__device__ __forceinline__ void wide_bwd_dkv_chunk(const WideBwdArgs a) {
  using L = WideLayout;
  extern __shared__ __align__(128) unsigned char wsmem[];
  float* sA = reinterpret_cast<float*>(wsmem + L::A_OFF);
  float* sB = reinterpret_cast<float*>(wsmem + L::B_OFF);
  float* sT = reinterpret_cast<float*>(wsmem + L::T_OFF);
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

  const float* qT = static_cast<const float*>(a.q);
  const float* kT = static_cast<const float*>(a.k);
  const float* vT = static_cast<const float*>(a.v);
  const float* dT = static_cast<const float*>(a.dout);
  const size_t kv_base = (size_t(b) * a.Hkv + kvh) * size_t(a.Nkv) * D;
  auto k_row = [&](int r) -> const float* {
    return n0 + r < a.Nkv ? kT + kv_base + size_t(n0 + r) * D : nullptr;
  };
  auto v_row = [&](int r) -> const float* {
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
      auto q_row = [&](int r) -> const float* {
        return m0 + r < a.Nq ? qT + (q_base + m0 + r) * D : nullptr;
      };
      auto do_row = [&](int r) -> const float* {
        return m0 + r < a.Nq ? dT + (q_base + m0 + r) * D : nullptr;
      };
      if (pass_dk) {
        stage_async<WCOLS, L::ST>(sT, q_row, c0, a.q);
      } else {
        stage_async<WCOLS, L::ST>(sT, do_row, c0, a.q);
      }
      float s[8][4], dp[8][4];
      scores(s, sA, sB,
             [&](float* dst, int c) { stage_async<L::KC, L::SA>(dst, k_row, c, a.k); },
             [&](float* dst, int c) { stage_async<L::KC, L::SA>(dst, q_row, c, a.q); }, D, warp,
             lane);
      if (pass_dk) {
        scores(dp, sA, sB,
               [&](float* dst, int c) { stage_async<L::KC, L::SA>(dst, v_row, c, a.v); },
               [&](float* dst, int c) { stage_async<L::KC, L::SA>(dst, do_row, c, a.q); }, D,
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
  float* out = static_cast<float*>(pass_dk ? a.dk : a.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= a.Nkv) continue;
    float* po = out + kv_base + size_t(key[i]) * D + c0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      store_pair(po + 8 * j, acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
  }
}

// The column-chunked dQ sweep ("wide_fp32"): one CTA per (64-row q tile, output
// column chunk, batch x q head), walking the key tiles it sees in order;
// dQ += dS K for its 128 columns, times sm_scale at the end.
__device__ __forceinline__ void wide_bwd_dq_chunk(const WideBwdArgs a) {
  using L = WideLayout;
  extern __shared__ __align__(128) unsigned char wsmem[];
  float* sA = reinterpret_cast<float*>(wsmem + L::A_OFF);
  float* sB = reinterpret_cast<float*>(wsmem + L::B_OFF);
  float* sT = reinterpret_cast<float*>(wsmem + L::T_OFF);
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

  const float* qT = static_cast<const float*>(a.q);
  const float* kT = static_cast<const float*>(a.k);
  const float* vT = static_cast<const float*>(a.v);
  const float* dT = static_cast<const float*>(a.dout);
  const size_t kv_base = (size_t(b) * a.Hkv + kvh) * size_t(a.Nkv) * D;
  auto q_row = [&](int r) -> const float* {
    return m0 + r < a.Nq ? qT + (q_base + m0 + r) * D : nullptr;
  };
  auto do_row = [&](int r) -> const float* {
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
    auto k_row = [&](int r) -> const float* {
      return n0 + r < a.Nkv ? kT + kv_base + size_t(n0 + r) * D : nullptr;
    };
    auto v_row = [&](int r) -> const float* {
      return n0 + r < a.Nkv ? vT + kv_base + size_t(n0 + r) * D : nullptr;
    };
    stage_async<WCOLS, L::ST>(sT, k_row, c0, a.k);
    float s[8][4], dp[8][4];
    scores(s, sA, sB,
           [&](float* dst, int c) { stage_async<L::KC, L::SA>(dst, q_row, c, a.q); },
           [&](float* dst, int c) { stage_async<L::KC, L::SA>(dst, k_row, c, a.k); }, D, warp,
           lane);
    scores(dp, sA, sB,
           [&](float* dst, int c) { stage_async<L::KC, L::SA>(dst, do_row, c, a.q); },
           [&](float* dst, int c) { stage_async<L::KC, L::SA>(dst, v_row, c, a.v); }, D, warp,
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
    float* po = static_cast<float*>(a.dq) + (q_base + row[i]) * D + c0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      store_pair(po + 8 * j, acc[j][2 * i] * a.sm_scale, acc[j][2 * i + 1] * a.sm_scale);
  }
}

// The column-chunked sweeps' kernel (`DKV`: dK/dV, else dQ), built where a
// source launches it (attn_bwd_wide.cu).
template <bool DKV>
__global__ void __launch_bounds__(WTHREADS) wide_bwd_chunk_kernel(const WideBwdArgs a) {
  if constexpr (DKV) {
    wide_bwd_dkv_chunk(a);
  } else {
    wide_bwd_dq_chunk(a);
  }
}

// Launches a column-chunked sweep (`dkv`: dK/dV, else dQ).
inline int launch_wide_bwd_chunk(const WideBwdArgs& a, bool dkv) {
  constexpr size_t smem = WideLayout::BYTES;
  const auto kernel = dkv ? wide_bwd_chunk_kernel<true> : wide_bwd_chunk_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid = dkv ? dim3((a.Nkv + WROWS - 1) / WROWS, 2 * (a.D / WCOLS), a.B * a.Hkv)
                        : dim3((a.Nq + WROWS - 1) / WROWS, a.D / WCOLS, a.B * a.Hq);
  kernel<<<grid, WTHREADS, smem, a.stream>>>(a);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The 16-bit sweeps on wgmma ("wide_wgmma")
// ---------------------------------------------------------------------------

namespace sm90 {

constexpr int WB_ROWS = 32;  // rows of a streamed tile: keys (dQ), q rows (dK/dV)

// How the sweeps cut head dim D (geometry.py wide_bwd_cut), `dkv` the
// dK/dV sweep: CTAs a cluster, owners a CTA, 64-column chunks an owner.
// Each CTA holds the partial scores of every owner of its cluster.  A dK/dV
// owner holds dK and dV for its columns, so it takes 128 (2 x 64 fp32
// registers a thread): two owners a CTA at d 512 (2 CTAs), else one a CTA
// (d 384 / 640 / 768 / 896 / 1024 as 3 / 5 / 6 / 7 / 8 CTAs).  A dQ owner
// takes 256 columns where D is a multiple of 256 (d 512 / 768 / 1024 as 2
// / 3 / 4 CTAs of one owner: fewer owners, each with more products a tile
// beside the exchange and the element loop every owner repeats), else 128
// (d 384 / 640 / 896 as 3 / 5 / 7 CTAs).
__host__ __device__ constexpr WideCut wide_bwd_cut(int D, bool dkv) {
  return dkv ? (D == 512 ? WideCut{2, 2, 2} : WideCut{D / 128, 1, 2})
             : (D % 256 == 0 ? WideCut{D / 256, 1, 4} : WideCut{D / 128, 1, 2});
}

// Shared memory of a sweep's CTA of NW owners of C chunks in a cluster of NC
// CTAs, in bytes from a 1024-byte aligned base: the two resident tiles (64
// rows x CW columns: K and V in dK/dV, Q and dO in dQ), STAGES stages of the
// two streamed tiles (WB_ROWS rows x CW: Q and dO, K and V), every owner's
// partial S and dP of the cluster (64 x 32 fp32 each), each stage's row arrays (dK/dV: lse in base-2
// units and D; with segment ids the streamed rows' ids), the barriers
// (resident full; per stage full and empty; the partials' full and empty)
// and 1024 bytes of alignment.  Every tile is [CW / 64 chunks][rows][128
// bytes], swizzled.
template <int NC, int NW, int C, bool DKV>
struct WbLayout {
  static constexpr int CW = 64 * NW * C;
  static constexpr uint32_t RES_BYTES = 64 * CW * 2;
  static constexpr uint32_t STEP_BYTES = WB_ROWS * CW * 2;
  static constexpr uint32_t X_BYTES = 2 * NC * NW * 64 * WB_ROWS * 4;
  __host__ __device__ static constexpr uint32_t rows(int stages, bool seg) {
    return stages * ((DKV ? 2 : 0) + (seg ? 1 : 0)) * WB_ROWS * 4;
  }
  __host__ __device__ static constexpr size_t bytes(int stages, bool seg) {
    return 2 * size_t(RES_BYTES) + 2 * size_t(stages) * STEP_BYTES + X_BYTES + rows(stages, seg) +
           8 * (1 + 2 * stages + 2) + 1024;
  }
  // as many stages as fit with segment ids, at most 4
  __host__ __device__ static constexpr int fit() {
    int s = 4;
    while (s > 2 && bytes(s, true) > 232448) --s;
    return s;
  }
  static constexpr int STAGES = fit();
  static_assert(bytes(STAGES, true) <= 232448, "a CTA has 227 KB of shared memory");
  static constexpr uint32_t U_OFF = 2 * RES_BYTES;                 // the first streamed tile
  static constexpr uint32_t W_OFF = U_OFF + STAGES * STEP_BYTES;   // the second
  static constexpr uint32_t X_OFF = W_OFF + STAGES * STEP_BYTES;   // the partials
  static constexpr uint32_t ROWS_OFF = X_OFF + X_BYTES;
};

// The exchange of a sweep's partial scores.  Every owner of the cluster
// writes its partial S and dP of a tile (64 x 32 fp32: 16 of each a
// thread) into its slot of its own CTA's shared memory (owner p's slot at
// X_OFF + 16384 p: 4 KB a warp, float4 j of array a (0 S, 1 dP) of lane l at
// + (a NS + j) 512 + 16 l), and each warp copies its 4 KB into the same
// slot of every other CTA of the cluster with one bulk copy (DSMEM), whose
// bytes complete that CTA's `full` barrier; then each owner sums all
// owners' partials from its own CTA's shared memory, S and then dP, in
// owner order (owner p is slot p % NW of rank p / NW), so that every owner
// holds the same bits.  One round trip a tile: `full` completes when every
// local owner warp has written (and arrived, expecting its share of the
// peers' bytes) and every peer's bytes have landed, `empty` when every
// owner warp of the cluster has read.
template <int NC, int NW>
struct BwdExchange {
  static constexpr int OWNERS = NC * NW, NS = WB_ROWS / 8;
  uint32_t base, x_off, full, empty;
  int wt, me;

  // Owner p's partials for this thread in this CTA (S, float4 0).
  __device__ __forceinline__ uint32_t slot(int p) const {
    return base + x_off + p * 16384 + ((wt / 32) * 2 * NS * 32 + wt % 32) * 16;
  }
  // float4 j of array arr (0 S, 1 dP) of the slot at `at`
  static __device__ __forceinline__ float4 read(uint32_t at, int arr, int j) {
    float4 v;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(at + (arr * NS + j) * 512)
                 : "memory");
    return v;
  }
  static __device__ __forceinline__ void write(uint32_t at, float x, float y, float z, float w) {
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(at), "f"(x), "f"(y), "f"(z),
                 "f"(w)
                 : "memory");
  }
  __device__ __forceinline__ void arrive(uint32_t bar) const {  // on every CTA's barrier
    __syncwarp();
    if (wt % 32 == 0) {
      if constexpr (NC == 1) {
        mbar_arrive(bar);
      } else {
        for (int c = 0; c < NC; ++c) mbar_arrive_peer(peer_addr(bar, c));
      }
    }
  }
  __device__ __forceinline__ void wait(uint32_t bar, uint32_t parity) const {
    if constexpr (NC == 1) {
      mbar_wait(bar, parity);
    } else {
      mbar_wait_cluster(bar, parity);
    }
  }
  // The i-th exchange of this owner: s and dp, its partials, become the sums.
  __device__ __forceinline__ void run(float (&s)[4 * NS], float (&dp)[4 * NS], int i) const {
    if (i > 0) wait(empty, (i - 1) & 1);  // every owner has read exchange i - 1's
    const uint32_t own = slot(me);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      write(own + j * 512, s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
      write(own + (NS + j) * 512, dp[4 * j], dp[4 * j + 1], dp[4 * j + 2], dp[4 * j + 3]);
    }
    fence_proxy_async();  // the slot is read by the bulk copies
    __syncwarp();
    if (wt % 32 == 0) {
      mbar_expect_tx(full, (NC - 1) * 4096);  // this warp's share of the peers' bytes
      const uint32_t warp_slot = base + x_off + me * 16384 + (wt / 32) * 4096;
      for (int c = 0; c < NC; ++c)
        if (c != me / NW) bulk_copy_peer(peer_addr(warp_slot, c), warp_slot, 4096, peer_addr(full, c));
    }
    wait(full, i & 1);
#pragma unroll
    for (int p = 0; p < OWNERS; ++p) {  // S: each owner's partial in owner order
      const int src_s = p;  // the owner whose S partial is added
      const uint32_t at = slot(src_s);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float4 x = read(at, 0, j);
        if (p == 0) {
          s[4 * j] = x.x, s[4 * j + 1] = x.y, s[4 * j + 2] = x.z, s[4 * j + 3] = x.w;
        } else {
          s[4 * j] += x.x, s[4 * j + 1] += x.y, s[4 * j + 2] += x.z, s[4 * j + 3] += x.w;
        }
      }
    }
#pragma unroll
    for (int p = 0; p < OWNERS; ++p) {  // dP: each owner's partial in owner order
      const uint32_t at = slot(p);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float4 x = read(at, 1, j);
        if (p == 0) {
          dp[4 * j] = x.x, dp[4 * j + 1] = x.y, dp[4 * j + 2] = x.z, dp[4 * j + 3] = x.w;
        } else {
          dp[4 * j] += x.x, dp[4 * j + 1] += x.y, dp[4 * j + 2] += x.z, dp[4 * j + 3] += x.w;
        }
      }
    }
    arrive(empty);
  }
};

// A partial score product of one owner, issued (not committed): acc = A
// B^T over the owner's OC columns, A its 64 resident rows at `a_rows` (a
// tile of 64-row chunks), B its columns of the WB_ROWS-row stage at
// `b_rows`, both K-major (16 columns a k-step, 32 bytes apart inside a
// 128-byte chunk of 64 columns).
template <typename T, int OC>
__device__ __forceinline__ void issue_partial(float (&acc)[WB_ROWS / 2], uint32_t a_rows,
                                              uint32_t b_rows) {
#pragma unroll
  for (int ks = 0; ks < OC / 16; ++ks) {
    const uint32_t in_chunk = (ks % 4) * 32;
    WgmmaSS<WB_ROWS, T>::run(acc, smem_desc(a_rows + (ks / 4) * (64 * 128) + in_chunk, 16, 1024),
                             smem_desc(b_rows + (ks / 4) * (WB_ROWS * 128) + in_chunk, 16, 1024),
                             ks > 0);
  }
}

// A 64 x WB_ROWS score accumulator as the A fragments of an update product
// (its columns become the k dimension), rounded to T.
template <typename T>
__device__ __forceinline__ void pack_scores(const float (&acc)[WB_ROWS / 2],
                                            uint32_t (&a)[WB_ROWS / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < WB_ROWS / 16; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) a[kk][x] = Mma<T>::pack(acc[8 * kk + 2 * x], acc[8 * kk + 2 * x + 1]);
  }
}

// acc (an owner's OC = 64 C columns) += A B, issued: A from registers, B
// the owner's columns of a WB_ROWS-row stage at `b_rows`, read MN-major.
template <typename T, int C>
__device__ __forceinline__ void issue_update(float (&acc)[32 * C],
                                             const uint32_t (&a)[WB_ROWS / 16][4],
                                             uint32_t b_rows) {
#pragma unroll
  for (int kk = 0; kk < WB_ROWS / 16; ++kk)
    pv_product<C, T>(acc, a[kk], b_rows + kk * 2048, WB_ROWS * 128);
}

// The dQ sweep in T = bf16 / fp16: one cluster of NC CTAs per (64-row q
// tile, heaviest causal tiles first; batch x q head).  CTA `rank` holds Q
// and dO for columns [rank CW, + CW) (TMA, once), streams the K and V tiles
// of 32 keys the rows see (kv_tiles) through the ring, and owner w of it
// computes partial S = Q K^T and dP = dO V^T over its 128 columns,
// exchanges them (BwdExchange), builds dS (attn_bwd_sm90.cuh's element
// loop) and adds dS K to dQ[:, its columns] (K read MN-major).  The update
// of tile i runs beside the score products, exchange and element loop of
// tile i + 1.
template <typename T, int NC, int NW, int C>
__global__ void __launch_bounds__(128 * (NW + 1), 1)
wide_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do, const WideBwdArgs a) {
  using L = WbLayout<NC, NW, C, false>;
  constexpr int BN = WB_ROWS, STAGES = L::STAGES, CW = L::CW, OC = 64 * C;
  constexpr int NS = BN / 8, NO = OC / 8;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sQ = base, sdO = base + L::RES_BYTES;
  auto k_tile = [&](int s) { return base + L::U_OFF + s * L::STEP_BYTES; };
  auto v_tile = [&](int s) { return base + L::W_OFF + s * L::STEP_BYTES; };
  auto tile_ids = [&](int s) {  // the segment ids of the K tile in stage s
    return reinterpret_cast<int*>(smem + L::ROWS_OFF) + s * BN;
  };

  const int D = a.D, G = a.Hq / a.Hkv;
  const int rank = NC > 1 ? cluster_rank() : 0;
  const int c_lo = rank * CW;
  const int cta = blockIdx.x / NC;
  const int b = blockIdx.y / a.Hq, h = blockIdx.y % a.Hq;
  const int kv_bh = b * a.Hkv + h / G;
  const int m0 = (a.causal ? int(gridDim.x) / NC - 1 - cta : cta) * 64;
  const bool seg = a.md.q_seg != nullptr, drop = a.md.rate > 0.f;
  const TileRange tr = kv_tiles<64, BN>(m0, a.Nq, a.Nkv, a.causal, a.window);
  const int k_first = tr.lo * BN, n_tiles = max(tr.hi - tr.lo, 0);
  T* const dq = static_cast<T*>(a.dq) + size_t(blockIdx.y) * a.Nq * D;

  if (n_tiles == 0) {  // the rows see no key: dQ = 0, every CTA of the cluster
    for (int idx = threadIdx.x; idx < 64 * (CW / 8); idx += blockDim.x) {
      const int r = m0 + idx / (CW / 8);
      if (r < a.Nq)
        *reinterpret_cast<uint4*>(dq + size_t(r) * D + c_lo + (idx % (CW / 8)) * 8) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }

  const uint32_t bars = base + L::ROWS_OFF + L::rows(STAGES, seg);
  const uint32_t bar_res = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  const uint32_t x_full = bars + 8u * (1 + 2 * STAGES), x_empty = x_full + 8u;

  if (threadIdx.x == 0) {
    mbar_init(bar_res, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * NW);  // one arrival per owner warp
    }
    mbar_init(x_full, 4 * NW);        // one arrival per owner warp of the CTA, and the bytes
    mbar_init(x_empty, 4 * NC * NW);  // one arrival per owner warp of the cluster
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (NC > 1) cluster_sync();  // the peers' barriers exist before any arrival

  if (threadIdx.x < 128) {
    // Producer warpgroup: thread 0 issues every copy; with segment ids its
    // warp writes each K tile's ids.  The rest have no work.
    if constexpr (NW > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_PRODUCER_REGS));
    const int tid = threadIdx.x;
    if (tid < (seg ? 32 : 1)) {
      const bool leader = tid == 0;
      if (leader) {
        mbar_expect_tx(bar_res, 2 * L::RES_BYTES);
#pragma unroll
        for (int c = 0; c < CW / 64; ++c) {
          tma_load_3d(sQ + c * (64 * 128), &tm_q, bar_res, c_lo + 64 * c, m0, blockIdx.y);
          tma_load_3d(sdO + c * (64 * 128), &tm_do, bar_res, c_lo + 64 * c, m0, blockIdx.y);
        }
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, n0 = k_first + i * BN;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);  // passes at once on the first lap
        if (seg) {
          for (int x = tid; x < BN; x += 32) tile_ids(s)[x] = seg_id(a.md.kv_seg, b, a.Nkv, n0 + x);
          __syncwarp();  // the ids are written before the full barrier completes
        }
        if (leader) {
          mbar_expect_tx(full(s), 2 * L::STEP_BYTES);
#pragma unroll
          for (int c = 0; c < CW / 64; ++c) {
            tma_load_3d(k_tile(s) + c * (BN * 128), &tm_k, full(s), c_lo + 64 * c, n0, kv_bh);
            tma_load_3d(v_tile(s) + c * (BN * 128), &tm_v, full(s), c_lo + 64 * c, n0, kv_bh);
          }
        }
      }
    }
  } else {
    // Owners: consumer warpgroup w of the CTA, 64 q rows x its OC columns.
    if constexpr (NW > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONSUMER_REGS));
    const int w = threadIdx.x / 128 - 1;
    const int wt = threadIdx.x % 128, warp = wt / 32, lane = wt % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = m0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
    const int q_off = a.Nkv - a.Nq;
    const uint32_t q_own = sQ + w * C * (64 * 128), do_own = sdO + w * C * (64 * 128);
    const float scale_log2 = a.sm_scale * kLog2e;
    const float slope = a.md.slopes != nullptr ? a.md.slopes[h] : 0.f;
    const float slope_log2 = slope * kLog2e;
    const uint32_t stream = drop ? dropout_stream(a.md.seed, b, h) : 0u;
    const uint32_t keep_min = drop ? uint32_t(ceilf(a.md.rate * 16777216.f)) : 0u;
    const BwdExchange<NC, NW> xchg{base, L::X_OFF, x_full, x_empty, wt, rank * NW + w};
    // this thread's rows' lse (base 2), D and segment ids; 0 past Nq
    float lse2[2], dlt[2];
    int qseg[2] = {0, 0};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lse2[r] = row < a.Nq ? a.lse[size_t(blockIdx.y) * a.Nq + row] * kLog2e : 0.f;
      dlt[r] = row < a.Nq ? a.delta[size_t(blockIdx.y) * a.Nq + row] : 0.f;
      if (seg) qseg[r] = seg_id(a.md.q_seg, b, a.Nq, row);
    }

    // S, then P; dP, then dS: element e of n-tile j is row row0 + 8 (e >> 1),
    // key n0 + 8 j + 2 t + (e & 1).
    float s[BN / 2], dp[BN / 2], acc[OC / 2];
    uint32_t da[BN / 16][4];
#pragma unroll
    for (int i = 0; i < OC / 2; ++i) acc[i] = 0.f;

    // dS of keys [n0, n0 + BN) in place of dP; the softcap, the mask and
    // ALiBi compiled out of a tile that needs none.
    auto grads = [&](int n0, const int* ids, auto cap, auto masked, auto alibi) {
      const float dist0[2] = {float(row0 + q_off - n0 - 2 * t),
                              float(row0 + 8 + q_off - n0 - 2 * t)};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = n0 + 8 * j + 2 * t + c;
          // the dropout hash's column half, shared by the thread's two rows
          const uint32_t inner = drop ? lowbias32(uint32_t(col) + stream) : 0u;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + c;
            const float dist = dist0[r] - float(8 * j + c);
            float x, dcap = 1.f;
            if constexpr (decltype(cap)::value) {
              const float th = tanhf(s[4 * j + e] * a.sm_scale / a.softcap);
              x = a.softcap * th;
              dcap = 1.f - th * th;
              if constexpr (decltype(alibi)::value) x -= slope * dist;
              x = x * kLog2e - lse2[r];
            } else {
              x = s[4 * j + e] * scale_log2 - lse2[r];
              if constexpr (decltype(alibi)::value) x -= slope_log2 * dist;
            }
            float p = exp2_ftz(x);
            if constexpr (decltype(masked)::value) {
              if (!visible(row0 + 8 * r, col, a.Nq, a.Nkv, a.causal, a.window) ||
                  (seg && qseg[r] != ids[col - n0]))
                p = 0.f;
            }
            float dpv = dp[4 * j + e];
            if (drop) {
              const uint32_t bits = lowbias32(uint32_t(row0 + 8 * r) ^ inner);
              dpv = (bits & 0xFFFFFFu) >= keep_min ? dpv * a.md.keep_scale : 0.f;
            }
            dp[4 * j + e] = p * (dpv - dlt[r]) * dcap;
          }
        }
      }
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    auto own_cols = [&](uint32_t tile) { return tile + w * C * (BN * 128); };

    // Tile i: its partial S and dP are issued beside dQ's update from tile
    // i - 1; the exchange and the element loop of tile i run while that
    // update finishes.  Stage i - 1 (K and V) is released once its update
    // is done.
    mbar_wait(bar_res, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % STAGES, prev = (i + STAGES - 1) % STAGES;
      const int n0 = k_first + i * BN;
      mbar_wait(full(st), (i / STAGES) & 1);
      wgmma_fence();
      issue_partial<T, OC>(s, q_own, own_cols(k_tile(st)));
      issue_partial<T, OC>(dp, do_own, own_cols(v_tile(st)));
      wgmma_commit();
      if (i > 0) {
        wgmma_fence();
        issue_update<T, C>(acc, da, own_cols(k_tile(prev)));  // dQ: tile i - 1
        wgmma_commit();
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      } else {
        wgmma_wait_all();
      }
      fence_regs(s);
      fence_regs(dp);
      xchg.run(s, dp, i);  // the dQ sweep's exchange
      const bool masked = seg || !tile_unmasked<64, BN>(m0, n0, a.Nq, a.Nkv, a.causal, a.window);
      with_flags(a.softcap > 0.f, masked, a.md.slopes != nullptr,
                 [&](auto cap, auto msk, auto alibi) {  // the dQ sweep's element loop
                   grads(n0, tile_ids(st), cap, msk, alibi);
                 });
      if (i > 0) {
        wgmma_wait_all();
        fence_regs(acc);
        release(empty(prev));
      }
      pack_scores<T>(dp, da);
    }
    // n_tiles > 0 here (an empty CTA returned above)
    if (n_tiles > 0) {
      const int last = (n_tiles - 1) % STAGES;
      wgmma_fence();
      issue_update<T, C>(acc, da, own_cols(k_tile(last)));  // dQ: the last tile
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      release(empty(last));
    }

    // dQ[:, the owner's columns] times sm_scale
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= a.Nq) continue;
      T* dst = dq + size_t(row) * D + c_lo + w * OC + 2 * t;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        *reinterpret_cast<uint32_t*>(dst + j * 8) =
            Mma<T>::pack(acc[4 * j + 2 * r] * a.sm_scale, acc[4 * j + 2 * r + 1] * a.sm_scale);
    }
  }
  // No CTA leaves while a peer may still read its partials or arrive on its
  // barriers.
  if constexpr (NC > 1) cluster_sync();
}

// The dK/dV sweep in T = bf16 / fp16: one cluster of NC CTAs per (64-key
// tile, batch x kv head).  CTA `rank` holds K and V for its CW columns
// (TMA, once) and streams, for each q head of the GQA group and then its
// q steps in order, the 32-row Q and dO tiles that see the keys (q_tiles),
// with each step's lse (base 2), D and q segment ids beside them.  Owner w
// computes partial S^T = K Q^T and dP^T = V dO^T over its 128 columns,
// exchanges them (BwdExchange), builds P^T o M and dS^T (attn_bwd_sm90.cuh's
// element loop: a thread's rows are its two keys, its columns q rows) and
// adds dV[:, own] += (P o M)^T dO and dK[:, own] += dS^T Q (the stage read
// MN-major), in order a step: 8 d operations a visible pair.
template <typename T, int NC, int NW, int C>
__global__ void __launch_bounds__(128 * (NW + 1), 1)
wide_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const WideBwdArgs a) {
  using L = WbLayout<NC, NW, C, true>;
  constexpr int BS = WB_ROWS, STAGES = L::STAGES, CW = L::CW, OC = 64 * C;
  constexpr int NS = BS / 8, NO = OC / 8;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sK = base, sV = base + L::RES_BYTES;
  auto q_tile = [&](int s) { return base + L::U_OFF + s * L::STEP_BYTES; };
  auto do_tile = [&](int s) { return base + L::W_OFF + s * L::STEP_BYTES; };

  const int D = a.D, G = a.Hq / a.Hkv;
  const int rank = NC > 1 ? cluster_rank() : 0;
  const int c_lo = rank * CW;
  const int n0 = (blockIdx.x / NC) * 64;  // causal: the first key tiles see the most q rows
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const bool seg = a.md.q_seg != nullptr, drop = a.md.rate > 0.f;
  const int arrays = seg ? 3 : 2;  // a stage's rows: lse (base 2), D, q segment ids
  auto rows_of = [&](int s, int arr) {
    return reinterpret_cast<float*>(smem + L::ROWS_OFF) + (s * arrays + arr) * BS;
  };
  const TileRange steps = q_tiles<BS, 64>(n0, a.Nq, a.Nkv, a.causal, a.window);
  const int per_head = max(steps.hi - steps.lo, 0);
  const int n_steps = G * per_head;  // q heads of the group, then their steps
  const size_t out = size_t(blockIdx.y) * a.Nkv * D;

  if (n_steps == 0) {  // no q row sees the keys: dK = dV = 0, every CTA of the cluster
    for (int idx = threadIdx.x; idx < 64 * (CW / 8); idx += blockDim.x) {
      const int key = n0 + idx / (CW / 8);
      if (key >= a.Nkv) continue;
      const size_t at = out + size_t(key) * D + c_lo + (idx % (CW / 8)) * 8;
      *reinterpret_cast<uint4*>(static_cast<T*>(a.dk) + at) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(static_cast<T*>(a.dv) + at) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  const uint32_t bars = base + L::ROWS_OFF + L::rows(STAGES, seg);
  const uint32_t bar_res = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  const uint32_t x_full = bars + 8u * (1 + 2 * STAGES), x_empty = x_full + 8u;

  if (threadIdx.x == 0) {
    mbar_init(bar_res, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * NW);
    }
    mbar_init(x_full, 4 * NW);
    mbar_init(x_empty, 4 * NC * NW);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (NC > 1) cluster_sync();

  if (threadIdx.x < 128) {
    // Producer warpgroup: thread 0 issues every copy, its warp stages each
    // step's rows; the other warps leave.
    if constexpr (NW > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_PRODUCER_REGS));
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(bar_res, 2 * L::RES_BYTES);
#pragma unroll
        for (int c = 0; c < CW / 64; ++c) {
          tma_load_3d(sK + c * (64 * 128), &tm_k, bar_res, c_lo + 64 * c, n0, blockIdx.y);
          tma_load_3d(sV + c * (64 * 128), &tm_v, bar_res, c_lo + 64 * c, n0, blockIdx.y);
        }
      }
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % STAGES;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        const int bh = b * a.Hq + kvh * G + i / per_head;
        const int m0 = (steps.lo + i % per_head) * BS;
        for (int x = lane; x < BS; x += 32) {
          const int row = m0 + x;
          const bool in = row < a.Nq;
          rows_of(s, 0)[x] = in ? a.lse[size_t(bh) * a.Nq + row] * kLog2e : 0.f;
          rows_of(s, 1)[x] = in ? a.delta[size_t(bh) * a.Nq + row] : 0.f;
          if (seg) reinterpret_cast<int*>(rows_of(s, 2))[x] = seg_id(a.md.q_seg, b, a.Nq, row);
        }
        __syncwarp();  // the rows are written before the full barrier completes
        if (lane == 0) {
          mbar_expect_tx(full(s), 2 * L::STEP_BYTES);
#pragma unroll
          for (int c = 0; c < CW / 64; ++c) {
            tma_load_3d(q_tile(s) + c * (BS * 128), &tm_q, full(s), c_lo + 64 * c, m0, bh);
            tma_load_3d(do_tile(s) + c * (BS * 128), &tm_do, full(s), c_lo + 64 * c, m0, bh);
          }
        }
      }
    }
  } else {
    // Owners: consumer warpgroup w of the CTA, 64 keys x its OC columns.
    if constexpr (NW > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONSUMER_REGS));
    const int w = threadIdx.x / 128 - 1;
    const int wt = threadIdx.x % 128, warp = wt / 32, lane = wt % 32;
    const int g = lane / 4, t = lane % 4;
    const int key0 = n0 + 16 * warp + g;  // this thread's keys: key0, key0 + 8
    const int q_off = a.Nkv - a.Nq;
    const uint32_t k_own = sK + w * C * (64 * 128), v_own = sV + w * C * (64 * 128);
    const float scale_log2 = a.sm_scale * kLog2e;
    const uint32_t keep_min = drop ? uint32_t(ceilf(a.md.rate * 16777216.f)) : 0u;
    const BwdExchange<NC, NW> xchg{base, L::X_OFF, x_full, x_empty, wt, rank * NW + w};
    int kseg[2] = {0, 0};
    if (seg) {
      kseg[0] = seg_id(a.md.kv_seg, b, a.Nkv, key0);
      kseg[1] = seg_id(a.md.kv_seg, b, a.Nkv, key0 + 8);
    }

    // S^T, then P^T o M; dP^T, then dS^T: element e of n-tile j is key
    // key0 + 8 (e >> 1), q row m0 + 8 j + 2 t + (e & 1).
    float s[BS / 2], dp[BS / 2], dk[OC / 2], dv[OC / 2];
    uint32_t pa[BS / 16][4], da[BS / 16][4];
#pragma unroll
    for (int i = 0; i < OC / 2; ++i) dk[i] = dv[i] = 0.f;

    // P^T o M and dS^T of q step m0 (stage st) in place of S^T and dP^T.
    auto grads = [&](int m0, int st, float slope, uint32_t stream, auto cap, auto masked,
                     auto alibi) {
      const float* lse2 = rows_of(st, 0);
      const float* dlt = rows_of(st, 1);
      const int* qseg = reinterpret_cast<const int*>(rows_of(st, 2));
      const float slope_log2 = slope * kLog2e;
      // the ALiBi distance q_pos - key, exact in fp32
      const float dist0[2] = {float(m0 + 2 * t + q_off - key0),
                              float(m0 + 2 * t + q_off - key0 - 8)};
      uint32_t inner[2] = {0u, 0u};  // the dropout hash's half of each key
      if (drop) {
        inner[0] = lowbias32(uint32_t(key0) + stream);
        inner[1] = lowbias32(uint32_t(key0 + 8) + stream);
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
        const float2 d2 = *reinterpret_cast<const float2*>(dlt + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = e & 1;
          const int col = 8 * j + 2 * t + c;  // q row - m0
          const float dist = dist0[r] + float(8 * j + c);
          float x, dcap = 1.f;
          if constexpr (decltype(cap)::value) {
            const float th = tanhf(s[4 * j + e] * a.sm_scale / a.softcap);
            x = a.softcap * th;
            dcap = 1.f - th * th;
            if constexpr (decltype(alibi)::value) x -= slope * dist;
            x = x * kLog2e - (c ? l2.y : l2.x);
          } else {
            x = s[4 * j + e] * scale_log2 - (c ? l2.y : l2.x);
            if constexpr (decltype(alibi)::value) x -= slope_log2 * dist;
          }
          float p = exp2_ftz(x);
          if constexpr (decltype(masked)::value) {
            if (m0 + col >= a.Nq || !visible(m0 + col, key0 + 8 * r, a.Nq, a.Nkv, a.causal, a.window) ||
                (seg && kseg[r] != qseg[col]))
              p = 0.f;
          }
          float keep = 1.f;
          if (drop) {
            const uint32_t bits = lowbias32(uint32_t(m0 + col) ^ inner[r]);
            keep = (bits & 0xFFFFFFu) >= keep_min ? a.md.keep_scale : 0.f;
          }
          s[4 * j + e] = p * keep;
          dp[4 * j + e] = p * (dp[4 * j + e] * keep - (c ? d2.y : d2.x)) * dcap;
        }
      }
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    auto own_cols = [&](uint32_t tile) { return tile + w * C * (BS * 128); };

    mbar_wait(bar_res, 0);
    for (int i = 0; i < n_steps; ++i) {
      const int st = i % STAGES;
      const int h = kvh * G + i / per_head;  // the q head: slope, dropout stream
      const int m0 = (steps.lo + i % per_head) * BS;
      mbar_wait(full(st), (i / STAGES) & 1);
      wgmma_fence();
      issue_partial<T, OC>(s, k_own, own_cols(q_tile(st)));
      issue_partial<T, OC>(dp, v_own, own_cols(do_tile(st)));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      xchg.run(s, dp, i);  // the dK/dV sweep's exchange
      const float slope = a.md.slopes != nullptr ? a.md.slopes[h] : 0.f;
      const uint32_t stream = drop ? dropout_stream(a.md.seed, b, h) : 0u;
      const bool masked = seg || m0 + BS > a.Nq ||
                          !tile_unmasked<BS, 64>(m0, n0, a.Nq, a.Nkv, a.causal, a.window);
      with_flags(a.softcap > 0.f, masked, a.md.slopes != nullptr,
                 [&](auto cap, auto msk, auto alibi) {  // the dK/dV sweep's element loop
                   grads(m0, st, slope, stream, cap, msk, alibi);
                 });
      pack_scores<T>(s, pa);
      pack_scores<T>(dp, da);
      wgmma_fence();
      issue_update<T, C>(dv, pa, own_cols(do_tile(st)));  // dV += (P o M)^T dO
      issue_update<T, C>(dk, da, own_cols(q_tile(st)));   // dK += dS^T Q
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv);
      fence_regs(dk);
      release(empty(st));  // both updates have read the stage
    }

    // dK (times sm_scale) and dV for the owner's columns
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= a.Nkv) continue;
      const size_t at = out + size_t(key) * D + c_lo + w * OC + 2 * t;
      T* dst_k = static_cast<T*>(a.dk) + at;
      T* dst_v = static_cast<T*>(a.dv) + at;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        *reinterpret_cast<uint32_t*>(dst_k + j * 8) =
            Mma<T>::pack(dk[4 * j + 2 * r] * a.sm_scale, dk[4 * j + 2 * r + 1] * a.sm_scale);
        *reinterpret_cast<uint32_t*>(dst_v + j * 8) =
            Mma<T>::pack(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
  if constexpr (NC > 1) cluster_sync();
}

}  // namespace sm90

// Dynamic shared memory of a 16-bit sweep's instance at head dim D (`dkv`:
// the dK/dV sweep, else dQ; with segment ids `seg`), in bytes; 0 for
// another D.
template <int NC, int NW, int C, bool DKV>
int wide_bwd_bytes(bool seg) {
  using L = sm90::WbLayout<NC, NW, C, DKV>;
  return int(L::bytes(L::STAGES, seg));
}
inline int wide_bwd_smem(int D, bool seg, bool dkv) {
  if (dkv) {
    switch (D) {
      case 384: return wide_bwd_bytes<3, 1, 2, true>(seg);
      case 512: return wide_bwd_bytes<2, 2, 2, true>(seg);
      case 640: return wide_bwd_bytes<5, 1, 2, true>(seg);
      case 768: return wide_bwd_bytes<6, 1, 2, true>(seg);
      case 896: return wide_bwd_bytes<7, 1, 2, true>(seg);
      case 1024: return wide_bwd_bytes<8, 1, 2, true>(seg);
      default: return 0;
    }
  }
  switch (D) {
    case 384: return wide_bwd_bytes<3, 1, 2, false>(seg);
    case 512: return wide_bwd_bytes<2, 1, 4, false>(seg);
    case 640: return wide_bwd_bytes<5, 1, 2, false>(seg);
    case 768: return wide_bwd_bytes<3, 1, 4, false>(seg);
    case 896: return wide_bwd_bytes<7, 1, 2, false>(seg);
    case 1024: return wide_bwd_bytes<4, 1, 4, false>(seg);
    default: return 0;
  }
}

// Launches one 16-bit sweep of one cut over `grid` clusters (x counts
// clusters), each of NC CTAs along x; returns the launch's error.
template <typename T, bool DKV, int NC, int NW, int C>
int launch_bwd_cut(const WideBwdArgs& a, const CUtensorMap (&maps)[4], dim3 grid) {
  using L = sm90::WbLayout<NC, NW, C, DKV>;
  static_assert(sm90::wide_bwd_cut(64 * NC * NW * C, DKV).nc == NC &&
                    sm90::wide_bwd_cut(64 * NC * NW * C, DKV).nw == NW,
                "the cut of this head dim");
  const auto kernel = [] {  // only this sweep's instance
    if constexpr (DKV) {
      return sm90::wide_bwd_dkv_kernel<T, NC, NW, C>;
    } else {
      return sm90::wide_bwd_dq_kernel<T, NC, NW, C>;
    }
  }();
  const size_t smem = L::bytes(L::STAGES, a.md.q_seg != nullptr);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(grid.x * NC, grid.y, 1);
  cfg.blockDim = dim3(128 * (NW + 1));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute cluster{};
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = NC;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = NC > 1 ? 1 : 0;
  void* args[] = {const_cast<CUtensorMap*>(&maps[0]), const_cast<CUtensorMap*>(&maps[1]),
                  const_cast<CUtensorMap*>(&maps[2]), const_cast<CUtensorMap*>(&maps[3]),
                  const_cast<WideBwdArgs*>(&a)};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// A 16-bit sweep at a.D's cut (sm90::wide_bwd_cut): the tensor maps (3-D:
// d, N, heads; zero fill past a head's tail) of q, k, v and dO, the
// resident tiles in boxes of 64 rows and the streamed ones of 32, and the
// launch over a grid of 64-row tiles (keys for dK/dV, q rows for dQ).
template <typename T>
int launch_wide_bwd_wgmma(const WideBwdArgs& a, bool dkv) {
  CUtensorMap maps[4];  // q, k, v, dO
  const int q_box = dkv ? sm90::WB_ROWS : 64, kv_box = dkv ? 64 : sm90::WB_ROWS;
  if (!sm90::encode_map<T>(&maps[0], a.q, a.D, a.Nq, a.B * a.Hq, q_box) ||
      !sm90::encode_map<T>(&maps[1], a.k, a.D, a.Nkv, a.B * a.Hkv, kv_box) ||
      !sm90::encode_map<T>(&maps[2], a.v, a.D, a.Nkv, a.B * a.Hkv, kv_box) ||
      !sm90::encode_map<T>(&maps[3], a.dout, a.D, a.Nq, a.B * a.Hq, q_box))
    return int(cudaErrorInvalidValue);
  const dim3 grid = dkv ? dim3((a.Nkv + 63) / 64, a.B * a.Hkv) : dim3((a.Nq + 63) / 64, a.B * a.Hq);
  if (dkv) {
    switch (a.D) {
      case 384: return launch_bwd_cut<T, true, 3, 1, 2>(a, maps, grid);
      case 512: return launch_bwd_cut<T, true, 2, 2, 2>(a, maps, grid);
      case 640: return launch_bwd_cut<T, true, 5, 1, 2>(a, maps, grid);
      case 768: return launch_bwd_cut<T, true, 6, 1, 2>(a, maps, grid);
      case 896: return launch_bwd_cut<T, true, 7, 1, 2>(a, maps, grid);
      case 1024: return launch_bwd_cut<T, true, 8, 1, 2>(a, maps, grid);
      default: return int(cudaErrorInvalidValue);
    }
  }
  switch (a.D) {
    case 384: return launch_bwd_cut<T, false, 3, 1, 2>(a, maps, grid);
    case 512: return launch_bwd_cut<T, false, 2, 1, 4>(a, maps, grid);
    case 640: return launch_bwd_cut<T, false, 5, 1, 2>(a, maps, grid);
    case 768: return launch_bwd_cut<T, false, 3, 1, 4>(a, maps, grid);
    case 896: return launch_bwd_cut<T, false, 7, 1, 2>(a, maps, grid);
    case 1024: return launch_bwd_cut<T, false, 4, 1, 4>(a, maps, grid);
    default: return int(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// Merging key splits (decode and verify)
// ---------------------------------------------------------------------------

// Columns of a row one CTA of the merge takes: 4 a thread.
constexpr int WCOMBINE_COLS = 4 * WTHREADS;

// One CTA a row of `rows` and WCOMBINE_COLS of its columns: O = sum_s w_s
// O_s / sum_s w_s with w_s = exp(lse_s - max lse) in split order
// (ops/decode.py combine_partials); a partial of lse -inf weighs 0 (its O
// is never read); a row no split saw gets O = 0 and lse kMaskValue.  O in
// `dtype` (paged.cuh store_as), lse when not null.  A thread sums 4
// adjacent columns (D is a multiple of 128), its loads of the splits
// independent of one another so that several are in flight at once.
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
  const int c = blockIdx.y * WCOMBINE_COLS + 4 * threadIdx.x;
  if (c < D) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      const float ls = part_lse[size_t(s) * rows + r];
      if (ls == -INFINITY) continue;
      const float w = expf(ls - m_use);
      const float4 x = *reinterpret_cast<const float4*>(part_o + (size_t(s) * rows + r) * D + c);
      acc.x += w * x.x;
      acc.y += w * x.y;
      acc.z += w * x.z;
      acc.w += w * x.w;
    }
    const size_t at = size_t(r) * D + c;
    store_as(o, at, dtype, seen ? acc.x / w_sum : 0.f);
    store_as(o, at + 1, dtype, seen ? acc.y / w_sum : 0.f);
    store_as(o, at + 2, dtype, seen ? acc.z / w_sum : 0.f);
    store_as(o, at + 3, dtype, seen ? acc.w / w_sum : 0.f);
  }
  if (lse != nullptr && blockIdx.y == 0 && threadIdx.x == 0)
    lse[r] = seen ? m + logf(w_sum) : kMaskValue;
}

inline int launch_combine(const float* part_o, const float* part_lse, void* o, int dtype,
                          float* lse, int rows, int splits, int D, cudaStream_t stream) {
  const dim3 grid(rows, (D + WCOMBINE_COLS - 1) / WCOMBINE_COLS);
  wide_combine_kernel<<<grid, WTHREADS, 0, stream>>>(part_o, part_lse, o, dtype, lse, rows,
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
  unsigned* counters;        // [B * Hkv * head pairs], zero between calls, when splits > 1
  int B, Hq, Hkv, P, page_size, pages_per_seq, splits, pages_per_split;
  float sm_scale, softcap;
  const float* slopes;
  cudaStream_t stream;
};

constexpr int WD_THREADS = 256;  // 8 warps
constexpr int WD_WARPS = WD_THREADS / 32;
constexpr int WD_HEADS = 2;      // q heads a CTA serves
constexpr int WD_PIDS = 512;     // page ids of a split staged in shared memory

// One decode CTA at D = 128 NB columns from a pool of KIND, and its shared
// memory in bytes from a 128-byte aligned base (geometry.py
// wide_decode_smem_bytes): the K and V stages (TILE stored rows each, as
// they are in the pool: 32 D bytes a tensor, 8 D for fp8, whose float dots
// of more than one row a warp would not fit 128 registers at d 512), each
// stage's scales (K then V, low then high nibble's token for int4), the
// split's first WD_PIDS page ids, q of the two heads in fp32, the warps'
// running maxima and row sums, then each stage's full and empty barriers.
// The warps' O at the end and the merge's weights reuse the stages.
// Stages: as many as fit 96 KB where two CTAs share an SM (D <= 512), 192
// KB where one CTA fills it, at most 8.
template <int KIND, int NB>
struct WdLayout {
  static constexpr int D = WCOLS * NB;
  static constexpr int EB = stored_bytes(KIND);
  static constexpr bool QUANT = is_quantized(KIND);
  static constexpr bool INT_ROUTE = KIND == kI8 || KIND == kI4;
  static constexpr int NTOK = KIND == kI4 ? 2 : 1;  // tokens a stored row holds
  static constexpr int ROW_BYTES = D * EB;
  static constexpr int TILE = EB == 1 && !INT_ROUTE ? 8 : 32 / EB;  // stored rows a stage
  static constexpr int R = TILE / WD_WARPS;         // rows of a tile each warp takes
  static constexpr int LB = ROW_BYTES / 32;         // bytes of a row a lane owns
  static constexpr int CB = LB % 16 == 0 ? 16 : (LB % 8 == 0 ? 8 : 4);  // bytes a read
  static constexpr int NCH = LB / CB;               // reads a lane makes of a row
  static constexpr int VEC = CB / EB;               // elements of one read
  static constexpr int E = D / 32;                  // columns a lane owns
  static constexpr int NW = LB / 4;                 // words of a lane's share of a row
  static constexpr int CTAS = NB <= 4 ? 2 : 1;      // CTAs an SM
  static constexpr int BUDGET = NB <= 4 ? 96 * 1024 : 192 * 1024;
  static constexpr uint32_t TILE_BYTES = TILE * ROW_BYTES;
  static constexpr int STAGES = BUDGET / (2 * TILE_BYTES) < 8 ? BUDGET / (2 * TILE_BYTES) : 8;
  static constexpr uint32_t SC_BYTES = QUANT ? 2 * NTOK * TILE * 4 : 0;
  static constexpr uint32_t V_OFF = STAGES * TILE_BYTES;
  static constexpr uint32_t SC_OFF = 2 * STAGES * TILE_BYTES;
  static constexpr uint32_t PID_OFF = SC_OFF + STAGES * SC_BYTES;
  static constexpr uint32_t Q_OFF = PID_OFF + WD_PIDS * 4;
  static constexpr uint32_t M_OFF = Q_OFF + WD_HEADS * D * 4;
  static constexpr uint32_t L_OFF = M_OFF + WD_WARPS * WD_HEADS * 4;
  static constexpr uint32_t BAR_OFF = (L_OFF + WD_WARPS * WD_HEADS * 4 + 7) & ~7u;
  static constexpr size_t BYTES = BAR_OFF + 16 * STAGES;
  static_assert(NB >= 3 && NB <= WIDE_CUT_MAX_D / WCOLS, "a wide head dim");
  static_assert(R >= 1 && TILE % WD_WARPS == 0 && LB % CB == 0 && (EB > 1 || VEC % 4 == 0),
                "a lane's share of a row is whole reads");
  static_assert(STAGES >= 2, "a ring of at least two stages");
  static_assert(Q_OFF % 16 == 0, "q read as float4");
  static_assert(WD_WARPS * WD_HEADS * D * 4 <= SC_OFF, "the warps' O fits in the stages");
  static_assert(BYTES <= 232448, "one CTA's shared memory");
};

// Column of element e (< D / 32) of lane `lane`: the lane's reads of a row
// are 16, 8 or 4 bytes at (lane + 32 k) CB, consecutive lanes on
// consecutive addresses.
template <int KIND, int NB>
__device__ __forceinline__ int wd_col(int lane, int e) {
  using L = WdLayout<KIND, NB>;
  return (lane + 32 * (e / L::VEC)) * L::VEC + e % L::VEC;
}

// A lane's share of a stored row in shared memory, as 32-bit words.
template <int KIND, int NB>
__device__ __forceinline__ void wd_read_row(const unsigned char* row, int lane,
                                            uint32_t (&w)[WdLayout<KIND, NB>::NW]) {
  using L = WdLayout<KIND, NB>;
  constexpr int WPR = L::CB / 4;  // words a read
#pragma unroll
  for (int k = 0; k < L::NCH; ++k) {
    const unsigned char* p = row + (lane + 32 * k) * L::CB;
    if constexpr (L::CB == 16) {
      const uint4 x = *reinterpret_cast<const uint4*>(p);
      w[k * WPR] = x.x;
      w[k * WPR + 1] = x.y;
      w[k * WPR + 2] = x.z;
      w[k * WPR + 3] = x.w;
    } else if constexpr (L::CB == 8) {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      w[k * WPR] = x.x;
      w[k * WPR + 1] = x.y;
    } else {
      w[k] = *reinterpret_cast<const uint32_t*>(p);
    }
  }
}

// The sums over a warp's 32 lanes of each of v[0 .. N) (N a power of two
// up to 32), in 31 shuffles for N = 32 where one tree each would take 5 N:
// each level of the first log2 N halves the values a lane holds, the lanes
// whose bit is set keeping the upper half; the rest are a butterfly.  Value
// n's sum ends in the lanes l with l >> (5 - log2 N) == n, each the same
// bits (every step adds a pair, which commutes); returns the lane's.
template <int N, typename T>
__device__ __forceinline__ T spread_sum(T (&v)[N], int lane) {
  constexpr int LOG = N == 1 ? 0 : N == 2 ? 1 : N == 4 ? 2 : N == 8 ? 3 : N == 16 ? 4 : 5;
  static_assert(N == 1 << LOG, "N a power of two up to 32");
#pragma unroll
  for (int j = 0; j < LOG; ++j) {
    const int m = 16 >> j, half = N >> (j + 1);
    const bool up = (lane & m) != 0;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const T send = up ? v[k] : v[k + half];
      const T keep = up ? v[k + half] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
  T x = v[0];
#pragma unroll
  for (int j = LOG; j < 5; ++j) x += __shfl_xor_sync(0xffffffffu, x, 16 >> j);
  return x;
}

// Decode, split-KV on asynchronous page copies: paged_decode.cuh's design
// at the wide widths.  One CTA of 8 warps a (key split, pair of q heads of a
// kv head, sequence); the split's page ids land in shared memory first, and
// K, V (and the scales) of each tile of stored rows land in a ring of
// STAGES stages, STAGES - 1 tiles in flight while one is reduced: one 1-D
// bulk copy a tensor where the tile lies in one page (`bulk`), else 16-byte
// cp.asyncs a row.  Warp w takes rows w + 8 i of each tile, a whole row at
// a time: its lanes own D / 32 columns each (wd_col), both heads' partial
// dots of all its rows are summed by one spread_sum, and it keeps its own
// running max, row sum and O for the pair, releasing each stage to the
// copies through the stage's empty barrier (no CTA-wide barrier a tile).
// The warps merge in warp order at the end; with key splits each CTA writes
// its partial, and the last of each group merges them in split order
// (merge_rows), so a call is one launch.  The arithmetic is
// paged_decode.cuh's.
template <int KIND, int NB>
__global__ void __launch_bounds__(WD_THREADS, WdLayout<KIND, NB>::CTAS)
wide_decode_kernel(const WideDecodeArgs a, int bulk) {
  using L = WdLayout<KIND, NB>;
  constexpr int D = L::D, TILE = L::TILE, R = L::R, NTOK = L::NTOK, E = L::E, NW = L::NW;
  constexpr int STAGES = L::STAGES, HB = WD_HEADS;
  constexpr bool QUANT = L::QUANT, INT = L::INT_ROUTE;
  constexpr int N = R * NTOK * HB;  // scores a warp makes of a tile
  constexpr int VPW = E / NW;       // elements a stored word holds
  constexpr int LOG_N = N == 2 ? 1 : N == 4 ? 2 : N == 8 ? 3 : 4;
  using Dot = std::conditional_t<INT, int, float>;
  extern __shared__ __align__(128) unsigned char wsmem[];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G = a.Hq / a.Hkv, HG = (G + HB - 1) / HB;
  const int hg = blockIdx.x % HG, split = blockIdx.x / HG;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int nh = min(HB, G - hg * HB);
  const size_t out_row = size_t(b) * a.Hq + kvh * G + hg * HB;  // (b, first head)
  const size_t part_row = size_t(split) * a.B * a.Hq + out_row;
  const int ps = a.page_size, dt = a.q_dtype;
  const int p_lo = split * a.pages_per_split;
  const int* table = a.page_table + size_t(b) * a.pages_per_seq + p_lo;  // the split's ids
  unsigned* counter = a.counters + (size_t(b) * a.Hkv + kvh) * HG + hg;
  // What needs no length is asked for beside it: the split's first page
  // ids (a thread's two), and the counter's line into L2 for the merge.
  const int n_ids = min(min(a.pages_per_split, a.pages_per_seq - p_lo), WD_PIDS);
  const int id0 = tid < n_ids ? table[tid] : 0;
  const int id1 = tid + WD_THREADS < n_ids ? table[tid + WD_THREADS] : 0;
  if (tid == 0 && a.splits > 1) asm volatile("prefetch.L2 [%0];\n" ::"l"(counter));
  const int len = max(0, min(a.lengths[b], a.pages_per_seq * ps));
  // The last CTA of the group merges the splits' partials.
  auto merge = [&]() {
    if (last_of_group(counter, a.splits))
      merge_rows(a.part_o, a.part_lse, a.splits, size_t(a.B) * a.Hq, nh, D,
                 [&](int h) { return out_row + h; }, a.o, dt, a.lse,
                 reinterpret_cast<float*>(wsmem));  // the stages are free
  };
  if (p_lo * ps >= len) {  // no token of the sequence in this split
    if (a.splits > 1) {
      if (tid < nh) a.part_lse[part_row + tid] = -INFINITY;
      merge();
    } else {
      for (int i = tid; i < nh * D; i += WD_THREADS) store_as(a.o, out_row * D + i, dt, 0.f);
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
  int* s_pid = reinterpret_cast<int*>(wsmem + L::PID_OFF);
  const unsigned char* kb = static_cast<const unsigned char*>(a.k_pages);
  const unsigned char* vb = static_cast<const unsigned char*>(a.v_pages);

  const uint32_t s_base = sm90::smem_u32(wsmem);
  auto full = [&](int s) { return s_base + L::BAR_OFF + 8u * s; };
  auto empty = [&](int s) { return s_base + L::BAR_OFF + 8u * (STAGES + s); };
  // The split's page p: from shared memory (past the first WD_PIDS, from
  // the table).
  auto page_of = [&](int p) { return p < WD_PIDS ? s_pid[p] : __ldg(table + p); };

  // Tile t (stored rows [t * TILE, + TILE) of the split) into stage
  // t % STAGES, once every warp has released the stage's last tile.
  auto issue = [&](int t) {
    const int s = t % STAGES, v0 = t * TILE;
    const uint32_t dk = s_base + s * L::TILE_BYTES;
    const uint32_t dv = dk + L::V_OFF;
    const uint32_t dsc = s_base + L::SC_OFF + s * L::SC_BYTES;
    if (bulk) {  // the tile lies inside one page
      if (tid == 0) {
        if (t >= STAGES) sm90::mbar_wait(empty(s), (t / STAGES - 1) & 1);
        const int page = page_of(v0 / SR), r0 = v0 % SR;
        const size_t row = (size_t(kvh) * a.P + page) * SR + r0;
        sm90::fence_proxy_async();  // the stage's last reads come first
        sm90::mbar_expect_tx(full(s), 2 * L::TILE_BYTES + L::SC_BYTES);
        bulk_copy(dk, kb + row * L::ROW_BYTES, L::TILE_BYTES, full(s));
        bulk_copy(dv, vb + row * L::ROW_BYTES, L::TILE_BYTES, full(s));
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
      if (t >= STAGES) sm90::mbar_wait(empty(s), (t / STAGES - 1) & 1);
      constexpr int CPR = L::ROW_BYTES / 16;
      for (int idx = tid; idx < TILE * CPR; idx += WD_THREADS) {
        const int r = idx / CPR, c = idx % CPR, v = v0 + r;
        if (v < n_rows) {
          const size_t row = (size_t(kvh) * a.P + page_of(v / SR)) * SR + v % SR;
          cp_async16(dk + r * L::ROW_BYTES + c * 16, kb + row * L::ROW_BYTES + c * 16, 16);
          cp_async16(dv + r * L::ROW_BYTES + c * 16, vb + row * L::ROW_BYTES + c * 16, 16);
        }
      }
      if constexpr (QUANT) {
        for (int idx = tid; idx < NTOK * TILE; idx += WD_THREADS) {
          const int tok = idx / TILE, r = idx % TILE, v = v0 + r;
          if (v < n_rows) {
            const size_t si = scale_index(kvh, page_of(v / SR), v % SR + tok * SR,
                                          a.P, ps);
            cp_async4(dsc + (tok * TILE + r) * 4, a.k_scales + si);
            cp_async4(dsc + ((NTOK + tok) * TILE + r) * 4, a.v_scales + si);
          }
        }
      }
      cp_async_arrive(full(s));
    }
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full(s), bulk ? 1 : WD_THREADS);
      sm90::mbar_init(empty(s), WD_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < n_ids) s_pid[tid] = id0;
  if (tid + WD_THREADS < n_ids) s_pid[tid + WD_THREADS] = id1;
  float* s_q = reinterpret_cast<float*>(wsmem + L::Q_OFF);  // [head][column]
  for (int i = tid; i < HB * D; i += WD_THREADS) {
    float x = 0.f;
    if (i < nh * D) {
      x = load_as_float(a.q, out_row * D + i, dt);
      if (QUANT) x = round_to(x * a.sm_scale, dt);
    }
    s_q[i] = x;
  }
  __syncthreads();  // barriers initialised, page ids and q staged
  for (int t = 0; t < min(STAGES - 1, n_tiles); ++t) issue(t);

  // q of the CTA's heads in the lane's columns, from shared memory;
  // quantized pools: pre-scaled in q's dtype, and on the integer route as
  // int8 words (element 4 w + j in byte j of word w) with their scale.
  float qf[HB][INT ? 1 : E];
  uint32_t q8[HB][INT ? NW : 1];
  float qc[INT ? HB : 1];
#pragma unroll
  for (int h = 0; h < HB; ++h) {
    float x[E];
    float qa = 0.f;
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 v4 = *reinterpret_cast<const float4*>(s_q + h * D + wd_col<KIND, NB>(lane, e));
      x[e] = v4.x;
      x[e + 1] = v4.y;
      x[e + 2] = v4.z;
      x[e + 3] = v4.w;
      qa = fmaxf(fmaxf(qa, fmaxf(fabsf(v4.x), fabsf(v4.y))), fmaxf(fabsf(v4.z), fabsf(v4.w)));
    }
    if constexpr (INT) {
#pragma unroll
      for (int off = 16; off > 0; off /= 2) qa = fmaxf(qa, __shfl_xor_sync(0xffffffffu, qa, off));
      const float inv = qa > 0.f ? 127.f / qa : 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          word |= (uint32_t(__float2int_rn(x[4 * w + j] * inv)) & 0xFFu) << (8 * j);
        q8[h][w] = word;
      }
      qc[h] = qa * (1.0f / 127.0f);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qf[h][e] = x[e];
    }
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
    if (t + STAGES - 1 < n_tiles) issue(t + STAGES - 1);
    const int s = t % STAGES;
    sm90::mbar_wait(full(s), (t / STAGES) & 1);
    const unsigned char* tk = wsmem + s * L::TILE_BYTES;
    const unsigned char* tv = tk + L::V_OFF;
    const float* tsc = reinterpret_cast<const float*>(wsmem + L::SC_OFF + s * L::SC_BYTES);

    // The partial dots of the warp's rows (row warp + 8 i of the tile),
    // every token and head: value n = (i NTOK + tok) HB + h.
    Dot part[N];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      uint32_t kw[NW];
      wd_read_row<KIND, NB>(tk + (warp + WD_WARPS * i) * L::ROW_BYTES, lane, kw);
#pragma unroll
      for (int tok = 0; tok < NTOK; ++tok) {
        if constexpr (INT) {
#pragma unroll
          for (int h = 0; h < HB; ++h) {
            int d = 0;
#pragma unroll
            for (int w = 0; w < NW; ++w) d = __dp4a(int(q8[h][w]), int(s8x4(KIND, kw[w], tok)), d);
            part[(i * NTOK + tok) * HB + h] = d;
          }
        } else {  // a word at a time (fewer values live), two FMA chains a head
          float dot[HB][2] = {};
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            float f[VPW];
            row_values<KIND>(*reinterpret_cast<const uint32_t(*)[1]>(&kw[w]), 0, f);
#pragma unroll
            for (int h = 0; h < HB; ++h)
#pragma unroll
              for (int j = 0; j < VPW; ++j)
                dot[h][(w * VPW + j) & 1] = fmaf(qf[h][w * VPW + j], f[j], dot[h][(w * VPW + j) & 1]);
          }
#pragma unroll
          for (int h = 0; h < HB; ++h) part[(i * NTOK + tok) * HB + h] = dot[h][0] + dot[h][1];
        }
      }
    }
    // Summed over the warp at once; lane l holds value l >> (5 - LOG_N),
    // makes that one score (the scales, the softcap, ALiBi's bias, -inf
    // past the split's keys), and every lane then takes all N.
    float own;
    {
      const Dot dot = spread_sum<N>(part, lane);
      const int n = lane >> (5 - LOG_N);
      const int i = n / (NTOK * HB), tok = (n / HB) % NTOK, h = n % HB;
      const int r = warp + WD_WARPS * i, v = t * TILE + r;
      // the token's position: stored row v of the split (an int4 row's
      // high nibble SR tokens on)
      const int pos = NTOK == 2 ? (p_lo + v / SR) * ps + v % SR + tok * SR : p_lo * ps + v;
      const float ks = QUANT ? tsc[tok * TILE + r] : 1.f;
      float x;
      if constexpr (INT) {
        float qch = qc[0];
#pragma unroll
        for (int j = 1; j < HB; ++j) qch = h == j ? qc[j] : qch;
        x = float(dot) * qch * ks;
      } else {
        x = QUANT ? dot * ks : dot * a.sm_scale;
      }
      if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
      if (a.slopes != nullptr && h < nh)  // ALiBi's bias, the head's slope
        x -= __ldg(a.slopes + kvh * G + hg * HB + h) * float(len - 1 - pos);
      own = v < n_rows && pos < len ? x : -INFINITY;  // the tile's rows
    }
    float sc[R][NTOK][HB];
#pragma unroll
    for (int n = 0; n < N; ++n)
      sc[n / (NTOK * HB)][(n / HB) % NTOK][n % HB] = __shfl_sync(0xffffffffu, own, n << (5 - LOG_N));
    // The warp's running max over the tile's rows; O and the row sum rescaled.
#pragma unroll
    for (int h = 0; h < HB; ++h) {
      float mt = m[h];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int tok = 0; tok < NTOK; ++tok) mt = fmaxf(mt, sc[i][tok][h]);
      if (mt > m[h]) {
        const float alpha = sm90::exp2_ftz((m[h] - mt) * kLog2e);  // 0 while the warp saw nothing
        l[h] *= alpha;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[h][e] *= alpha;
        m[h] = mt;
      }
    }
    // P V over the rows with a key (a finite score).  Quantized pools: the
    // row sum takes P, the product P * v_scale rounded to q's dtype.
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (sc[i][0][0] == -INFINITY) continue;
      const int r = warp + WD_WARPS * i;
      uint32_t vw[NW];
      wd_read_row<KIND, NB>(tv + r * L::ROW_BYTES, lane, vw);
#pragma unroll
      for (int tok = 0; tok < NTOK; ++tok) {
        if (tok > 0 && sc[i][tok][0] == -INFINITY) continue;
        const float vs = QUANT ? tsc[(NTOK + tok) * TILE + r] : 1.f;
        float pv[HB];
#pragma unroll
        for (int h = 0; h < HB; ++h) {
          const float pe = sm90::exp2_ftz((sc[i][tok][h] - m[h]) * kLog2e);
          l[h] += pe;
          pv[h] = QUANT ? round_to(pe * vs, dt) : pe;
        }
#pragma unroll
        for (int w = 0; w < NW; ++w) {  // a word at a time
          float f[VPW];
          row_values<KIND>(*reinterpret_cast<const uint32_t(*)[1]>(&vw[w]), tok, f);
#pragma unroll
          for (int h = 0; h < HB; ++h)
#pragma unroll
            for (int j = 0; j < VPW; ++j)
              acc[h][w * VPW + j] = fmaf(pv[h], f[j], acc[h][w * VPW + j]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty(s));  // the warp is done with stage s
  }

  // Merge the warps' states in warp order: the CTA's max, each warp's O and
  // row sum rescaled to it, then summed over the warps column by column.
  float* s_m = reinterpret_cast<float*>(wsmem + L::M_OFF);
  float* s_l = reinterpret_cast<float*>(wsmem + L::L_OFF);
  float* s_acc = reinterpret_cast<float*>(wsmem);  // [warp][head][D], over the stages
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < HB; ++h) s_m[warp * HB + h] = m[h];
  }
  __syncthreads();  // every warp is past its last tile
  float mx[HB];
#pragma unroll
  for (int h = 0; h < HB; ++h) {
    mx[h] = -INFINITY;
    for (int w = 0; w < WD_WARPS; ++w) mx[h] = fmaxf(mx[h], s_m[w * HB + h]);
    const float f = m[h] == -INFINITY ? 0.f : __expf(m[h] - mx[h]);
#pragma unroll
    for (int e = 0; e < E; ++e) s_acc[(warp * HB + h) * D + wd_col<KIND, NB>(lane, e)] = acc[h][e] * f;
    if (lane == 0) s_l[warp * HB + h] = l[h] * f;
  }
  __syncthreads();
  for (int i = tid; i < nh * D; i += WD_THREADS) {
    const int h = i / D, c = i % D;
    float sum_l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < WD_WARPS; ++w) {
      sum_l += s_l[w * HB + h];
      o += s_acc[(w * HB + h) * D + c];
    }
    const bool seen = sum_l > 0.f;
    if (a.splits == 1) {
      store_as(a.o, out_row * D + i, dt, seen ? o / sum_l : 0.f);
      if (a.lse != nullptr && c == 0) a.lse[out_row + h] = seen ? mx[h] + logf(sum_l) : kMaskValue;
    } else {
      a.part_o[part_row * D + i] = seen ? o / sum_l : 0.f;
      if (c == 0) a.part_lse[part_row + h] = seen ? mx[h] + logf(sum_l) : -INFINITY;
    }
  }
  if (a.splits > 1) merge();
}

template <int KIND, int NB>
int launch_wide_decode(const WideDecodeArgs& a) {
  using L = WdLayout<KIND, NB>;
  auto kernel = wide_decode_kernel<KIND, NB>;
  // Bulk copies take a tile of stored rows that lies inside one page, and
  // 16-byte aligned scales.
  const int stored = KIND == kI4 ? a.page_size / 2 : a.page_size;
  const bool aligned = !is_quantized(KIND) ||
                       (reinterpret_cast<uintptr_t>(a.k_scales) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(a.v_scales) % 16 == 0);
  const int bulk = stored % L::TILE == 0 && aligned;
  // the merge's weights, (splits + 1) x 2 floats, over the stages
  if ((size_t(a.splits) + 1) * WD_HEADS * 4 > L::SC_OFF) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(L::BYTES));
  if (err != cudaSuccess) return int(err);
  const int G = a.Hq / a.Hkv;
  dim3 grid(a.splits * ((G + WD_HEADS - 1) / WD_HEADS), a.Hkv, a.B);
  kernel<<<grid, WD_THREADS, L::BYTES, a.stream>>>(a, bulk);
  return int(cudaGetLastError());
}

// f(kind, 128-column blocks) (each an integral_constant) for the decode
// instance of (kv_kind, D); 0 for a pair no instance takes (the C entry
// refuses those first).
template <typename F>
int wide_decode_instance(int kv_kind, int D, F f) {
  auto width = [&](auto kind) -> int {
    switch (D) {
      case 384: return f(kind, std::integral_constant<int, 3>{});
      case 512: return f(kind, std::integral_constant<int, 4>{});
      case 640: return f(kind, std::integral_constant<int, 5>{});
      case 768: return f(kind, std::integral_constant<int, 6>{});
      case 896: return f(kind, std::integral_constant<int, 7>{});
      case 1024: return f(kind, std::integral_constant<int, 8>{});
      default: return 0;
    }
  };
  switch (kv_kind) {
    case kF32: return width(std::integral_constant<int, kF32>{});
    case kBF16: return width(std::integral_constant<int, kBF16>{});
    case kF16: return width(std::integral_constant<int, kF16>{});
    case kI8: return width(std::integral_constant<int, kI8>{});
    case kI4: return width(std::integral_constant<int, kI4>{});
    case kE4M3: return width(std::integral_constant<int, kE4M3>{});
    case kE5M2: return width(std::integral_constant<int, kE5M2>{});
    default: return 0;
  }
}

// Dynamic shared memory of the decode instance for (kv_kind, D), in
// bytes; 0 for a pair no instance takes.
inline int wide_decode_smem(int kv_kind, int D) {
  return wide_decode_instance(kv_kind, D, [](auto kind, auto nb) {
    return int(WdLayout<decltype(kind)::value, decltype(nb)::value>::BYTES);
  });
}


// Launches the column-chunked forward or verify over `grid`.
template <bool PAGED>
int launch_wide_chunk(const WideArgs& a, dim3 grid) {
  auto kernel = wide_fwd_chunk_kernel<PAGED>;
  constexpr size_t smem = WideLayout::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, WTHREADS, smem, a.stream>>>(a);
  return int(cudaGetLastError());
}

// Dynamic shared memory of the wide_wgmma kernel at head dim D (with
// segment ids `seg`, or verify `paged`), in bytes; 0 for another D.
inline int wide_wgmma_smem(int D, bool seg, bool paged) {
  auto bytes = [&](auto layout) {
    using L = decltype(layout);
    return int(L::bytes(L::STAGES, seg, paged));
  };
  switch (D) {
    case 384: case 768: return bytes(sm90::WgLayout<2, 3>{});
    case 512: case 1024: return bytes(sm90::WgLayout<2, 4>{});
    case 640: case 896: return bytes(sm90::WgLayout<1, 2>{});
    default: return 0;
  }
}

// Launches the wide_wgmma kernel of one cut over `grid` clusters (x counts
// clusters), each of NC CTAs along x; returns the launch's error.
template <typename T, bool PAGED, int NC, int NW, int C>
int launch_wgmma_cut(const WideArgs& a, const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                     const CUtensorMap& tm_v, int tma, dim3 grid) {
  using L = sm90::WgLayout<NW, C>;
  static_assert(sm90::wide_cut(64 * NC * NW * C).nc == NC, "the cut of this head dim");
  auto kernel = sm90::wide_wgmma_kernel<T, PAGED, NC, NW, C>;
  const size_t smem = L::bytes(L::STAGES, !PAGED && a.md.q_seg != nullptr, PAGED);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(grid.x * NC, grid.y, grid.z);
  cfg.blockDim = dim3(128 * (NW + 1));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute cluster{};
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = NC;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = NC > 1 ? 1 : 0;
  int tma_flag = tma;
  void* args[] = {const_cast<CUtensorMap*>(&tm_q), const_cast<CUtensorMap*>(&tm_k),
                  const_cast<CUtensorMap*>(&tm_v), const_cast<WideArgs*>(&a), &tma_flag};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// The wide_wgmma kernel of a.D's cut (sm90::wide_cut) over `grid` clusters.
template <typename T, bool PAGED>
int launch_wide_wgmma(const WideArgs& a, const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                      const CUtensorMap& tm_v, int tma, dim3 grid) {
  switch (a.D) {
    case 384: return launch_wgmma_cut<T, PAGED, 1, 2, 3>(a, tm_q, tm_k, tm_v, tma, grid);
    case 512: return launch_wgmma_cut<T, PAGED, 1, 2, 4>(a, tm_q, tm_k, tm_v, tma, grid);
    case 640: return launch_wgmma_cut<T, PAGED, 5, 1, 2>(a, tm_q, tm_k, tm_v, tma, grid);
    case 768: return launch_wgmma_cut<T, PAGED, 2, 2, 3>(a, tm_q, tm_k, tm_v, tma, grid);
    case 896: return launch_wgmma_cut<T, PAGED, 7, 1, 2>(a, tm_q, tm_k, tm_v, tma, grid);
    case 1024: return launch_wgmma_cut<T, PAGED, 2, 2, 4>(a, tm_q, tm_k, tm_v, tma, grid);
    default: return int(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// Paged decode above the cuts ("wide_chunk")
// ---------------------------------------------------------------------------

// wide_decode_kernel keeps a lane's columns of q and of O in registers,
// sized by its 128-column blocks, to 1024 columns.  Above that this kernel
// takes every width with the same arithmetic (paged_decode.cuh's: value
// pools in fp32 with P unrounded; quantized pools q pre-scaled in its dtype,
// int8 / int4 integer scores by __dp4a against per-row int8 q, fp8 an fp32
// dot, K scales on S, V scales on P rounded to q's dtype), so that one plain
// version holds it at every width, and reads each live K and V row once:
//  * One CTA of 8 warps per (key split, kv head x pair of its q heads,
//    sequence) walks its keys in tiles of 64.  Scores: q of both heads is
//    staged in shared memory 1024 columns at a time (pre-scaled, or as int8
//    words), each warp takes 8 keys of the tile and its lanes 4 columns of
//    each 128, reading K rows coalesced from device memory; one shuffle
//    tree a (key, head) then makes the score.
//  * Softmax: one warp a head updates the running max and sum over the
//    tile and writes P (times the V scale, rounded, where quantized).
//  * O: the split's fp32 partial row in device memory (the call's split
//    scratch) is the accumulator: each thread owns 4 columns of each 1024,
//    rescales them once a tile and adds the tile's 64 V rows, read
//    coalesced.  That costs 8 bytes of (mostly L2) traffic a column a tile
//    against the tile's 64 rows of K and V, and no width outgrows it.
//  * Splits merge in wide_combine_kernel, a second launch (one split: the
//    last pass writes O and lse itself).
constexpr int WDC_THREADS = 256;  // 8 warps
constexpr int WDC_KEYS = 64;      // keys a tile
constexpr int WDC_QCOLS = 1024;   // columns of q staged at once

// Dynamic shared memory of the chunked decode, in bytes from an aligned
// base, whatever the head dim or pool kind (geometry.py
// wide_chunk_decode_smem_bytes): q of two heads over WDC_QCOLS columns
// (fp32, or int8 words in the first quarter), the tile's scores and P of
// two heads, its keys' stored-row offsets, int4 halves and K / V scales,
// and each head's running max, row sum and rescale factor.
struct WdcLayout {
  static constexpr size_t Q_OFF = 0;
  static constexpr size_t S_OFF = Q_OFF + size_t(WD_HEADS) * WDC_QCOLS * 4;
  static constexpr size_t P_OFF = S_OFF + WD_HEADS * WDC_KEYS * 4;
  static constexpr size_t ROW_OFF = P_OFF + WD_HEADS * WDC_KEYS * 4;
  static constexpr size_t HI_OFF = ROW_OFF + WDC_KEYS * 8;
  static constexpr size_t KS_OFF = HI_OFF + WDC_KEYS * 4;
  static constexpr size_t VS_OFF = KS_OFF + WDC_KEYS * 4;
  static constexpr size_t ST_OFF = VS_OFF + WDC_KEYS * 4;
  static constexpr size_t BYTES = ST_OFF + 3 * WD_HEADS * 4;
};

// Four elements (columns c .. c + 3) of a stored row of KIND at element `at`
// of `base`, as fp32 (exact).
template <int KIND>
__device__ __forceinline__ void values4(const void* base, size_t at, int hi, float (&f)[4]) {
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
    word_values(KIND, *reinterpret_cast<const uint32_t*>(static_cast<const uint8_t*>(base) + at),
                hi, f);
  }
}

template <int KIND>
__global__ void __launch_bounds__(WDC_THREADS)
wide_decode_chunk_kernel(const WideDecodeArgs a, const int D) {
  constexpr bool QUANT = is_quantized(KIND);
  constexpr bool INT = KIND == kI8 || KIND == kI4;
  constexpr int WARPS = WDC_THREADS / 32;
  using L = WdcLayout;
  extern __shared__ __align__(16) unsigned char wdc_smem[];
  float* sQ = reinterpret_cast<float*>(wdc_smem + L::Q_OFF);  // [WD_HEADS][WDC_QCOLS]
  uint32_t* sQ8 = reinterpret_cast<uint32_t*>(sQ);              // [WD_HEADS][WDC_QCOLS / 4]
  float* sS = reinterpret_cast<float*>(wdc_smem + L::S_OFF);  // [WD_HEADS][WDC_KEYS]
  float* sP = reinterpret_cast<float*>(wdc_smem + L::P_OFF);
  long long* sRow = reinterpret_cast<long long*>(wdc_smem + L::ROW_OFF);
  int* sHi = reinterpret_cast<int*>(wdc_smem + L::HI_OFF);
  float* sKs = reinterpret_cast<float*>(wdc_smem + L::KS_OFF);
  float* sVs = reinterpret_cast<float*>(wdc_smem + L::VS_OFF);
  float* sM = reinterpret_cast<float*>(wdc_smem + L::ST_OFF);
  float* sL = sM + WD_HEADS;
  float* sAlpha = sL + WD_HEADS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = a.Hq / a.Hkv, ngroups = (G + WD_HEADS - 1) / WD_HEADS;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / ngroups, hg = blockIdx.y % ngroups;
  const int nh = min(WD_HEADS, G - WD_HEADS * hg);
  const int h0 = kvh * G + WD_HEADS * hg;
  const int len = a.lengths[b];
  const int max_len = a.pages_per_seq * a.page_size;
  const int alen = min(max(len, 0), max_len);
  const int lo = split * a.pages_per_split * a.page_size;
  const int hi_pos = min(lo + a.pages_per_split * a.page_size, alen);
  const int dt = a.q_dtype;
  const size_t rows = size_t(a.B) * a.Hq;

  // q element c of head hh as the score route takes it: pre-scaled in q's
  // dtype where the pool is quantized.
  auto q_at = [&](int hh, int c) {
    const float x = load_as_float(a.q, (size_t(b) * a.Hq + h0 + hh) * D + c, dt);
    return QUANT ? round_to(x * a.sm_scale, dt) : x;
  };
  // int8 / int4: each head's q row quantized as round(q 127 / max|q|).
  float inv[WD_HEADS] = {0.f, 0.f}, qscale[WD_HEADS] = {1.f, 1.f};
  if constexpr (INT) {
    float qa[WD_HEADS] = {0.f, 0.f};
    for (int c = tid; c < D; c += WDC_THREADS)
#pragma unroll
      for (int hh = 0; hh < WD_HEADS; ++hh)
        if (hh < nh) qa[hh] = fmaxf(qa[hh], fabsf(q_at(hh, c)));
#pragma unroll
    for (int hh = 0; hh < WD_HEADS; ++hh) {
#pragma unroll
      for (int o2 = 16; o2 > 0; o2 >>= 1)
        qa[hh] = fmaxf(qa[hh], __shfl_xor_sync(0xffffffffu, qa[hh], o2));
      if (lane == 0) sS[hh * WDC_KEYS + warp] = qa[hh];
    }
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < WD_HEADS; ++hh) {
      float m = 0.f;
      for (int w = 0; w < WARPS; ++w) m = fmaxf(m, sS[hh * WDC_KEYS + w]);
      inv[hh] = m > 0.f ? 127.f / m : 0.f;
      qscale[hh] = m * (1.f / 127.f);
    }
  }
  float m_run = -INFINITY, l_run = 0.f;  // warp hh's, for head hh
  float slope = 0.f;
  if (warp < nh && a.slopes != nullptr) slope = a.slopes[h0 + warp];
  // The accumulator of head hh: the split's fp32 partial row.
  auto acc_row = [&](int hh) {
    return a.part_o + (size_t(split) * rows + size_t(b) * a.Hq + h0 + hh) * D;
  };

  for (int n0 = lo; n0 < hi_pos; n0 += WDC_KEYS) {
    const int cnt = min(WDC_KEYS, hi_pos - n0);
    __syncthreads();  // the previous tile is done with every buffer
    if (tid < cnt) {
      const int pos = n0 + tid;
      const int page = a.page_table[size_t(b) * a.pages_per_seq + pos / a.page_size];
      const int off = pos % a.page_size;
      const TokenAddr ta = token_addr(KIND, kvh, page, off, a.P, a.page_size, D);
      sRow[tid] = (long long)ta.row;
      sHi[tid] = ta.hi;
      if constexpr (QUANT) {
        const size_t si = scale_index(kvh, page, off, a.P, a.page_size);
        sKs[tid] = a.k_scales[si];
        sVs[tid] = a.v_scales[si];
      }
    }
    // Scores: each warp's keys warp + 8 kk, summed over the head dim a
    // staged slice of q at a time, in column order.
    float fdot[WDC_KEYS / WARPS][WD_HEADS];
    int idot[WDC_KEYS / WARPS][WD_HEADS];
#pragma unroll
    for (int kk = 0; kk < WDC_KEYS / WARPS; ++kk)
#pragma unroll
      for (int hh = 0; hh < WD_HEADS; ++hh) {
        fdot[kk][hh] = 0.f;
        idot[kk][hh] = 0;
      }
    for (int c0 = 0; c0 < D; c0 += WDC_QCOLS) {
      const int qc = min(WDC_QCOLS, D - c0);
      __syncthreads();  // the previous slice of q is read (and the rows are staged)
      if constexpr (INT) {
        for (int i = tid; i < WD_HEADS * (qc / 4); i += WDC_THREADS) {
          const int hh = i / (qc / 4), w4 = i % (qc / 4);
          uint32_t w = 0;
          if (hh < nh) {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              w |= (uint32_t(int(rintf(q_at(hh, c0 + 4 * w4 + c) * inv[hh]))) & 0xFFu) << (8 * c);
          }
          sQ8[hh * (WDC_QCOLS / 4) + w4] = w;
        }
      } else {
        for (int i = tid; i < WD_HEADS * qc; i += WDC_THREADS) {
          const int hh = i / qc, c = i % qc;
          sQ[hh * WDC_QCOLS + c] = hh < nh ? q_at(hh, c0 + c) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < WDC_KEYS / WARPS; ++kk) {
        const int k = warp + WARPS * kk;
        if (k >= cnt) continue;
        const size_t row = size_t(sRow[k]);
        const int hi = sHi[k];
#pragma unroll 4
        for (int cb = 4 * lane; cb < qc; cb += 128) {
          if constexpr (INT) {
            const uint32_t w = *reinterpret_cast<const uint32_t*>(
                static_cast<const uint8_t*>(a.k_pages) + row + c0 + cb);
            const int k8 = int(s8x4(KIND, w, hi));
#pragma unroll
            for (int hh = 0; hh < WD_HEADS; ++hh)
              idot[kk][hh] = __dp4a(int(sQ8[hh * (WDC_QCOLS / 4) + cb / 4]), k8, idot[kk][hh]);
          } else {
            float kf[4];
            values4<KIND>(a.k_pages, row + c0 + cb, hi, kf);
#pragma unroll
            for (int hh = 0; hh < WD_HEADS; ++hh) {
              const float4 qv = *reinterpret_cast<const float4*>(sQ + hh * WDC_QCOLS + cb);
              float d = fdot[kk][hh];
              d = fmaf(qv.x, kf[0], d);
              d = fmaf(qv.y, kf[1], d);
              d = fmaf(qv.z, kf[2], d);
              d = fmaf(qv.w, kf[3], d);
              fdot[kk][hh] = d;
            }
          }
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < WDC_KEYS / WARPS; ++kk) {
      const int k = warp + WARPS * kk;
#pragma unroll
      for (int hh = 0; hh < WD_HEADS; ++hh) {
        float x;
        if constexpr (INT) {
          int dot = idot[kk][hh];
#pragma unroll
          for (int o2 = 16; o2 > 0; o2 >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o2);
          x = float(dot) * qscale[hh];
        } else {
          float dot = fdot[kk][hh];
#pragma unroll
          for (int o2 = 16; o2 > 0; o2 >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o2);
          x = QUANT ? dot : dot * a.sm_scale;
        }
        if (lane == 0 && k < cnt) {
          if (QUANT) x *= sKs[k];
          if (a.softcap > 0.f)
            x = QUANT ? a.softcap * tanhf(x * (1.f / a.softcap)) : a.softcap * tanhf(x / a.softcap);
          sS[hh * WDC_KEYS + k] = x;  // ALiBi below, by the head's warp
        }
      }
    }
    __syncthreads();
    // Softmax over the tile: warp hh for head hh (every key of the split is
    // visible), P times the V scale rounded to q's dtype where quantized.
    if (warp < nh) {
      const int hh = warp;
      float x[2], mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = lane + 32 * i;
        x[i] = -INFINITY;
        if (k < cnt) {
          x[i] = sS[hh * WDC_KEYS + k];
          if (a.slopes != nullptr) x[i] -= slope * float(alen - 1 - (n0 + k));
        }
        mx = fmaxf(mx, x[i]);
      }
#pragma unroll
      for (int o2 = 16; o2 > 0; o2 >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      const float m_new = fmaxf(m_run, mx);
      const float alpha = expf(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = lane + 32 * i;
        const float p = k < cnt ? expf(x[i] - m_new) : 0.f;
        sum += p;
        sP[hh * WDC_KEYS + k] = QUANT ? round_to(p * (k < cnt ? sVs[k] : 0.f), dt) : p;
      }
#pragma unroll
      for (int o2 = 16; o2 > 0; o2 >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o2);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (lane == 0) sAlpha[hh] = alpha;
    }
    __syncthreads();
    // O += P V over the tile, 4 columns of each 1024 a thread.
    const bool first = n0 == lo;
    for (int c = 4 * tid; c < D; c += 4 * WDC_THREADS) {
      float acc[WD_HEADS][4];
#pragma unroll
      for (int hh = 0; hh < WD_HEADS; ++hh) {
        float4 o4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!first && hh < nh) o4 = *reinterpret_cast<const float4*>(acc_row(hh) + c);
        const float al = sAlpha[hh];
        acc[hh][0] = o4.x * al; acc[hh][1] = o4.y * al;
        acc[hh][2] = o4.z * al; acc[hh][3] = o4.w * al;
      }
#pragma unroll 4
      for (int k = 0; k < cnt; ++k) {
        float vf[4];
        values4<KIND>(a.v_pages, size_t(sRow[k]) + c, sHi[k], vf);
#pragma unroll
        for (int hh = 0; hh < WD_HEADS; ++hh) {
          const float p = sP[hh * WDC_KEYS + k];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[hh][e] = fmaf(p, vf[e], acc[hh][e]);
        }
      }
#pragma unroll
      for (int hh = 0; hh < WD_HEADS; ++hh)
        if (hh < nh)
          *reinterpret_cast<float4*>(acc_row(hh) + c) =
              make_float4(acc[hh][0], acc[hh][1], acc[hh][2], acc[hh][3]);
    }
  }

  // O / l: into the partial (its lse -inf where the split saw no key), or
  // with one split straight into O and lse.
  if (warp < nh && lane == 0) {
    sM[warp] = m_run;
    sL[warp] = l_run;
  }
  __syncthreads();
  const bool split_out = a.splits > 1;
  for (int hh = 0; hh < nh; ++hh) {
    const float l = sL[hh], m = sM[hh];
    const float inv_l = l > 0.f ? 1.f / l : 0.f;
    const size_t r = size_t(b) * a.Hq + h0 + hh;
    float* acc = acc_row(hh);
    for (int c = 4 * tid; c < D; c += 4 * WDC_THREADS) {
      float4 o4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (l > 0.f) {
        o4 = *reinterpret_cast<const float4*>(acc + c);
        o4 = make_float4(o4.x * inv_l, o4.y * inv_l, o4.z * inv_l, o4.w * inv_l);
      }
      if (split_out) {
        *reinterpret_cast<float4*>(acc + c) = o4;
      } else {
        store_as(a.o, r * D + c, dt, o4.x);
        store_as(a.o, r * D + c + 1, dt, o4.y);
        store_as(a.o, r * D + c + 2, dt, o4.z);
        store_as(a.o, r * D + c + 3, dt, o4.w);
      }
    }
    if (tid == 0) {
      if (split_out) {
        a.part_lse[size_t(split) * rows + r] = l > 0.f ? m + logf(l) : -INFINITY;
      } else if (a.lse != nullptr) {
        a.lse[r] = l > 0.f ? m + logf(l) : kMaskValue;
      }
    }
  }
}

// The chunked decode of `kind` at head dim D over its grid, then (above one
// split) the merge; part_o / part_lse hold [splits, B Hq] partials (the
// accumulators even at one split).
template <int KIND>
int launch_wide_decode_chunk(const WideDecodeArgs& a, int D) {
  auto kernel = wide_decode_chunk_kernel<KIND>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(WdcLayout::BYTES));
  if (err != cudaSuccess) return int(err);
  const int G = a.Hq / a.Hkv;
  const dim3 grid(a.splits, a.Hkv * ((G + WD_HEADS - 1) / WD_HEADS), a.B);
  kernel<<<grid, WDC_THREADS, WdcLayout::BYTES, a.stream>>>(a, D);
  const int e = int(cudaGetLastError());
  if (e || a.splits == 1) return e;
  return launch_combine(a.part_o, a.part_lse, a.o, a.q_dtype, a.lse, a.B * a.Hq, a.splits, D,
                        a.stream);
}

}  // namespace
