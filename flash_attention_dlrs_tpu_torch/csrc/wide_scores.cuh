// Attention above head dim 1024 in bf16 / fp16 on Hopper (route
// "wide_scores"): the forward, both backward sweeps and paged multi-token
// verify, each as a score pass and a product pass, sm_90a.  Included by
// attn_fwd_scores.cu (the forward's passes), attn_bwd_scores.cu (the
// backward's) and paged_verify_wide.cu (verify's), which compile side by
// side.
//
// Replaces, above 1024 (every multiple of 128 the JAX package pads to):
//   flash_attention_dlrs_tpu/ops/fwd_kernel.py:197  _fwd_kernel       (the forward; with it
//   flash_attention_dlrs_tpu/ops/fwd_mid.py:211     _mid_kernel        the routes it carries:
//   flash_attention_dlrs_tpu/ops/fwd_mid.py:572     _mid_strip_kernel  fwd_mid, fwd_small)
//   flash_attention_dlrs_tpu/ops/fwd_small.py:69    _small_kernel
//   flash_attention_dlrs_tpu/ops/bwd_kernel.py:203  _bwd_dkv_kernel    (dK, dV; with dQ the
//   flash_attention_dlrs_tpu/ops/bwd_kernel.py:504  _bwd_dq_kernel     backward routes of
//   flash_attention_dlrs_tpu/ops/fwd_small.py:239   _small_bwd_kernel  fwd_small, bwd_fused
//   flash_attention_dlrs_tpu/ops/bwd_fused.py:45    _bwd_fused_kernel  and bwd_mid)
//   flash_attention_dlrs_tpu/ops/bwd_mid.py:76      _bwd_mid_kernel
//   flash_attention_dlrs_tpu/ops/decode.py:44       _decode_kernel     (its multi-token
//                                                                      verify mode)
// with their contracts and modes: causal bottom-right, GQA, ragged lengths,
// window, softcap, ALiBi (the true bias), attention dropout (common.cuh's
// mask, bit for bit), segment ids, and fp8 V in the forward.  D =
// rowsum(dO o O) is attn_bwd.cu's preprocess.
//
// Bound on this card by operations: 4 D flops a visible (row, key) pair in
// the forward and verify, 10 D in the backward (S, dP, dV, dK, dQ), on the
// tensor cores' 989 TFLOP/s.  The column-chunked mma.sync kernels these
// replace ran at ~1% of that (verify at 0.3%): each CTA owned one 128-column chunk of its output and
// recomputed S (and dP) over the whole head dim for it, D / 128 times the
// score work, through two cp.async stages and a CTA barrier a slice.  No
// cluster cut of the head dim reaches past 1024 (every CTA holds every
// owner's partial scores).  What this design does:
//  * A score pass computes S = Q K^T (and in the backward dP = dO V^T)
//    once for each (128 q rows, 128 keys) tile the mask lets through,
//    summed over the whole head dim in 64-column slices, in column order,
//    on wgmma (both operands K-major in shared memory, fp32 accumulate).
//    The slices come by TMA (3-D maps, so ragged tails read zeros) into a
//    ring of stages with full / empty mbarriers, filled by one thread of a
//    producer warpgroup; two consumer warpgroups own 64 q rows each.
//  * The forward's score pass applies the scale, the softcap, the ALiBi
//    bias and the masks (attn_fwd_plain's order) and stores S in base-2
//    units, fp32 (a 16-bit S would lose the exponent's bits), with each
//    row's max and sum of exp2 over the tile.  The backward's forms P from
//    the forward's lse, the dropout mask M, dS = P o (dP o M - D) (times
//    the softcap's derivative) and stores P o M and dS rounded to T: what
//    the products read.
//  * A product pass (one kernel, templated on what it computes) owns 128
//    rows and a 256-column chunk of its output, and multiplies a scratch
//    tile by a chunk of an operand, reduced over keys or rows, streamed 64
//    rows a stage: O = P V (P = exp2(S - lse) formed as the A fragments
//    from the stored S; lse merged from the tiles' max and sum in key-tile
//    order, so it is the same bits on every run), dQ = dS K (A K-major),
//    dV = (P o M)^T dO and dK = dS^T Q (A read MN-major).  No online
//    rescale: the lse is known.
//  * The passes talk through scratch in device memory that the caller
//    allocates from PyTorch's allocator (ops/wide_scores.py): dense rows of
//    the call's q tiles [tiles x 128, keys padded to 128] with only the
//    visible tiles written and read.  A call whose scratch passes the cap
//    runs in waves of consecutive (batch x head, q tile) tiles; dK and dV
//    then carry an fp32 sum across waves in wave order, so a call in
//    several waves is bitwise the call in one.
//  * Every output element has one owner, every sum runs in a fixed order
//    (the head dim's slices; key tiles; q heads of a GQA group, then q
//    tiles), and nothing uses atomics: a repeat is bitwise the same.
// Neither kernel's shared memory grows with D, so one build serves every
// multiple of 128 above 1024 (a 128-column odd chunk reads zeros past D).
//
// Paged verify runs the forward's two passes over the T x G (token, q
// head) rows of each (sequence, kv head), row r = t G + g as the TPU kernel
// folds them, q scaled by sm_scale in its own dtype (the wrapper folds and
// scales it, as the JAX wrapper does), keys gathered through the page
// table: value pools of q's dtype by TMA boxes of a page where a stage's
// keys all hold data, else row by row with zeros past them; quantized pools
// (int8, int4, e4m3, e5m2) converted exactly and unscaled to q's dtype by
// the producer warpgroup, the K scales applied to S, the V scales to P
// before it is rounded.  The score pass applies paged_verify_plain's
// softcap, ALiBi bias -m (q_pos - col) and each row's horizon; key tiles
// past every row's horizon are never computed, stored or read.  The keys
// may be cut statically into splits of whole key tiles, each product CTA
// writing its split's fp32 partial normalized over the split's keys with
// their lse, merged in split order by wide.cuh's wide_combine_kernel.

#pragma once

#include "paged.cuh"
#include "sm90.cuh"

namespace {
namespace ws {

using namespace sm90;

constexpr int BM = 128;    // q rows of a score tile and of a product CTA (two owners of 64)
constexpr int BN = 128;    // keys of a score tile; keys of a dK/dV product CTA
constexpr int SLICE = 64;  // head-dim columns of a score-pass stage (a 128-byte row)
constexpr int ROWS = 64;   // keys (O, dQ) or q rows (dK, dV) of a product stage
constexpr int CW = 256;    // output columns of a product CTA
constexpr int WS_THREADS = 384;  // a producer warpgroup and two consumer warpgroups
// setmaxnreg within the 384 x 168 registers a CTA launches with
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= WS_THREADS * LAUNCH_REGS,
              "the register split exceeds the CTA's registers");

// Route code of ops/fwd_kernel.py ROUTE_CODES["wide_scores"].
constexpr int kRouteWideScores = 6;
// What a product pass computes.
constexpr int kProductO = 0, kProductDq = 1, kProductDkv = 2;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Whether D is a head dim of this route: a multiple of 128 above 1024.
__host__ __device__ constexpr bool scores_head_dim(int D) { return D > 1024 && D % 128 == 0; }

// The score passes' stages: each holds OPS tiles of 128 rows x 64 columns
// (128-byte swizzled rows, 16 KB): Q, K and in the backward dO, V.  Then the
// tile's kv segment ids and the full / empty barriers, and 1024 bytes of
// alignment (geometry.py wide_scores_smem_bytes).
template <bool BWD>
struct ScoreLayout {
  static constexpr int OPS = BWD ? 4 : 2;
  static constexpr uint32_t TILE = 128 * 128;
  static constexpr uint32_t STAGE = OPS * TILE;
  static constexpr int STAGES = BWD ? 3 : 4;
  static constexpr uint32_t IDS_OFF = STAGES * STAGE;
  static constexpr uint32_t BAR_OFF = IDS_OFF + BN * 4;
  static constexpr size_t BYTES = size_t(BAR_OFF) + 8 * 2 * STAGES + 1024;
  static_assert(BYTES <= 232448, "a CTA has 227 KB of shared memory");
};

// A product pass's stages: the scratch tile A (O: fp32 S of 128 rows x 64
// keys as two 32-key boxes; dQ: dS of 128 rows x 64 keys; dK / dV: P o M or
// dS of 64 q rows x 128 keys as two 64-key boxes), then the operand chunk B
// (64 rows x 256 columns as four 64-column chunks of 8 KB), each 128-byte
// swizzled; then the barriers and 1024 bytes of alignment.
template <int KIND>
struct ProductLayout {
  static constexpr uint32_t A_BYTES = KIND == kProductO ? BM * ROWS * 4 : BM * ROWS * 2;
  static constexpr uint32_t B_BYTES = ROWS * CW * 2;
  static constexpr uint32_t STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = KIND == kProductO ? 3 : 4;
  static constexpr uint32_t BAR_OFF = STAGES * STAGE;
  static constexpr size_t BYTES = size_t(BAR_OFF) + 8 * 2 * STAGES + 1024;
  static_assert(BYTES <= 232448, "a CTA has 227 KB of shared memory");
};

struct WsArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;  // the backward score pass's rows
  void* o;                   // the forward product's O and lse
  float* lse_out;
  void *dq, *dk, *dv;
  float *dk_acc, *dv_acc;  // dK / dV's fp32 sums across waves (null: one wave)
  float* s;                // forward scratch: S, [tiles x 128][keys padded]
  float2* stats;           // each row's (max, sum of exp2) of each key tile
  void *p, *ds;            // backward scratch: P o M and dS in T
  int v_kind;              // common.cuh kVSame / kVE4M3 / kVE5M2
  int B, Hq, Hkv, Nq, Nkv, D;
  float sm_scale;
  int causal, window;
  float softcap;
  Mods md;
  int f0, f1;  // the wave: tiles f = (b Hq + h) n_qt + q tile in [f0, f1)
  cudaStream_t stream;
};

// The head dim's 64-column slices a score pass sums, in column order.
__device__ __forceinline__ int head_slices(int D) {
  return D / SLICE;  // every slice of the head dim, summed in order
}

// Calls fn(i, n0) for each 64-key stage of a product that streams keys (O,
// dQ): both halves of every key tile the q tile sees, in key order, up to
// the last key.
template <typename F>
__device__ __forceinline__ void for_key_stages(const TileRange& tr, int Nkv, F&& fn) {
  int i = 0;
  for (int kt = tr.lo; kt < tr.hi; ++kt) {  // every key tile the q tile sees, in order
    for (int n0 = kt * BN; n0 < min(kt * BN + BN, Nkv); n0 += ROWS) fn(i++, n0);
  }
}

// Calls fn(i, f, r0) for each 64-row stage of the dK / dV product of key
// tile kt: the tiles f of the wave in [f_lo, f_hi) (the q heads of the GQA
// group in order, each q tile in order) whose scores the mask lets
// through, both halves of each up to the last row.
template <typename F>
__device__ __forceinline__ void for_row_stages(int f_lo, int f_hi, int n_qt, int kt,
                                               const WsArgs& a, F&& fn) {
  int i = 0;
  for (int f = f_lo; f < f_hi; ++f) {
    const int qt = f % n_qt;
    const TileRange tr = kv_tiles<BM, BN>(qt * BM, a.Nq, a.Nkv, a.causal, a.window);
    if (kt < tr.lo || kt >= tr.hi) continue;
    for (int r0 = qt * BM; r0 < min(qt * BM + BM, a.Nq); r0 += ROWS) fn(i++, f, r0);
  }
}

__device__ __forceinline__ void release(uint32_t bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// D (+)= A B, m64n128k16, fp32 accumulate, both operands in shared memory,
// B read MN-major; A K-major (TA 0: dQ's dS) or MN-major (TA 1: dK's dS^T,
// dV's (P o M)^T).
template <typename T, int TA>
struct WsSS {
  static __device__ __forceinline__ void run(float* d, uint64_t da, uint64_t db);
};

#define FA_WS_SS(TYPE, PTX, TA)                                                            \
  template <>                                                                             \
  __device__ __forceinline__ void WsSS<TYPE, TA>::run(float* d, uint64_t da, uint64_t db) { \
    asm volatile(                                                                         \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                      \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTX "." PTX " {"                   \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"   \
        "}, %64, %65, p, 1, 1, " #TA ", 1;\n}\n"                                          \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),         \
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),       \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),   \
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),   \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),   \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),   \
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),   \
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),   \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),   \
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),   \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                              \
        : "l"(da), "l"(db), "r"(1));                                                      \
  }
FA_WS_SS(__nv_bfloat16, "bf16", 0)
FA_WS_SS(__nv_bfloat16, "bf16", 1)
FA_WS_SS(__half, "f16", 0)
FA_WS_SS(__half, "f16", 1)
#undef FA_WS_SS

// Zeros in the B chunks past D of every stage (a 128-column odd chunk:
// those chunks are never loaded, and the products then add 0 there).
template <typename L>
__device__ __forceinline__ void zero_odd_chunks(unsigned char* smem, int loaded) {
  for (int c = loaded; c < CW / 64; ++c)
    for (int s = 0; s < L::STAGES; ++s)
      for (int x = threadIdx.x; x < 8192 / 16; x += blockDim.x)
        *reinterpret_cast<uint4*>(smem + s * L::STAGE + L::A_BYTES + c * 8192 + 16 * x) =
            make_uint4(0, 0, 0, 0);
  fence_proxy_async();  // read by wgmma
}

// ---------------------------------------------------------------------------
// The score passes
// ---------------------------------------------------------------------------

// The forward's score pass: one CTA per (tile f of the wave, key tile kt).
// S of the tile over the whole head dim, then scaled, softcapped, biased and
// masked into base-2 units; stores S and each row's (max, sum of exp2) of
// the tile.  A tile the mask hides returns at once: it is never computed,
// stored or read.
template <typename T>
__global__ void __launch_bounds__(WS_THREADS, 1)
ws_fwd_scores_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k, const WsArgs a) {
  using L = ScoreLayout<false>;
  const int n_qt = cdiv(a.Nq, BM), n_kt = cdiv(a.Nkv, BN);
  const int f = a.f0 + blockIdx.x, kt = blockIdx.y;
  const int bh = f / n_qt, qt = f % n_qt, b = bh / a.Hq, h = bh % a.Hq;
  const int m0 = qt * BM, n0 = kt * BN;
  const TileRange tr = kv_tiles<BM, BN>(m0, a.Nq, a.Nkv, a.causal, a.window);
  if (kt < tr.lo || kt >= tr.hi) return;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle atom
  unsigned char* const smem = smem_raw + (base - smem_u32(smem_raw));
  int* const kv_ids = reinterpret_cast<int*>(smem + L::IDS_OFF);
  const uint32_t bars = base + L::BAR_OFF;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (L::STAGES + s); };
  const int n = head_slices(a.D);
  const bool seg = a.md.q_seg != nullptr;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (seg)
    for (int i = threadIdx.x; i < BN; i += blockDim.x)
      kv_ids[i] = seg_id(a.md.kv_seg, b, a.Nkv, n0 + i);
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      const int kv_bh = b * a.Hkv + h / (a.Hq / a.Hkv);
      for (int i = 0; i < n; ++i) {
        const int s = i % L::STAGES;
        mbar_wait(empty(s), ((i / L::STAGES) & 1) ^ 1);  // passes at once on the first lap
        const uint32_t st = base + s * L::STAGE;
        mbar_expect_tx(full(s), 2 * L::TILE);
        tma_load_3d(st, &tm_q, full(s), i * SLICE, m0, bh);
        tma_load_3d(st + L::TILE, &tm_k, full(s), i * SLICE, n0, kv_bh);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int w = threadIdx.x / 128 - 1, wt = threadIdx.x % 128;
  const int warp = wt / 32, lane = wt % 32, g = lane / 4, t = lane % 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  for (int i = 0; i < n; ++i) {
    const int s = i % L::STAGES;
    mbar_wait(full(s), (i / L::STAGES) & 1);
    const uint32_t st = base + s * L::STAGE;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < SLICE / 16; ++ks)
      WgmmaSS<BN, T>::run(acc, smem_desc(st + w * 8192 + ks * 32, 16, 1024),
                          smem_desc(st + L::TILE + ks * 32, 16, 1024), 1);
    wgmma_commit();
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (i > 0) release(empty((i - 1) % L::STAGES));  // the previous slice's products are done
  }
  wgmma_wait_all();
  fence_regs(acc);

  // Scale, softcap, ALiBi and masks (the wide_wgmma forward's arithmetic),
  // into base-2 units; masked -inf.
  const int lr0 = 64 * w + 16 * warp + g;  // the thread's tile rows lr0, lr0 + 8
  const int q_off = a.Nkv - a.Nq;
  const float scale_log2 = a.sm_scale * kLog2e;
  const float slope = a.md.slopes != nullptr ? a.md.slopes[h] * kLog2e : 0.f;
  int qseg[2] = {0, 0};
  if (seg)
    for (int r = 0; r < 2; ++r) qseg[r] = seg_id(a.md.q_seg, b, a.Nq, m0 + lr0 + 8 * r);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + lr0 + 8 * (e >> 1), kc = 8 * j + 2 * t + (e & 1), col = n0 + kc;
      float x;
      if (a.softcap > 0.f) {
        x = acc[4 * j + e] * a.sm_scale;
        x = a.softcap * tanhf(x / a.softcap) * kLog2e;
      } else {
        x = acc[4 * j + e] * scale_log2;
      }
      if (a.md.slopes != nullptr) x -= slope * float(row + q_off - col);
      const bool vis = row < a.Nq && visible(row, col, a.Nq, a.Nkv, a.causal, a.window) &&
                       (!seg || qseg[e >> 1] == kv_ids[kc]);
      acc[4 * j + e] = vis ? x : -INFINITY;
    }
  }
  const size_t nkv_pad = size_t(n_kt) * BN;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) mx = fmaxf(mx, fmaxf(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_use = mx == -INFINITY ? 0.f : mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      sum += exp2_ftz(acc[4 * j + 2 * r] - m_use) + exp2_ftz(acc[4 * j + 2 * r + 1] - m_use);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const size_t lrow = size_t(f - a.f0) * BM + lr0 + 8 * r;
    if (t == 0) a.stats[lrow * n_kt + kt] = make_float2(mx, sum);
    float* dst = a.s + lrow * nkv_pad + n0 + 2 * t;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// The backward's score pass: one CTA per (tile f of the wave, key tile kt).
// S and dP of the tile over the whole head dim; P from the forward's lse
// (base 2), the dropout mask M, dS = P o (dP o M - D) times the softcap's
// derivative (attn_bwd_plain's arithmetic); stores P o M and dS rounded to
// T.  A tile the mask hides returns at once.
template <typename T>
__global__ void __launch_bounds__(WS_THREADS, 1)
ws_bwd_scores_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_v, const WsArgs a) {
  using L = ScoreLayout<true>;
  const int n_qt = cdiv(a.Nq, BM), n_kt = cdiv(a.Nkv, BN);
  const int f = a.f0 + blockIdx.x, kt = blockIdx.y;
  const int bh = f / n_qt, qt = f % n_qt, b = bh / a.Hq, h = bh % a.Hq;
  const int m0 = qt * BM, n0 = kt * BN;
  const TileRange tr = kv_tiles<BM, BN>(m0, a.Nq, a.Nkv, a.causal, a.window);
  if (kt < tr.lo || kt >= tr.hi) return;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - smem_u32(smem_raw));
  int* const kv_ids = reinterpret_cast<int*>(smem + L::IDS_OFF);
  const uint32_t bars = base + L::BAR_OFF;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (L::STAGES + s); };
  const int n = head_slices(a.D);
  const bool seg = a.md.q_seg != nullptr, drop = a.md.rate > 0.f;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (seg)
    for (int i = threadIdx.x; i < BN; i += blockDim.x)
      kv_ids[i] = seg_id(a.md.kv_seg, b, a.Nkv, n0 + i);
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      const int kv_bh = b * a.Hkv + h / (a.Hq / a.Hkv);
      for (int i = 0; i < n; ++i) {
        const int s = i % L::STAGES;
        mbar_wait(empty(s), ((i / L::STAGES) & 1) ^ 1);
        const uint32_t st = base + s * L::STAGE;
        mbar_expect_tx(full(s), 4 * L::TILE);
        tma_load_3d(st, &tm_q, full(s), i * SLICE, m0, bh);
        tma_load_3d(st + L::TILE, &tm_k, full(s), i * SLICE, n0, kv_bh);
        tma_load_3d(st + 2 * L::TILE, &tm_do, full(s), i * SLICE, m0, bh);
        tma_load_3d(st + 3 * L::TILE, &tm_v, full(s), i * SLICE, n0, kv_bh);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int w = threadIdx.x / 128 - 1, wt = threadIdx.x % 128;
  const int warp = wt / 32, lane = wt % 32, g = lane / 4, t = lane % 4;
  float sc[BN / 2], dp[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;
  fence_regs(sc);
  fence_regs(dp);
  for (int i = 0; i < n; ++i) {
    const int s = i % L::STAGES;
    mbar_wait(full(s), (i / L::STAGES) & 1);
    const uint32_t st = base + s * L::STAGE;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < SLICE / 16; ++ks)
      WgmmaSS<BN, T>::run(sc, smem_desc(st + w * 8192 + ks * 32, 16, 1024),
                          smem_desc(st + L::TILE + ks * 32, 16, 1024), 1);
#pragma unroll
    for (int ks = 0; ks < SLICE / 16; ++ks)
      WgmmaSS<BN, T>::run(dp, smem_desc(st + 2 * L::TILE + w * 8192 + ks * 32, 16, 1024),
                          smem_desc(st + 3 * L::TILE + ks * 32, 16, 1024), 1);
    wgmma_commit();
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (i > 0) release(empty((i - 1) % L::STAGES));
  }
  wgmma_wait_all();
  fence_regs(sc);
  fence_regs(dp);

  const int lr0 = 64 * w + 16 * warp + g;
  const int q_off = a.Nkv - a.Nq;
  const float slope = a.md.slopes != nullptr ? a.md.slopes[h] : 0.f;
  const uint32_t stream = drop ? dropout_stream(a.md.seed, b, h) : 0u;
  int qseg[2] = {0, 0};
  float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + lr0 + 8 * r;
    if (seg) qseg[r] = seg_id(a.md.q_seg, b, a.Nq, row);
    if (row < a.Nq) {
      lse2[r] = a.lse[size_t(bh) * a.Nq + row] * kLog2e;
      dlt[r] = a.delta[size_t(bh) * a.Nq + row];
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, row = m0 + lr0 + 8 * r, kc = 8 * j + 2 * t + (e & 1), col = n0 + kc;
      float xc = sc[4 * j + e] * a.sm_scale;
      if (a.softcap > 0.f) xc = a.softcap * tanhf(xc / a.softcap);
      float x = xc;
      if (a.md.slopes != nullptr) x -= slope * float(row + q_off - col);
      const bool vis = row < a.Nq && visible(row, col, a.Nq, a.Nkv, a.causal, a.window) &&
                       (!seg || qseg[r] == kv_ids[kc]);
      const float p = vis ? exp2_ftz(x * kLog2e - lse2[r]) : 0.f;
      const float keep = drop ? dropout_factor(stream, row, col, a.md) : 1.f;
      float ds = p * (dp[4 * j + e] * keep - dlt[r]);
      if (a.softcap > 0.f) {
        const float tt = xc / a.softcap;
        ds *= 1.f - tt * tt;
      }
      sc[4 * j + e] = p * keep;
      dp[4 * j + e] = ds;
    }
  }
  const size_t nkv_pad = size_t(n_kt) * BN;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t at = (size_t(f - a.f0) * BM + lr0 + 8 * r) * nkv_pad + n0 + 2 * t;
    T* pm = static_cast<T*>(a.p) + at;
    T* dsm = static_cast<T*>(a.ds) + at;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<uint32_t*>(pm + 8 * j) = Mma<T>::pack(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dsm + 8 * j) = Mma<T>::pack(dp[4 * j + 2 * r], dp[4 * j + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The product pass
// ---------------------------------------------------------------------------

// One 16-byte run of 16 fp8 V values (row r, bytes c16 of the CTA's
// columns) converted exactly to T into the B stage's swizzled chunks.
template <typename T>
__device__ __forceinline__ void store_fp8_chunk(unsigned char* stage_b, int r, int c16,
                                                const uint4& raw, int v_kind) {
  const uint32_t wds[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t p[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p[2 * j] = fp8x2_to<T>(wds[j], v_kind);
    p[2 * j + 1] = fp8x2_to<T>(wds[j] >> 16, v_kind);
  }
  const int c = c16 / 4, u = 2 * (c16 % 4);
  unsigned char* row = stage_b + c * 8192 + r * 128;
  *reinterpret_cast<uint4*>(row + ((u ^ (r & 7)) << 4)) = make_uint4(p[0], p[1], p[2], p[3]);
  *reinterpret_cast<uint4*>(row + (((u + 1) ^ (r & 7)) << 4)) = make_uint4(p[4], p[5], p[6], p[7]);
}

// The product pass, KIND one of:
//  kProductO    one CTA per (tile f of the wave, 256-column chunk): O =
//               P V over the key tiles the q tile sees, P = exp2(S - lse)
//               (dropped), and lse from the key tiles' (max, sum) merged in
//               key-tile order (A from registers, V by TMA or, fp8,
//               converted by the producer warpgroup);
//  kProductDq   the same CTAs: dQ = sm_scale dS K (A K-major);
//  kProductDkv  one CTA per (kv head of the wave, 256-column chunk of dV or
//               dK, key tile): dV = (P o M)^T dO, dK = sm_scale dS^T Q, over
//               the GQA group's q heads in order, each q tile in order (A
//               MN-major), carried across waves in fp32 (dk_acc / dv_acc).
// Consumer warpgroup w owns rows 64 w .. of the CTA's 128 (q rows; keys
// in dK / dV) and all 256 columns (two n128 products a k-step).
template <typename T, int KIND>
__global__ void __launch_bounds__(WS_THREADS, 1)
ws_product_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_a2,
                  const __grid_constant__ CUtensorMap tm_b,
                  const __grid_constant__ CUtensorMap tm_b2, const WsArgs a) {
  using L = ProductLayout<KIND>;
  constexpr bool OUT_O = KIND == kProductO, DKV = KIND == kProductDkv;
  const int n_qt = cdiv(a.Nq, BM), n_kt = cdiv(a.Nkv, BN), G = a.Hq / a.Hkv;
  const int chunks = cdiv(a.D, CW);
  const int per_kv = G * n_qt;  // tiles of a kv head: its q heads' q tiles
  int f = 0, kt = 0, bk, cc, f_lo = 0, f_hi = 0;
  bool dk_side = false;
  if constexpr (DKV) {
    bk = a.f0 / per_kv + blockIdx.x;  // b Hkv + kv head
    cc = blockIdx.y % chunks;
    dk_side = blockIdx.y >= chunks;
    kt = blockIdx.z;
    f_lo = max(a.f0, bk * per_kv);
    f_hi = min(a.f1, bk * per_kv + per_kv);
  } else {
    f = a.causal ? a.f1 - 1 - blockIdx.x : a.f0 + blockIdx.x;  // heaviest causal tiles first
    cc = blockIdx.y;
    bk = (f / n_qt) / G;  // (b Hq + h) / G = b Hkv + h / G
  }
  const int bh = f / n_qt, qt = f % n_qt, m0 = qt * BM;
  const int c0 = cc * CW;
  const int loaded = min(CW, a.D - c0) / 64;  // B chunks inside the head dim
  const TileRange tr = DKV ? TileRange{0, 0}
                           : kv_tiles<BM, BN>(m0, a.Nq, a.Nkv, a.causal, a.window);
  const CUtensorMap* const map_a = dk_side ? &tm_a2 : &tm_a;
  const CUtensorMap* const map_b = dk_side ? &tm_b2 : &tm_b;
  const bool v8 = OUT_O && a.v_kind != kVSame;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bars = base + L::BAR_OFF;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (L::STAGES + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full(s), v8 ? 5 : 1);  // fp8 V: and each producer warp once it has converted
      mbar_init(empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (loaded < CW / 64) zero_odd_chunks<L>(smem, loaded);
  __syncthreads();

  // The stages in order, the same walk for producer and consumers:
  // fn(i, stage row n0 or r0, tile f of the stage).
  auto walk = [&](auto&& fn) {
    if constexpr (DKV) {
      for_row_stages(f_lo, f_hi, n_qt, kt, a, [&](int i, int ff, int r0) { fn(i, r0, ff); });
    } else {
      for_key_stages(tr, a.Nkv, [&](int i, int n0) { fn(i, n0, f); });
    }
  };

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int tid = threadIdx.x;
    if (tid != 0 && !v8) return;
    walk([&](int i, int r, int ff) {
      const int s = i % L::STAGES;
      mbar_wait(empty(s), ((i / L::STAGES) & 1) ^ 1);
      const uint32_t st = base + s * L::STAGE;
      const int arow = (ff - a.f0) * BM;  // the tile's first scratch row
      if (tid == 0) {
        mbar_expect_tx(full(s), L::A_BYTES + (v8 ? 0 : loaded * 8192));
        if constexpr (OUT_O) {
          tma_load_2d(st, map_a, full(s), r, arow);
          tma_load_2d(st + 16384, map_a, full(s), r + 32, arow);
        } else if constexpr (DKV) {
          tma_load_2d(st, map_a, full(s), kt * BN, arow + (r - (ff % n_qt) * BM));
          tma_load_2d(st + 8192, map_a, full(s), kt * BN + 64, arow + (r - (ff % n_qt) * BM));
        } else {
          tma_load_2d(st, map_a, full(s), r, arow);
        }
        if (!v8) {
          const int head = DKV ? ff / n_qt : bk;  // q head of dO / Q, or kv head of V / K
          for (int c = 0; c < loaded; ++c)
            tma_load_3d(st + L::A_BYTES + c * 8192, map_b, full(s), c0 + 64 * c, r, head);
        }
      }
      if (v8) {  // fp8 V rows r .. r + 63, converted into the B stage
        const uint8_t* vb = static_cast<const uint8_t*>(a.v);
        const int per_row = loaded * 4;
        for (int idx = tid; idx < ROWS * per_row; idx += 128) {
          const int rr = idx / per_row, c16 = idx % per_row;
          const uint4 raw = r + rr < a.Nkv
                                ? *reinterpret_cast<const uint4*>(
                                      vb + (size_t(bk) * a.Nkv + r + rr) * a.D + c0 + c16 * 16)
                                : make_uint4(0, 0, 0, 0);
          store_fp8_chunk<T>(smem + s * L::STAGE + L::A_BYTES, rr, c16, raw, a.v_kind);
        }
        fence_proxy_async();  // the stage is read by wgmma
        __syncwarp();
        if (tid % 32 == 0) mbar_arrive(full(s));
      }
    });
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int w = threadIdx.x / 128 - 1, wt = threadIdx.x % 128;
  const int warp = wt / 32, lane = wt % 32, g = lane / 4, t = lane % 4;
  const int lr0 = 64 * w + 16 * warp + g;  // the thread's rows lr0, lr0 + 8 of the CTA's 128
  float acc[CW / 2];
#pragma unroll
  for (int i = 0; i < CW / 2; ++i) acc[i] = 0.f;

  // dK / dV: the kv head's sum so far, from the waves before this one
  // (predicated loads: each accumulator register is defined once before
  // the products, which keeps ptxas from serializing them).
  const bool per_first = a.f0 <= bk * per_kv, per_last = a.f1 >= bk * per_kv + per_kv;
  float* const carry = dk_side ? a.dk_acc : a.dv_acc;
  if constexpr (DKV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kt * BN + lr0 + 8 * r;
      const float* src = carry + (size_t(bk) * a.Nkv + min(key, a.Nkv - 1)) * a.D + c0 + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const bool live = !per_first && key < a.Nkv && c0 + 128 * hh < a.D;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 x = live ? *reinterpret_cast<const float2*>(src + 128 * hh + 8 * j)
                                : make_float2(0.f, 0.f);
          acc[64 * hh + 4 * j + 2 * r] = x.x;
          acc[64 * hh + 4 * j + 2 * r + 1] = x.y;
        }
      }
    }
  }
  fence_regs(acc);

  // O: the rows' lse (base 2) merged from the key tiles' (max, sum).
  float lse2[2] = {0.f, 0.f}, lse_out[2] = {kMaskValue, kMaskValue};
  uint32_t stream = 0;
  if constexpr (OUT_O) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2* st = a.stats + (size_t(f - a.f0) * BM + lr0 + 8 * r) * n_kt;
      float mx = -INFINITY;
      for (int k2 = tr.lo; k2 < tr.hi; ++k2) mx = fmaxf(mx, st[k2].x);
      const float m_use = mx == -INFINITY ? 0.f : mx;
      float l = 0.f;
      for (int k2 = tr.lo; k2 < tr.hi; ++k2) l += st[k2].y * exp2_ftz(st[k2].x - m_use);
      if (l > 0.f) {
        lse2[r] = mx + log2f(l);
        lse_out[r] = lse2[r] * kLn2;
      }
    }
    if (a.md.rate > 0.f) stream = dropout_stream(a.md.seed, bh / a.Hq, bh % a.Hq);
  }

  walk([&](int i, int r, int) {
    const int s = i % L::STAGES;
    mbar_wait(full(s), (i / L::STAGES) & 1);
    const uint32_t st = base + s * L::STAGE, sb = st + L::A_BYTES;
    if constexpr (OUT_O) {
      // P of the stage's 64 keys as the A fragments of 4 k-steps: S from
      // its two swizzled 32-key boxes, exp2(S - lse), dropped, rounded.
      const unsigned char* sa = smem + s * L::STAGE;
      uint32_t pa[ROWS / 16][4];
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int lr = lr0 + 8 * (x & 1), kc = 16 * kk + 8 * (x >> 1) + 2 * t;
          const int e = kc % 32;
          const float2 sv = *reinterpret_cast<const float2*>(
              sa + (kc / 32) * 16384 + lr * 128 + (((e / 4) ^ (lr & 7)) << 4) + (e % 4) * 4);
          float p0 = exp2_ftz(sv.x - lse2[x & 1]), p1 = exp2_ftz(sv.y - lse2[x & 1]);
          if (a.md.rate > 0.f) {
            p0 *= dropout_factor(stream, m0 + lr, r + kc, a.md);
            p1 *= dropout_factor(stream, m0 + lr, r + kc + 1, a.md);
          }
          pa[kk][x] = Mma<T>::pack(p0, p1);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          WgmmaRS<128, T>::run(*reinterpret_cast<float(*)[64]>(acc + 64 * hh), pa[kk],
                               smem_desc(sb + hh * 2 * 8192 + kk * 2048, 8192, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      release(empty(s));
    } else {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk) {
        // dQ: A [128 rows][64 keys] K-major, k-steps 32 bytes along a row;
        // dK / dV: A [64 q rows][64 keys] a warpgroup, MN-major, k-steps of
        // 16 q rows (2048 bytes)
        const uint64_t da = DKV ? smem_desc(st + w * 8192 + kk * 2048, 8192, 1024)
                                : smem_desc(st + w * 8192 + kk * 32, 16, 1024);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          WsSS<T, DKV ? 1 : 0>::run(acc + 64 * hh, da,
                                    smem_desc(sb + hh * 2 * 8192 + kk * 2048, 8192, 1024));
      }
      wgmma_commit();
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (i > 0) release(empty((i - 1) % L::STAGES));  // the previous stage's products are done
    }
  });
  wgmma_wait_all();
  fence_regs(acc);

  // The owner's rows of the output, the columns inside the head dim.
  const float scale = KIND == kProductDq || dk_side ? a.sm_scale : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    size_t out_row;
    if constexpr (DKV) {
      const int key = kt * BN + lr0 + 8 * r;
      if (key >= a.Nkv) continue;
      out_row = size_t(bk) * a.Nkv + key;
    } else {
      const int row = m0 + lr0 + 8 * r;
      if (row >= a.Nq) continue;
      out_row = size_t(bh) * a.Nq + row;
      if (OUT_O && cc == 0 && t == 0) a.lse_out[out_row] = lse_out[r];
    }
    const size_t at = out_row * a.D + c0 + 2 * t;
    if (DKV && !per_last) {  // a later wave adds to the sum
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (c0 + 128 * hh >= a.D) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<float2*>(carry + at + 128 * hh + 8 * j) =
              make_float2(acc[64 * hh + 4 * j + 2 * r], acc[64 * hh + 4 * j + 2 * r + 1]);
      }
      continue;
    }
    T* out = static_cast<T*>(OUT_O ? a.o : KIND == kProductDq ? a.dq : dk_side ? a.dk : a.dv);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (c0 + 128 * hh >= a.D) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<uint32_t*>(out + at + 128 * hh + 8 * j) =
            Mma<T>::pack(acc[64 * hh + 4 * j + 2 * r] * scale, acc[64 * hh + 4 * j + 2 * r + 1] * scale);
    }
  }
}


// ---------------------------------------------------------------------------
// Paged multi-token verify
// ---------------------------------------------------------------------------

// setmaxnreg of the verify passes, whose producers convert quantized pools
// with loads in flight: the score pass's keeps two slices of payloads (its
// consumers hold a 64 x 128 tile of S, 64 registers), the product's a
// batch of four chunks of a stage (its consumers 128 of O).
constexpr int VERIFY_SCORES_PRODUCER_REGS = 96, VERIFY_SCORES_CONSUMER_REGS = 200;
constexpr int VERIFY_PRODUCT_PRODUCER_REGS = 56, VERIFY_PRODUCT_CONSUMER_REGS = 224;
static_assert(128 * VERIFY_SCORES_PRODUCER_REGS + 256 * VERIFY_SCORES_CONSUMER_REGS <=
                      WS_THREADS * LAUNCH_REGS &&
                  128 * VERIFY_PRODUCT_PRODUCER_REGS + 256 * VERIFY_PRODUCT_CONSUMER_REGS <=
                      WS_THREADS * LAUNCH_REGS,
              "a register split exceeds the CTA's registers");

struct WsVerifyArgs {
  const void* q;  // the folded rows [B Hkv][T G][D] of q scaled in its dtype
  const void *k, *v;  // pools [Hkv, P, stored rows, D] of `kind` (paged.cuh)
  int kind;
  const float *k_scales, *v_scales;  // quantized pools: [Hkv, P, page_size]
  const int *lengths, *page_table;
  float* s;        // scratch: S, [tiles x 128][key tiles x 128] fp32
  float2* stats;   // each row's (max, sum of exp2) of each key tile
  void* o;         // [B, Hq, T, D] in q's dtype (one split)
  float *part_o, *part_lse;  // [splits, B Hq T, D] and [splits, B Hq T] (splits > 1)
  int B, Hq, Hkv, T, P, page_size, pages_per_seq, D, splits;
  float softcap;
  const float* slopes;  // ALiBi: one a q head, or null
  int tma;  // value pools read by TMA boxes of tm_k / tm_v where a stage's keys hold data
  int box;  // rows of those boxes (a page, or the stage's keys where a page holds more)
  int f0, f1;  // the wave: tiles f = (b Hkv + kv head) ceil(T G / 128) + row tile in [f0, f1)
  cudaStream_t stream;
};

// Tile f of a verify call: its sequence, kv head and first row, the
// sequence's length (and clamped to the table), the keys any of its rows
// sees ([0, key_hi), all of them holding data) and every one of them sees
// ([0, open): its first row's horizon).
struct VerifyTile {
  int b, kvh, m0, rows, len, alen, key_hi, open;
};

__device__ __forceinline__ VerifyTile verify_tile(const WsVerifyArgs& a, int f) {
  const int G = a.Hq / a.Hkv, rows = a.T * G, n_rt = cdiv(rows, BM);
  const int max_len = a.pages_per_seq * a.page_size;
  VerifyTile v;
  v.b = f / n_rt / a.Hkv;
  v.kvh = f / n_rt % a.Hkv;
  v.m0 = f % n_rt * BM;
  v.rows = rows;
  v.len = a.lengths[v.b];
  v.alen = min(max(v.len, 0), max_len);
  const int t_hi = (min(v.m0 + BM, rows) - 1) / G;
  v.key_hi = max(0, min(v.len - a.T + 1 + t_hi, max_len));
  v.open = max(0, min(v.len - a.T + 1 + v.m0 / G, max_len));
  return v;
}

// The pool row (kv head, page, offset) of key `key` of the tile's sequence,
// as a row of the pool viewed as [Hkv P page_size, D].
__device__ __forceinline__ size_t pool_row(const WsVerifyArgs& a, const int* table, int kvh,
                                           int key) {
  return (size_t(kvh) * a.P + table[key / a.page_size]) * a.page_size + key % a.page_size;
}

// One stored 16-byte chunk c16 (16 one-byte elements of `kind`) of row r
// of a swizzled tile of 64-column chunks `rows` rows deep, converted
// exactly and unscaled to T.
template <typename T>
__device__ __forceinline__ void store_converted_rows(unsigned char* tile, int rows, int r, int c16,
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
  const int u = 2 * (c16 % 4);
  unsigned char* row = tile + (c16 / 4) * (rows * 128) + r * 128;
  *reinterpret_cast<uint4*>(row + ((u ^ (r & 7)) << 4)) = make_uint4(p[0], p[1], p[2], p[3]);
  *reinterpret_cast<uint4*>(row + (((u + 1) ^ (r & 7)) << 4)) = make_uint4(p[4], p[5], p[6], p[7]);
}

// `n` rows of keys [n0, n0 + n) of the tile's sequence in a value pool
// (K or V), `chunks` 64-column chunks from column c0, into a swizzled tile
// at shared address `dst` `rows` rows deep, by cp.async from the producer
// warpgroup's thread tid; rows past `live` zero.  The caller arrives on the
// stage's barrier once they land (cp_async_arrive).
template <typename T>
__device__ __forceinline__ void gather_value_rows(const WsVerifyArgs& a, const T* pool,
                                                  const int* table, int kvh, int n0, int live,
                                                  int n, int c0, int chunks, uint32_t dst,
                                                  int rows, int tid) {
  const int per_row = chunks * 8;  // 16-byte units
#pragma unroll 1
  for (int idx = tid; idx < n * per_row; idx += 128) {
    const int r = idx / per_row, u16 = idx % per_row, c = u16 / 8, u = u16 % 8;
    const bool ok = r < live;
    const size_t off = ok ? pool_row(a, table, kvh, n0 + r) * a.D + c0 + u16 * 8 : 0;
    cp_async16(dst + c * (rows * 128) + r * 128 + ((u ^ (r & 7)) << 4), pool + off, ok ? 16 : 0);
  }
}

// A product stage's 64 rows of a quantized V pool (keys [n0, n0 + 64),
// `loaded` 64-column chunks from column c0) converted into the stage's
// swizzled B chunks by producer thread tid: rows tid / 16 + 8 j, stored
// chunk tid % 16 of each, in two batches of four rows whose loads are all
// issued before the batch converts; rows past `live` zero.
template <typename T>
__device__ __forceinline__ void gather_quant_stage(const WsVerifyArgs& a, const int* table,
                                                   int kvh, int n0, int live, int c0, int loaded,
                                                   unsigned char* tile, int tid) {
  constexpr int PER = ROWS * 16 / 128;
  const unsigned char* pool = static_cast<const unsigned char*>(a.v);
  const int c16 = tid % 16;
  if (c16 / 4 >= loaded) return;  // a chunk past D (zeroed once)
#pragma unroll 1
  for (int j0 = 0; j0 < PER; j0 += 4) {
    uint4 raw[4];
    int hi = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tid / 16 + 8 * (j0 + j), key = n0 + r;
      raw[j] = make_uint4(0, 0, 0, 0);
      if (r < live) {
        const TokenAddr ta = token_addr(a.kind, kvh, table[key / a.page_size],
                                        key % a.page_size, a.P, a.page_size, a.D);
        raw[j] = *reinterpret_cast<const uint4*>(pool + ta.row + c0 + c16 * 16);
        hi |= ta.hi << j;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_converted_rows<T>(tile, ROWS, tid / 16 + 8 * (j0 + j), c16, raw[j], (hi >> j) & 1,
                              a.kind);
  }
}

// Verify's score pass: one CTA per (tile f of the wave, key tile kt).  S of
// the tile's 128 rows against its 128 keys over the whole head dim, then
// the K scale, the softcap, the ALiBi bias and each row's horizon
// (paged_verify_plain's order) into base-2 units; stores S and each row's
// (max, sum of exp2) of the tile.  A key tile past every row's horizon
// returns at once: it is never computed, stored or read.
template <typename T>
__global__ void __launch_bounds__(WS_THREADS, 1)
ws_verify_scores_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k, const WsVerifyArgs a) {
  using L = ScoreLayout<false>;
  const int f = a.f0 + blockIdx.x, kt = blockIdx.y, n0 = kt * BN;
  const VerifyTile vt = verify_tile(a, f);
  if (n0 >= vt.key_hi) return;
  const int max_len = a.pages_per_seq * a.page_size, n_kt = cdiv(max_len, BN);
  const int live = min(BN, vt.key_hi - n0);  // the tile's keys that hold data
  const bool quant = is_quantized(a.kind);
  const bool by_tma = !quant && a.tma && live == BN;
  const int* table = a.page_table + size_t(vt.b) * a.pages_per_seq;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle atom
  unsigned char* const smem = smem_raw + (base - smem_u32(smem_raw));
  float* const ksc = reinterpret_cast<float*>(smem + L::IDS_OFF);  // the keys' K scales
  const uint32_t bars = base + L::BAR_OFF;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (L::STAGES + s); };
  const int n = head_slices(a.D);

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full(s), 129);  // every producer thread, and thread 0's Q (and K) bytes
      mbar_init(empty(s), 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < BN; i += blockDim.x)
    ksc[i] = quant && i < live
                 ? a.k_scales[scale_index(vt.kvh, table[(n0 + i) / a.page_size],
                                          (n0 + i) % a.page_size, a.P, a.page_size)]
                 : 1.f;
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(VERIFY_SCORES_PRODUCER_REGS));
    const int tid = threadIdx.x;
    // Stage i % STAGES of slice i: Q by TMA (thread 0), then K.
    auto stage_q = [&](int i, uint32_t k_bytes) {
      const int s = i % L::STAGES;
      mbar_wait(empty(s), ((i / L::STAGES) & 1) ^ 1);  // passes at once on the first lap
      if (tid == 0) {
        mbar_expect_tx(full(s), L::TILE + k_bytes);
        tma_load_3d(base + s * L::STAGE, &tm_q, full(s), i * SLICE, vt.m0,
                    vt.b * a.Hkv + vt.kvh);
      }
      return s;
    };
    if (quant) {
      // The thread's rows tid / 4 + 32 j of the tile and stored chunk tid %
      // 4 of each slice: their offsets found once, the next slice's
      // payloads loaded while this slice's convert.
      const unsigned char* kb = static_cast<const unsigned char*>(a.k);
      size_t off[4];
      int hi = 0, ok = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tid / 4 + 32 * j, key = n0 + r;
        off[j] = 0;
        if (r < live) {
          const TokenAddr ta = token_addr(a.kind, vt.kvh, table[key / a.page_size],
                                          key % a.page_size, a.P, a.page_size, a.D);
          off[j] = ta.row + (tid % 4) * 16;
          hi |= ta.hi << j;
          ok |= 1 << j;
        }
      }
      auto load = [&](uint4 (&raw)[4], int i) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          raw[j] = (ok >> j) & 1 ? *reinterpret_cast<const uint4*>(kb + off[j] + i * SLICE)
                                 : make_uint4(0, 0, 0, 0);
      };
      auto put = [&](const uint4 (&raw)[4], int i) {
        const int s = stage_q(i, 0);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          store_converted_rows<T>(smem + s * L::STAGE + L::TILE, BN, tid / 4 + 32 * j, tid % 4,
                                  raw[j], (hi >> j) & 1, a.kind);
        fence_proxy_async();  // the stage is read by wgmma
        mbar_arrive(full(s));
      };
      uint4 cur[4], nxt[4];
      load(cur, 0);
      for (int i = 0; i < n; i += 2) {  // n is even: D is a multiple of 128
        load(nxt, i + 1);
        put(cur, i);
        if (i + 2 < n) load(cur, i + 2);
        put(nxt, i + 1);
      }
      return;
    }
    for (int i = 0; i < n; ++i) {
      const int s = stage_q(i, by_tma ? L::TILE : 0);
      const uint32_t sk = base + s * L::STAGE + L::TILE;
      if (by_tma) {
        if (tid == 0)
          for (int r = 0; r < BN; r += a.box)
            tma_load_2d(sk + r * 128, &tm_k, full(s), i * SLICE,
                        int(pool_row(a, table, vt.kvh, n0 + r)));
        mbar_arrive(full(s));
      } else {
        gather_value_rows<T>(a, static_cast<const T*>(a.k), table, vt.kvh, n0, live, BN,
                             i * SLICE, 1, sk, BN, tid);
        cp_async_arrive(full(s));
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(VERIFY_SCORES_CONSUMER_REGS));
  const int w = threadIdx.x / 128 - 1, wt = threadIdx.x % 128;
  const int warp = wt / 32, lane = wt % 32, g = lane / 4, t = lane % 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  for (int i = 0; i < n; ++i) {
    const int s = i % L::STAGES;
    mbar_wait(full(s), (i / L::STAGES) & 1);
    fence_proxy_async();  // rows written by cp.async, read by wgmma
    const uint32_t st = base + s * L::STAGE;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < SLICE / 16; ++ks)
      WgmmaSS<BN, T>::run(acc, smem_desc(st + w * 8192 + ks * 32, 16, 1024),
                          smem_desc(st + L::TILE + ks * 32, 16, 1024), 1);
    wgmma_commit();
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (i > 0) release(empty((i - 1) % L::STAGES));  // the previous slice's products are done
  }
  wgmma_wait_all();
  fence_regs(acc);

  // Each row's horizon (keys below it visible), ALiBi position and slope.
  const int G = a.Hq / a.Hkv;
  const int lr0 = 64 * w + 16 * warp + g;  // the thread's tile rows lr0, lr0 + 8
  int lim[2], qpos[2];
  float slope[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = vt.m0 + lr0 + 8 * r, tt = row / G;
    lim[r] = row < vt.rows ? min(vt.len - a.T + 1 + tt, max_len) : 0;
    qpos[r] = vt.alen - a.T + tt;
    slope[r] = a.slopes != nullptr && row < vt.rows ? a.slopes[vt.kvh * G + row % G] : 0.f;
  }
  const bool masked = n0 + BN > vt.open || vt.m0 + BM > vt.rows;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, kc = 8 * j + 2 * t + (e & 1), col = n0 + kc;
      float x = acc[4 * j + e] * ksc[kc];
      if (a.softcap > 0.f) x = a.softcap * tanhf(x * (1.f / a.softcap));
      if (a.slopes != nullptr) x -= slope[r] * float(qpos[r] - col);
      x *= kLog2e;
      if (masked && col >= lim[r]) x = -INFINITY;
      acc[4 * j + e] = x;
    }
  }
  const size_t nkv_pad = size_t(n_kt) * BN;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) mx = fmaxf(mx, fmaxf(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_use = mx == -INFINITY ? 0.f : mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      sum += exp2_ftz(acc[4 * j + 2 * r] - m_use) + exp2_ftz(acc[4 * j + 2 * r + 1] - m_use);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const size_t lrow = size_t(f - a.f0) * BM + lr0 + 8 * r;
    if (t == 0) a.stats[lrow * n_kt + kt] = make_float2(mx, sum);
    float* dst = a.s + lrow * nkv_pad + n0 + 2 * t;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// Verify's product pass's stages: the forward product's (fp32 S of 128 rows
// x 64 keys, then 64 rows x 256 columns of V), then each stage's 64 V
// scales, the barriers and 1024 bytes of alignment.
struct VerifyProductLayout {
  static constexpr uint32_t A_BYTES = ProductLayout<kProductO>::A_BYTES;
  static constexpr uint32_t STAGE = ProductLayout<kProductO>::STAGE;
  static constexpr int STAGES = ProductLayout<kProductO>::STAGES;
  static constexpr uint32_t SC_OFF = STAGES * STAGE;
  static constexpr uint32_t BAR_OFF = SC_OFF + STAGES * ROWS * 4;
  static constexpr size_t BYTES = size_t(BAR_OFF) + 8 * 2 * STAGES + 1024;
  static_assert(BYTES <= 232448, "a CTA has 227 KB of shared memory");
};

// Calls fn(i, n0) for each 64-key stage of split `sp` of a verify product:
// both halves of every key tile of the split that a row of the tile sees,
// in key order, up to the last key a row sees.
template <typename F>
__device__ __forceinline__ void for_split_stages(int kt_lo, int kt_hi, int key_hi, F&& fn) {
  int i = 0;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {  // every key tile of the split, in order
    for (int n0 = kt * BN; n0 < min(kt * BN + BN, key_hi); n0 += ROWS) fn(i++, n0);
  }
}

// Verify's product pass: one CTA per (tile f of the wave, 256-column chunk,
// key split).  O = P V / l over the split's key tiles, P = exp2(S - m)
// times the V scale, rounded to T, with the row's max m and sum l over
// those tiles merged from their (max, sum) in key-tile order: P rounded
// against the row's max, as paged_verify_plain and the TPU kernel round it
// (not the forward product's exp2(S - lse)); one split writes O in T
// (zeros where a row sees no key), several their fp32 partials and lse
// (-inf where the split shows the row no key) for wide_combine_kernel.
template <typename T>
__global__ void __launch_bounds__(WS_THREADS, 1)
ws_verify_product_kernel(const __grid_constant__ CUtensorMap tm_s,
                         const __grid_constant__ CUtensorMap tm_v, const WsVerifyArgs a) {
  using L = VerifyProductLayout;
  const int f = a.f0 + blockIdx.x, cc = blockIdx.y, sp = blockIdx.z;
  const VerifyTile vt = verify_tile(a, f);
  const int max_len = a.pages_per_seq * a.page_size, n_kt = cdiv(max_len, BN);
  const int per = cdiv(n_kt, a.splits), kt_lo = sp * per;
  const int kt_hi = min(min(kt_lo + per, n_kt), cdiv(vt.key_hi, BN));
  const int c0 = cc * CW;
  const int loaded = min(CW, a.D - c0) / 64;  // B chunks inside the head dim
  const bool quant = is_quantized(a.kind);
  const int* table = a.page_table + size_t(vt.b) * a.pages_per_seq;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - smem_u32(smem_raw));
  float* const vsc = reinterpret_cast<float*>(smem + L::SC_OFF);  // [stage][64 keys]
  const uint32_t bars = base + L::BAR_OFF;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (L::STAGES + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full(s), 129);  // every producer thread, and thread 0's S (and V) bytes
      mbar_init(empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!quant)  // value pools: every V scale 1
    for (int i = threadIdx.x; i < L::STAGES * ROWS; i += blockDim.x) vsc[i] = 1.f;
  if (loaded < CW / 64) zero_odd_chunks<L>(smem, loaded);
  __syncthreads();

  auto walk = [&](auto&& fn) { for_split_stages(kt_lo, kt_hi, vt.key_hi, fn); };

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(VERIFY_PRODUCT_PRODUCER_REGS));
    const int tid = threadIdx.x;
    const int arow = (f - a.f0) * BM;  // the tile's first scratch row
    walk([&](int i, int n0) {
      const int s = i % L::STAGES;
      mbar_wait(empty(s), ((i / L::STAGES) & 1) ^ 1);
      const uint32_t st = base + s * L::STAGE, sb = st + L::A_BYTES;
      const int live = min(ROWS, vt.key_hi - n0);
      const bool by_tma = !quant && a.tma && live == ROWS;
      if (tid == 0) {
        mbar_expect_tx(full(s), L::A_BYTES + (by_tma ? loaded * 8192 : 0));
        tma_load_2d(st, &tm_s, full(s), n0, arow);
        tma_load_2d(st + 16384, &tm_s, full(s), n0 + 32, arow);
        if (by_tma)
          for (int c = 0; c < loaded; ++c)
            for (int r = 0; r < ROWS; r += a.box)
              tma_load_2d(sb + c * 8192 + r * 128, &tm_v, full(s), c0 + 64 * c,
                          int(pool_row(a, table, vt.kvh, n0 + r)));
      }
      if (by_tma) {
        mbar_arrive(full(s));
      } else if (!quant) {
        gather_value_rows<T>(a, static_cast<const T*>(a.v), table, vt.kvh, n0, live, ROWS, c0,
                             loaded, sb, ROWS, tid);
        cp_async_arrive(full(s));
      } else {
        if (tid < ROWS)
          vsc[s * ROWS + tid] =
              tid < live ? a.v_scales[scale_index(vt.kvh, table[(n0 + tid) / a.page_size],
                                                  (n0 + tid) % a.page_size, a.P, a.page_size)]
                         : 0.f;
        gather_quant_stage<T>(a, table, vt.kvh, n0, live, c0, loaded,
                              smem + s * L::STAGE + L::A_BYTES, tid);
        fence_proxy_async();  // the stage is read by wgmma
        mbar_arrive(full(s));
      }
    });
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(VERIFY_PRODUCT_CONSUMER_REGS));
  const int w = threadIdx.x / 128 - 1, wt = threadIdx.x % 128;
  const int warp = wt / 32, lane = wt % 32, g = lane / 4, t = lane % 4;
  const int lr0 = 64 * w + 16 * warp + g;  // the thread's rows lr0, lr0 + 8 of the CTA's 128
  float acc[CW / 2];
#pragma unroll
  for (int i = 0; i < CW / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);

  // The rows' max (base 2) and sum over the split's key tiles, merged from
  // the tiles' (max, sum) in key-tile order.
  float m2[2], lsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float2* st = a.stats + (size_t(f - a.f0) * BM + lr0 + 8 * r) * n_kt;
    float mx = -INFINITY;
    for (int k2 = kt_lo; k2 < kt_hi; ++k2) mx = fmaxf(mx, st[k2].x);
    m2[r] = mx == -INFINITY ? 0.f : mx;
    float l = 0.f;
    for (int k2 = kt_lo; k2 < kt_hi; ++k2) l += st[k2].y * exp2_ftz(st[k2].x - m2[r]);
    lsum[r] = l;
  }

  walk([&](int i, int n0) {
    const int s = i % L::STAGES;
    mbar_wait(full(s), (i / L::STAGES) & 1);
    fence_proxy_async();  // rows written by cp.async, read by wgmma
    const uint32_t sb = base + s * L::STAGE + L::A_BYTES;
    // P of the stage's 64 keys as the A fragments of 4 k-steps: S from its
    // two swizzled 32-key boxes, exp2(S - m) times the V scale, rounded.
    const unsigned char* sa = smem + s * L::STAGE;
    const float* vs = vsc + s * ROWS;
    uint32_t pa[ROWS / 16][4];
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int lr = lr0 + 8 * (x & 1), kc = 16 * kk + 8 * (x >> 1) + 2 * t;
        const int e = kc % 32;
        const float2 sv = *reinterpret_cast<const float2*>(
            sa + (kc / 32) * 16384 + lr * 128 + (((e / 4) ^ (lr & 7)) << 4) + (e % 4) * 4);
        pa[kk][x] = Mma<T>::pack(exp2_ftz(sv.x - m2[x & 1]) * vs[kc],
                                 exp2_ftz(sv.y - m2[x & 1]) * vs[kc + 1]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        WgmmaRS<128, T>::run(*reinterpret_cast<float(*)[64]>(acc + 64 * hh), pa[kk],
                             smem_desc(sb + hh * 2 * 8192 + kk * 2048, 8192, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    release(empty(s));
  });
  wgmma_wait_all();
  fence_regs(acc);

  // The owner's rows, O = acc / l: in T (one split), or the split's fp32
  // partial and its lse; columns inside the head dim.
  const int G = a.Hq / a.Hkv;
  const size_t all_rows = size_t(a.B) * a.Hq * a.T;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = vt.m0 + lr0 + 8 * r;
    if (row >= vt.rows) continue;
    const size_t orow = (size_t(vt.b) * a.Hq + vt.kvh * G + row % G) * a.T + row / G;
    const float inv = lsum[r] > 0.f ? 1.f / lsum[r] : 0.f;
    if (a.splits > 1) {
      const size_t at = (size_t(sp) * all_rows + orow) * a.D + c0 + 2 * t;
      if (cc == 0 && t == 0)
        a.part_lse[size_t(sp) * all_rows + orow] =
            lsum[r] > 0.f ? (m2[r] + log2f(lsum[r])) * kLn2 : -INFINITY;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (c0 + 128 * hh >= a.D) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<float2*>(a.part_o + at + 128 * hh + 8 * j) = make_float2(
              acc[64 * hh + 4 * j + 2 * r] * inv, acc[64 * hh + 4 * j + 2 * r + 1] * inv);
      }
      continue;
    }
    T* out = static_cast<T*>(a.o) + orow * a.D + c0 + 2 * t;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (c0 + 128 * hh >= a.D) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<uint32_t*>(out + 128 * hh + 8 * j) =
            Mma<T>::pack(acc[64 * hh + 4 * j + 2 * r] * inv, acc[64 * hh + 4 * j + 2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// A 2-D map (cols, rows) of a contiguous [rows][cols] scratch of `elem`-byte
// elements (bf16, fp16 or fp32), in boxes of 128 bytes of a row x box_rows
// rows, 128-byte swizzle.
inline bool encode_scratch(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                           size_t elem, size_t cols, size_t rows, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || ptr == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols * elem)};
  const cuuint32_t box[2] = {cuuint32_t(128 / elem), cuuint32_t(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// Whether the call is one this route takes, its wave inside the call's tiles
// and every grid axis inside its limit.
inline bool valid_call(const WsArgs& a) {
  if (!scores_head_dim(a.D) || a.B <= 0 || a.Hq <= 0 || a.Hkv <= 0 || a.Hq % a.Hkv != 0 ||
      a.Nq <= 0 || a.Nkv <= 0 || a.md.rate < 0.f || a.md.rate >= 1.f ||
      (a.md.q_seg == nullptr) != (a.md.kv_seg == nullptr))
    return false;
  const long long tiles = (long long)a.B * a.Hq * cdiv(a.Nq, BM);
  return a.f0 >= 0 && a.f0 < a.f1 && a.f1 <= tiles && cdiv(a.Nkv, BN) <= 65535 &&
         2 * cdiv(a.D, CW) <= 65535;
}

template <typename K, typename A, typename... Maps>
int launch_ws(K kernel, size_t smem, dim3 grid, const A& a, const Maps&... maps) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, WS_THREADS, smem, a.stream>>>(maps..., a);
  return int(cudaGetLastError());
}

// The forward's score pass over the wave's tiles.
template <typename T>
int launch_fwd_scores(const WsArgs& a) {
  CUtensorMap tm_q, tm_k;
  if (!encode_map<T>(&tm_q, a.q, a.D, a.Nq, a.B * a.Hq, BM) ||
      !encode_map<T>(&tm_k, a.k, a.D, a.Nkv, a.B * a.Hkv, BN))
    return int(cudaErrorInvalidValue);
  return launch_ws(ws_fwd_scores_kernel<T>, ScoreLayout<false>::BYTES,
                   dim3(a.f1 - a.f0, cdiv(a.Nkv, BN)), a, tm_q, tm_k);
}

// The backward's score pass over the wave's tiles.
template <typename T>
int launch_bwd_scores(const WsArgs& a) {
  CUtensorMap tm_q, tm_k, tm_do, tm_v;
  if (!encode_map<T>(&tm_q, a.q, a.D, a.Nq, a.B * a.Hq, BM) ||
      !encode_map<T>(&tm_k, a.k, a.D, a.Nkv, a.B * a.Hkv, BN) ||
      !encode_map<T>(&tm_do, a.dout, a.D, a.Nq, a.B * a.Hq, BM) ||
      !encode_map<T>(&tm_v, a.v, a.D, a.Nkv, a.B * a.Hkv, BN))
    return int(cudaErrorInvalidValue);
  return launch_ws(ws_bwd_scores_kernel<T>, ScoreLayout<true>::BYTES,
                   dim3(a.f1 - a.f0, cdiv(a.Nkv, BN)), a, tm_q, tm_k, tm_do, tm_v);
}

// A product pass over the wave: O (fp8 V read by the producer, no map),
// dQ, or dK and dV (the kv heads the wave touches).
template <typename T, int KIND>
int launch_product(const WsArgs& a) {
  const size_t rows = size_t(a.f1 - a.f0) * BM, nkv_pad = size_t(cdiv(a.Nkv, BN)) * BN;
  const int chunks = cdiv(a.D, CW), n_qt = cdiv(a.Nq, BM), per_kv = a.Hq / a.Hkv * n_qt;
  CUtensorMap ma, ma2, mb, mb2;
  bool ok;
  dim3 grid(a.f1 - a.f0, chunks);
  if (KIND == kProductO) {
    ok = encode_scratch(&ma, a.s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, nkv_pad, rows, BM) &&
         encode_map<T>(&mb, a.v_kind == kVSame ? a.v : a.q, a.D,
                       a.v_kind == kVSame ? a.Nkv : a.Nq,
                       a.v_kind == kVSame ? a.B * a.Hkv : a.B * a.Hq, ROWS);
    ma2 = ma, mb2 = mb;
  } else if (KIND == kProductDq) {
    ok = encode_scratch(&ma, a.ds, map_type<T>(), 2, nkv_pad, rows, BM) &&
         encode_map<T>(&mb, a.k, a.D, a.Nkv, a.B * a.Hkv, ROWS);
    ma2 = ma, mb2 = mb;
  } else {
    ok = encode_scratch(&ma, a.p, map_type<T>(), 2, nkv_pad, rows, ROWS) &&
         encode_scratch(&ma2, a.ds, map_type<T>(), 2, nkv_pad, rows, ROWS) &&
         encode_map<T>(&mb, a.dout, a.D, a.Nq, a.B * a.Hq, ROWS) &&
         encode_map<T>(&mb2, a.q, a.D, a.Nq, a.B * a.Hq, ROWS);
    grid = dim3((a.f1 - 1) / per_kv - a.f0 / per_kv + 1, 2 * chunks, cdiv(a.Nkv, BN));
  }
  if (!ok) return int(cudaErrorInvalidValue);
  return launch_ws(ws_product_kernel<T, KIND>, ProductLayout<KIND>::BYTES, grid, a, ma, ma2, mb,
                   mb2);
}


// Whether a verify call is one this route takes: a pool kind, q dtype and
// head dim it carries, its wave inside the call's tiles, its splits whole
// key tiles and every grid axis inside its limit.
inline bool valid_verify(const WsVerifyArgs& a, int q_dtype) {
  if ((q_dtype != 1 && q_dtype != 2) || !scores_head_dim(a.D) || a.B <= 0 || a.T <= 0 ||
      a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.P <= 0 || a.page_size <= 0 ||
      a.pages_per_seq <= 0 || a.kind < kBF16 || a.kind > kE5M2 ||
      (a.kind <= kF16 && a.kind != q_dtype) || (a.kind == kI4 && a.page_size % 2))
    return false;
  const int n_kt = cdiv(a.pages_per_seq * a.page_size, BN);
  const long long tiles = (long long)a.B * a.Hkv * cdiv(a.T * (a.Hq / a.Hkv), BM);
  return a.f0 >= 0 && a.f0 < a.f1 && a.f1 <= tiles && n_kt <= 65535 && a.splits >= 1 &&
         a.splits <= n_kt;
}

// Rows of the TMA boxes of a pool whose pages are read whole a stage of
// `keys` keys (a page, or `keys` where a page holds more), or 0 where its
// pages do not tile the stage in rows of whole 1024-byte swizzle atoms.
inline int pool_box(int page_size, int keys) {
  if (page_size % 8 != 0 || (page_size % keys != 0 && keys % page_size != 0)) return 0;
  return page_size < keys ? page_size : keys;
}

// Verify's score pass over the wave's tiles.
template <typename T>
int launch_verify_scores(WsVerifyArgs a) {
  const int rows = a.T * (a.Hq / a.Hkv);
  CUtensorMap tm_q, tm_k{};
  a.box = is_quantized(a.kind) ? 0 : pool_box(a.page_size, BN);
  a.tma = a.box > 0;
  if (!encode_map<T>(&tm_q, a.q, a.D, rows, a.B * a.Hkv, BM) ||
      (a.tma && !encode_map_2d<T>(&tm_k, a.k, a.D, size_t(a.Hkv) * a.P * a.page_size, a.box)))
    return int(cudaErrorInvalidValue);
  return launch_ws(ws_verify_scores_kernel<T>, ScoreLayout<false>::BYTES,
                   dim3(a.f1 - a.f0, cdiv(a.pages_per_seq * a.page_size, BN)), a, tm_q, tm_k);
}

// Verify's product pass over the wave's tiles, every split.
template <typename T>
int launch_verify_product(WsVerifyArgs a) {
  const size_t rows = size_t(a.f1 - a.f0) * BM;
  const size_t nkv_pad = size_t(cdiv(a.pages_per_seq * a.page_size, BN)) * BN;
  CUtensorMap tm_s, tm_v{};
  a.box = is_quantized(a.kind) ? 0 : pool_box(a.page_size, ROWS);
  a.tma = a.box > 0;
  if (!encode_scratch(&tm_s, a.s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, nkv_pad, rows, BM) ||
      (a.tma && !encode_map_2d<T>(&tm_v, a.v, a.D, size_t(a.Hkv) * a.P * a.page_size, a.box)))
    return int(cudaErrorInvalidValue);
  return launch_ws(ws_verify_product_kernel<T>, VerifyProductLayout::BYTES,
                   dim3(a.f1 - a.f0, cdiv(a.D, CW), a.splits), a, tm_s, tm_v);
}

}  // namespace ws
}  // namespace
