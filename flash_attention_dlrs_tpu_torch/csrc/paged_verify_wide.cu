// Paged multi-token verify at pool head dims above 256 (every multiple of
// 128), keys gathered through the page table and converted exactly to q's
// dtype (payloads unscaled; K scales on S, V scales on P), q pre-scaled in
// its dtype.  Routes: "wide_wgmma" (bf16 / fp16 q up to 1024, value pools
// of q's dtype or quantized pools: wide.cuh's forward kernel over the T x G
// rows of a kv head, warpgroup products, scores once a key tile) and
// "wide_fp32" (fp32 q, any pool, wide.cuh's column-chunked kernel), their
// key splits merged by wide_combine_kernel in the same C entry; and above
// 1024 "wide_scores" (bf16 / fp16 q: wide_scores.cuh's paged score pass and
// product pass, each its own C entry, the splits merged by
// paged_verify_combine; the caller, ops/wide_scores.py, allocates the
// scratch and runs the passes wave by wave).

#include "wide.cuh"
#include "wide_scores.cuh"

// The C entry of routes wide_wgmma and wide_fp32, with the arguments of
// paged_verify.cu's; D a multiple of 128 above 256 (at most 1024 on
// kRouteWideWgmma).  Returns cudaGetLastError() after the launches.
extern "C" int paged_verify_wide(const void* q, int q_dtype, const void* k_pages,
    const void* v_pages, int kv_kind, const float* k_scales, const float* v_scales,
    const int* lengths, const int* page_table, void* o, float* part_o, float* part_lse,
    int B, int Hq, int Hkv, int T, int P, int page_size, int pages_per_seq, int D,
    int splits, float scale_q, float softcap, const float* slopes, int route, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const bool value_pool = kv_kind <= kF16;
  if (!wide_head_dim(D) || Hkv <= 0 || Hq % Hkv != 0 || page_size <= 0 ||
      (kv_kind == kI4 && page_size % 2) || kv_kind < kF32 || kv_kind > kE5M2 ||
      pages_per_seq <= 0 || splits <= 0 || splits > pages_per_seq ||
      (splits > 1 && (part_o == nullptr || part_lse == nullptr)) ||
      (!value_pool && (k_scales == nullptr || v_scales == nullptr)) ||
      (route != kRouteWideF32 && value_pool && kv_kind != q_dtype) ||
      (route == kRouteWideWgmma && !wide_cut_head_dim(D)))
    return int(cudaErrorInvalidValue);
  WideArgs a{};
  a.q = q; a.k = k_pages; a.v = v_pages; a.o = o;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.D = D;
  a.sm_scale = scale_q; a.softcap = softcap;
  a.md = Mods{slopes, 0.f, 1.f, 0u, nullptr, nullptr};
  a.kind = kv_kind; a.k_scales = k_scales; a.v_scales = v_scales;
  a.lengths = lengths; a.page_table = page_table;
  a.P = P; a.page_size = page_size; a.pages_per_seq = pages_per_seq; a.T = T;
  a.splits = splits; a.pages_per_split = (pages_per_seq + splits - 1) / splits;
  a.part_o = part_o; a.part_lse = part_lse;
  a.stream = static_cast<cudaStream_t>(stream);
  const int G = Hq / Hkv;
  int err;
  if (route == kRouteWideF32 && q_dtype == 0) {
    const dim3 chunks((T * G + WROWS - 1) / WROWS, (D / WCOLS) * splits, B * Hkv);
    err = launch_wide_chunk<true>(a, chunks);
  } else if (route == kRouteWideWgmma && (q_dtype == 1 || q_dtype == 2)) {
    // Value pools whose pages hold whole tiles are read by TMA boxes of a
    // 2-D map over the pool viewed as [Hkv * P * page_size, D].
    CUtensorMap tm_q{}, tm_k{}, tm_v{};
    int tma = 0;
    if (value_pool && page_size % sm90::WBN == 0) {
      const size_t pool_rows = size_t(Hkv) * P * page_size;
      const bool ok = q_dtype == 1
          ? sm90::encode_map_2d<__nv_bfloat16>(&tm_k, k_pages, D, pool_rows, sm90::WBN) &&
                sm90::encode_map_2d<__nv_bfloat16>(&tm_v, v_pages, D, pool_rows, sm90::WBN)
          : sm90::encode_map_2d<__half>(&tm_k, k_pages, D, pool_rows, sm90::WBN) &&
                sm90::encode_map_2d<__half>(&tm_v, v_pages, D, pool_rows, sm90::WBN);
      if (!ok) return int(cudaErrorInvalidValue);
      tma = 1;
    }
    const dim3 grid(((T * G + 63) / 64) * splits, Hkv, B);
    err = q_dtype == 1 ? launch_wide_wgmma<__nv_bfloat16, true>(a, tm_q, tm_k, tm_v, tma, grid)
                       : launch_wide_wgmma<__half, true>(a, tm_q, tm_k, tm_v, tma, grid);
  } else {
    return int(cudaErrorInvalidValue);
  }
  if (err || splits == 1) return err;
  return launch_combine(part_o, part_lse, o, q_dtype, nullptr, B * Hq * T, splits, D,
                        a.stream);
}

namespace {

ws::WsVerifyArgs verify_args(int kv_kind, const float* k_scales, const float* v_scales,
                             const int* lengths, const int* page_table, int B, int Hq,
                             int Hkv, int T, int P, int page_size, int pages_per_seq, int D,
                             int splits, int f0, int f1, void* stream) {
  ws::WsVerifyArgs a{};
  a.kind = kv_kind; a.k_scales = k_scales; a.v_scales = v_scales;
  a.lengths = lengths; a.page_table = page_table;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.T = T; a.P = P; a.page_size = page_size;
  a.pages_per_seq = pages_per_seq; a.D = D; a.splits = splits;
  a.f0 = f0; a.f1 = f1;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// Route wide_scores' score pass over tiles [f0, f1) of a verify call (f =
// (b Hkv + kv head) ceil(T G / 128) + row tile): S in base-2 units into `s`
// ([(f1 - f0) 128][ceil(pages_per_seq page_size / 128) 128] fp32) and each
// row's (max, sum of exp2) of each key tile into `stats` ([(f1 - f0)
// 128][key tiles] float2), for the key tiles a row of the tile sees.  `qs`
// is q folded into rows [B Hkv][T G][D] (row t G + g) and scaled by
// sm_scale in its dtype (q_dtype 1 bf16, 2 fp16); K a pool of that dtype or
// quantized (kv_kind of paged.cuh, k_scales beside it); D a multiple of 128
// above 1024; route kRouteWideScores.  Any other call is refused with
// cudaErrorInvalidValue.  Returns the launch's error.
extern "C" int paged_verify_scores(const void* qs, int q_dtype, const void* k_pages,
    int kv_kind, const float* k_scales, const int* lengths, const int* page_table, float* s,
    void* stats, int B, int Hq, int Hkv, int T, int P, int page_size, int pages_per_seq,
    int D, float softcap, const float* slopes, int f0, int f1, int route, void* stream) {
  ws::WsVerifyArgs a = verify_args(kv_kind, k_scales, nullptr, lengths, page_table, B, Hq,
                                   Hkv, T, P, page_size, pages_per_seq, D, 1, f0, f1, stream);
  a.q = qs; a.k = k_pages; a.s = s; a.stats = static_cast<float2*>(stats);
  a.softcap = softcap; a.slopes = slopes;
  if (route != ws::kRouteWideScores || !ws::valid_verify(a, q_dtype) || qs == nullptr ||
      s == nullptr || stats == nullptr || (is_quantized(kv_kind) && k_scales == nullptr))
    return int(cudaErrorInvalidValue);
  return q_dtype == 1 ? ws::launch_verify_scores<__nv_bfloat16>(a)
                      : ws::launch_verify_scores<__half>(a);
}

// Route wide_scores' product pass over tiles [f0, f1) of a verify call, cut
// into `splits` key splits of ceil(key tiles / splits) key tiles: from the
// score pass's `s` and `stats` and the V pool (v_scales beside a quantized
// one), O in q's dtype into `o` ([B, Hq, T, D]) with one split, else each
// split's fp32 partial and lse into part_o / part_lse ([splits, B Hq T, D],
// [splits, B Hq T]) for paged_verify_combine.  The other arguments and the
// refusals as paged_verify_scores'.
extern "C" int paged_verify_product(const float* s, const void* stats, const void* v_pages,
    int q_dtype, int kv_kind, const float* v_scales, const int* lengths,
    const int* page_table, void* o, float* part_o, float* part_lse, int B, int Hq, int Hkv,
    int T, int P, int page_size, int pages_per_seq, int D, int splits, int f0, int f1,
    int route, void* stream) {
  ws::WsVerifyArgs a = verify_args(kv_kind, nullptr, v_scales, lengths, page_table, B, Hq,
                                   Hkv, T, P, page_size, pages_per_seq, D, splits, f0, f1,
                                   stream);
  a.v = v_pages; a.s = const_cast<float*>(s);
  a.stats = const_cast<float2*>(static_cast<const float2*>(stats));
  a.o = o; a.part_o = part_o; a.part_lse = part_lse;
  if (route != ws::kRouteWideScores || !ws::valid_verify(a, q_dtype) || s == nullptr ||
      stats == nullptr || (splits == 1 ? o == nullptr : part_o == nullptr || part_lse == nullptr) ||
      (is_quantized(kv_kind) && v_scales == nullptr))
    return int(cudaErrorInvalidValue);
  return q_dtype == 1 ? ws::launch_verify_product<__nv_bfloat16>(a)
                      : ws::launch_verify_product<__half>(a);
}

// The splits of a verify call merged in split order (wide.cuh
// wide_combine_kernel, ops/decode.py combine_partials): O of `rows` = B Hq T
// rows in q's dtype (1 bf16, 2 fp16) from part_o / part_lse.
extern "C" int paged_verify_combine(const float* part_o, const float* part_lse, void* o,
                                    int q_dtype, int rows, int splits, int D, void* stream) {
  if ((q_dtype != 1 && q_dtype != 2) || rows <= 0 || splits < 2 || !wide_head_dim(D) ||
      part_o == nullptr || part_lse == nullptr || o == nullptr)
    return int(cudaErrorInvalidValue);
  return launch_combine(part_o, part_lse, o, q_dtype, nullptr, rows, splits, D,
                        static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of the kernel for a q dtype code (0 fp32: the
// column-chunked kernel; else the wide_wgmma kernel at pool head dim D), in
// bytes; 0 for a head dim no kernel of paged_verify_wide takes.
extern "C" int paged_verify_wide_shared_bytes(int dtype, int D) {
  if (dtype == 0) return int(WideLayout::BYTES);
  return wide_wgmma_smem(D, false, true);
}

// Dynamic shared memory of a wide_scores verify pass's CTA in bytes
// (geometry.py wide_scores_smem_bytes): kind 0 the score pass, 1 the
// product pass; 0 for another kind.
extern "C" int paged_verify_scores_shared_bytes(int kind) {
  if (kind == 0) return int(ws::ScoreLayout<false>::BYTES);
  if (kind == 1) return int(ws::VerifyProductLayout::BYTES);
  return 0;
}

extern "C" const char* paged_verify_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* paged_verify_scores_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* paged_verify_product_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* paged_verify_combine_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
