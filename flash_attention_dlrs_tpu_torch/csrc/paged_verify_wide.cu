// Paged multi-token verify at pool head dims above 256 (every multiple of
// 128): wide.cuh's forward kernels over the T x G rows of a kv head, keys
// gathered through the page table and converted exactly to q's dtype
// (payloads unscaled; K scales on S, V scales on P), q pre-scaled in its
// dtype, on the routes "wide_wgmma" (bf16 / fp16 q up to 1024, value pools
// of q's dtype or quantized pools: warpgroup products, scores once a key
// tile), "wide_chunk" (the same q and pools above 1024, column-chunked on
// mma.sync) and "wide_fp32" (fp32 q, any pool, column-chunked); its key
// splits merged by wide_combine_kernel in the same C entry.

#include "wide.cuh"

// The C entry, with the arguments of paged_verify.cu's; D a multiple of 128
// above 256 (at most 1024 on kRouteWideWgmma, above it on kRouteWideChunk).
// Returns cudaGetLastError() after the launches.
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
      (route == kRouteWideWgmma && !wide_cut_head_dim(D)) ||
      (route == kRouteWideChunk && !chunked_head_dim(D)))
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
  const dim3 chunks((T * G + WROWS - 1) / WROWS, (D / WCOLS) * splits, B * Hkv);
  if (route == kRouteWideF32 && q_dtype == 0) {
    err = launch_wide_chunk<float, true>(a, chunks);
  } else if (route == kRouteWideChunk && (q_dtype == 1 || q_dtype == 2)) {
    err = q_dtype == 1 ? launch_wide_chunk<__nv_bfloat16, true>(a, chunks)
                       : launch_wide_chunk<__half, true>(a, chunks);
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

// Dynamic shared memory of the kernel for a q dtype code (0 fp32: the
// column-chunked kernel; else at pool head dim D the wide_wgmma kernel, or
// above 1024 the 16-bit column-chunked one), in bytes; 0 for a head dim no
// kernel takes.
extern "C" int paged_verify_wide_shared_bytes(int dtype, int D) {
  if (dtype == 0) return int(WideLayout<float>::BYTES);
  if (chunked_head_dim(D))
    return int(dtype == 1 ? WideLayout<__nv_bfloat16>::BYTES : WideLayout<__half>::BYTES);
  return wide_wgmma_smem(D, false, true);
}

extern "C" const char* paged_verify_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
