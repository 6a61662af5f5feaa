// Paged decode at pool head dims above 1024 (every multiple of 128): wide.cuh's
// column-chunked decode (wide_decode_chunk_kernel, route "wide_chunk"), one
// instance a pool kind, D a runtime width, its key splits merged by
// wide_combine_kernel in the same C entry.  wide.cuh says what it replaces,
// how it is built and why; paged_decode.cuh the arithmetic it keeps.  A
// source of its own, so that it compiles beside paged_decode_wide.cu.

#include "wide.cuh"

// The C entry, with the arguments of paged_decode.cu's; D a multiple of 128
// above 1024.  part_o / part_lse ([splits, B * Hq, D] and [splits, B * Hq]
// fp32) are needed at every split count: they hold the running O.  The
// counters are unused.  Returns cudaGetLastError() after the launches.
extern "C" int paged_decode_chunk(const void* q, int q_dtype, const void* k_pages,
    const void* v_pages, int kv_kind, const float* k_scales, const float* v_scales,
    const int* lengths, const int* page_table, void* o, float* lse, float* part_o,
    float* part_lse, unsigned* counters, int B, int Hq, int Hkv, int P, int page_size,
    int pages_per_seq, int D, int splits, float sm_scale, float softcap,
    const float* slopes, void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  if (!chunked_head_dim(D) || Hkv <= 0 || Hq % Hkv != 0 ||
      q_dtype < 0 || q_dtype > 2 || page_size <= 0 || (kv_kind == kI4 && page_size % 2) ||
      pages_per_seq <= 0 || splits <= 0 || splits > pages_per_seq || part_o == nullptr ||
      part_lse == nullptr ||
      (is_quantized(kv_kind) && (k_scales == nullptr || v_scales == nullptr)) ||
      kv_kind < kF32 || kv_kind > kE5M2)
    return int(cudaErrorInvalidValue);
  const int per = (pages_per_seq + splits - 1) / splits;
  if ((pages_per_seq + per - 1) / per != splits) return int(cudaErrorInvalidValue);
  const WideDecodeArgs a{q, q_dtype, k_pages, v_pages, k_scales, v_scales, lengths,
                         page_table, o, lse, part_o, part_lse, counters, B, Hq, Hkv, P,
                         page_size, pages_per_seq, splits, per, sm_scale, softcap, slopes,
                         static_cast<cudaStream_t>(stream)};
  switch (kv_kind) {
    case kF32: return launch_wide_decode_chunk<kF32>(a, D);
    case kBF16: return launch_wide_decode_chunk<kBF16>(a, D);
    case kF16: return launch_wide_decode_chunk<kF16>(a, D);
    case kI8: return launch_wide_decode_chunk<kI8>(a, D);
    case kI4: return launch_wide_decode_chunk<kI4>(a, D);
    case kE4M3: return launch_wide_decode_chunk<kE4M3>(a, D);
    default: return launch_wide_decode_chunk<kE5M2>(a, D);
  }
}

// Dynamic shared memory of the kernel, in bytes, whatever the pool kind and
// width (geometry.py wide_chunk_decode_smem_bytes).
extern "C" int paged_decode_chunk_shared_bytes() { return int(WdcLayout::BYTES); }

extern "C" const char* paged_decode_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
