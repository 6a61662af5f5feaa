// Paged decode at pool head dims above 256 (multiples of 128 up to 1024):
// wide.cuh's split-KV kernel on the CUDA cores, one instance a pool kind,
// its key splits merged by wide_combine_kernel in the same C entry.
// wide.cuh says what it replaces; paged_decode.cuh the arithmetic it keeps.
// Decode is bound by bytes (every live K / V row read once).

#include "wide.cuh"

// The C entry, with the arguments of paged_decode.cu's (the counters are
// not used: the splits merge in a second kernel); D a multiple of 128 in
// (256, 1024].  Returns cudaGetLastError() after the launches.
extern "C" int paged_decode_wide(const void* q, int q_dtype, const void* k_pages,
    const void* v_pages, int kv_kind, const float* k_scales, const float* v_scales,
    const int* lengths, const int* page_table, void* o, float* lse, float* part_o,
    float* part_lse, unsigned* counters, int B, int Hq, int Hkv, int P, int page_size,
    int pages_per_seq, int D, int splits, float sm_scale, float softcap,
    const float* slopes, void* stream) {
  (void)counters;
  if (B <= 0) return 0;
  if (!wide_head_dim(D) || Hkv <= 0 || Hq % Hkv != 0 || q_dtype < 0 || q_dtype > 2 ||
      page_size <= 0 || (kv_kind == kI4 && page_size % 2) || pages_per_seq <= 0 ||
      splits <= 0 || splits > pages_per_seq ||
      (splits > 1 && (part_o == nullptr || part_lse == nullptr)) ||
      (is_quantized(kv_kind) && (k_scales == nullptr || v_scales == nullptr)))
    return int(cudaErrorInvalidValue);
  const int per = (pages_per_seq + splits - 1) / splits;
  WideDecodeArgs a{q, q_dtype, k_pages, v_pages, k_scales, v_scales, lengths, page_table,
                   o, lse, part_o, part_lse, B, Hq, Hkv, P, page_size, pages_per_seq, D,
                   splits, per, sm_scale, softcap, slopes, static_cast<cudaStream_t>(stream)};
  switch (kv_kind) {
    case kF32: return launch_wide_decode<kF32>(a);
    case kBF16: return launch_wide_decode<kBF16>(a);
    case kF16: return launch_wide_decode<kF16>(a);
    case kI8: return launch_wide_decode<kI8>(a);
    case kI4: return launch_wide_decode<kI4>(a);
    case kE4M3: return launch_wide_decode<kE4M3>(a);
    case kE5M2: return launch_wide_decode<kE5M2>(a);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* paged_decode_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
