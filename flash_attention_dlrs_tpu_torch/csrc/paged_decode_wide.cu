// Paged decode at pool head dims above 256 (multiples of 128 up to 1024):
// wide.cuh's split-KV kernel on asynchronous page copies, one instance a
// pool kind and width, its key splits merged inside the launch by the last
// CTA of each group.  wide.cuh says what it replaces and how it is built;
// paged_decode.cuh the arithmetic it keeps.  Decode is bound by bytes
// (every live K / V row read once).

#include "wide.cuh"

// The C entry, with the arguments of paged_decode.cu's; D a multiple of 128
// in (256, 1024].  Above one split, counters [B, Hkv, ceil(Hq / Hkv / 2)]
// uint32, zero before the call and zero after it (no two calls may share
// them at once).  Returns cudaGetLastError() after the launch.
extern "C" int paged_decode_wide(const void* q, int q_dtype, const void* k_pages,
    const void* v_pages, int kv_kind, const float* k_scales, const float* v_scales,
    const int* lengths, const int* page_table, void* o, float* lse, float* part_o,
    float* part_lse, unsigned* counters, int B, int Hq, int Hkv, int P, int page_size,
    int pages_per_seq, int D, int splits, float sm_scale, float softcap,
    const float* slopes, void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  if (!wide_head_dim(D) || Hkv <= 0 || Hq % Hkv != 0 || q_dtype < 0 || q_dtype > 2 ||
      page_size <= 0 || (kv_kind == kI4 && page_size % 2) || pages_per_seq <= 0 ||
      splits <= 0 || splits > pages_per_seq ||
      (splits > 1 && (part_o == nullptr || part_lse == nullptr || counters == nullptr)) ||
      (is_quantized(kv_kind) && (k_scales == nullptr || v_scales == nullptr)) ||
      kv_kind < kF32 || kv_kind > kE5M2)
    return int(cudaErrorInvalidValue);
  const int per = (pages_per_seq + splits - 1) / splits;
  if ((pages_per_seq + per - 1) / per != splits) return int(cudaErrorInvalidValue);
  const WideDecodeArgs a{q, q_dtype, k_pages, v_pages, k_scales, v_scales, lengths,
                         page_table, o, lse, part_o, part_lse, counters, B, Hq, Hkv, P,
                         page_size, pages_per_seq, splits, per, sm_scale, softcap, slopes,
                         static_cast<cudaStream_t>(stream)};
  return wide_decode_instance(kv_kind, D, [&](auto kind, auto nb) {
    return launch_wide_decode<decltype(kind)::value, decltype(nb)::value>(a);
  });
}

// Dynamic shared memory of the decode instance for (kv_kind, D), in bytes
// (geometry.py wide_decode_smem_bytes); 0 for a pair no instance takes.
extern "C" int paged_decode_wide_shared_bytes(int kv_kind, int D) {
  return wide_decode_smem(kv_kind, D);
}

// CTAs of that instance one SM holds at once, by the runtime's occupancy
// calculator after the instance's shared-memory opt-in (WdLayout::CTAS is
// the design's); 0 for a pair no instance takes, -1 where the runtime
// refuses.  (Here and not in wide.cuh: naming every instance's kernel
// would compile them into each source that includes it.)
extern "C" int paged_decode_wide_ctas_per_sm(int kv_kind, int D) {
  return wide_decode_instance(kv_kind, D, [](auto kind, auto nb) {
    using L = WdLayout<decltype(kind)::value, decltype(nb)::value>;
    auto kernel = wide_decode_kernel<decltype(kind)::value, decltype(nb)::value>;
    int n = 0;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(L::BYTES)) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, WD_THREADS, L::BYTES) !=
            cudaSuccess)
      return -1;
    return n;
  });
}

extern "C" const char* paged_decode_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
