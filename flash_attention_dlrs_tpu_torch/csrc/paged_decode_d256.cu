// Paged decode attention at pool head dim 256 (Gemma's heads): the kernel of paged_decode.cuh,
// which says what it replaces and how it is built, at d 256 for every pool
// kind, the softcap and ALiBi as flags.  One of three decode sources (a head
// dim each), which compile side by side.

#include "paged_decode.cuh"

extern "C" int paged_decode_d256(const void* q, int q_dtype, const void* k_pages,
    const void* v_pages, int kv_kind, const float* k_scales, const float* v_scales,
    const int* lengths, const int* page_table, void* o, float* lse, float* part_o,
    float* part_lse, unsigned* counters, int B, int Hq, int Hkv, int P, int page_size,
    int pages_per_seq, int D, int splits, float sm_scale, float softcap,
    const float* slopes, void* stream) {
  return paged_decode_entry<256>(q, q_dtype, k_pages, v_pages, kv_kind, k_scales, v_scales,
      lengths, page_table, o, lse, part_o, part_lse, counters, B, Hq, Hkv, P, page_size,
      pages_per_seq, D, splits, sm_scale, softcap, slopes, stream);
}

extern "C" int paged_decode_d256_shared_bytes(int kv_kind, int D) {
  return paged_decode_shared_bytes_entry<256>(kv_kind, D);
}

extern "C" const char* paged_decode_d256_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
