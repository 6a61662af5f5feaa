// Multi-token paged attention (speculative verify, chunked prefill) at pool
// head dim 256 (Gemma's heads) from fp16 q: the kernels of paged_verify.cuh
// at d 256 for every pool kind, the softcap and ALiBi as flags.  The fp16-q
// half of paged_verify_d256.cu (fp32 and bf16 q), split off so that the two
// halves of the slowest source compile side by side.

#include "paged_verify.cuh"

extern "C" int paged_verify_d256_f16(const void* q, int q_dtype, const void* k_pages,
    const void* v_pages, int kv_kind, const float* k_scales, const float* v_scales,
    const int* lengths, const int* page_table, void* o, float* part_o, float* part_lse,
    int B, int Hq, int Hkv, int T, int P, int page_size, int pages_per_seq, int D,
    int splits, float scale_q, float softcap, const float* slopes, int route,
    void* stream) {
  return paged_verify_entry<256, 4>(q, q_dtype, k_pages, v_pages, kv_kind, k_scales,
      v_scales, lengths, page_table, o, part_o, part_lse, B, Hq, Hkv, T, P, page_size,
      pages_per_seq, D, splits, scale_q, softcap, slopes, route, stream);
}

extern "C" int paged_verify_d256_f16_shared_bytes(int route, int D) {
  return paged_verify_shared_bytes_entry<256, 4>(route, D);
}

extern "C" const char* paged_verify_d256_f16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
