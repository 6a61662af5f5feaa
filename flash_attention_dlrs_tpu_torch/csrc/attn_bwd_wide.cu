// Attention backward sweeps at head dims above 256 (every multiple of 128):
// the kernels of wide.cuh, which says what they replace, what bounds them
// and how they are cut, on three routes (ops/bwd_kernel.py bwd_route):
// "wide_wgmma" (bf16 / fp16 up to 1024: wide_bwd_dkv_kernel and
// wide_bwd_dq_kernel, warpgroup products, TMA, S and dP once a tile, a
// cluster of CTAs; one instance a sweep, dtype and head dim) and
// "wide_fp32" (true fp32 on the CUDA cores, column-chunked), every mode a
// runtime flag.  bf16 / fp16 above 1024 take route "wide_scores"
// (attn_bwd_scores.cu).  D = rowsum(dO o O) is attn_bwd.cu's
// attn_bwd_preprocess, which takes any head dim.

#include "wide.cuh"

namespace {

int bwd_wide_entry(bool dkv, const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, void* dk, void* dv,
                   const int* q_seg, const int* kv_seg, int dtype, int B, int Hq, int Hkv,
                   int Nq, int Nkv, int D, float sm_scale, int causal, int window,
                   float softcap, const float* slopes, float rate, float keep_scale, int seed,
                   int route, void* stream) {
  if (B <= 0 || Hq <= 0 || Nq <= 0 || Nkv <= 0) return 0;
  if (!wide_head_dim(D) || Hkv <= 0 || Hq % Hkv != 0 || rate < 0.f || rate >= 1.f ||
      (q_seg == nullptr) != (kv_seg == nullptr))
    return int(cudaErrorInvalidValue);
  WideBwdArgs a{q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Nq, Nkv, D, sm_scale,
                causal, window, softcap,
                Mods{slopes, rate, keep_scale, uint32_t(seed), q_seg, kv_seg},
                static_cast<cudaStream_t>(stream)};
  if (route == kRouteWideF32 && dtype == 0) return launch_wide_bwd_chunk<float>(a, dkv);
  if (chunked_head_dim(D)) return int(cudaErrorInvalidValue);
  if (route == kRouteWideWgmma && dtype == 1) return launch_wide_bwd_wgmma<__nv_bfloat16>(a, dkv);
  if (route == kRouteWideWgmma && dtype == 2) return launch_wide_bwd_wgmma<__half>(a, dkv);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// The C entries, with the arguments of attn_bwd.cu's sweeps; D a multiple of
// 128 above 256, route kRouteWideF32 (dtype 0) or kRouteWideWgmma (dtype 1
// or 2, D at most 1024), any other call refused with cudaErrorInvalidValue.
extern "C" int attn_bwd_dkv_wide(const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, void* dk, void* dv,
    const int* q_seg, const int* kv_seg, int dtype, int B, int Hq, int Hkv, int Nq, int Nkv,
    int D, float sm_scale, int causal, int window, float softcap, const float* slopes,
    float rate, float keep_scale, int seed, int route, void* stream) {
  return bwd_wide_entry(true, q, k, v, dout, lse, delta, nullptr, dk, dv, q_seg, kv_seg, dtype,
                        B, Hq, Hkv, Nq, Nkv, D, sm_scale, causal, window, softcap, slopes,
                        rate, keep_scale, seed, route, stream);
}

extern "C" int attn_bwd_dq_wide(const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, void* dq, const int* q_seg,
    const int* kv_seg, int dtype, int B, int Hq, int Hkv, int Nq, int Nkv, int D,
    float sm_scale, int causal, int window, float softcap, const float* slopes, float rate,
    float keep_scale, int seed, int route, void* stream) {
  return bwd_wide_entry(false, q, k, v, dout, lse, delta, dq, nullptr, nullptr, q_seg, kv_seg,
                        dtype, B, Hq, Hkv, Nq, Nkv, D, sm_scale, causal, window, softcap,
                        slopes, rate, keep_scale, seed, route, stream);
}

// Dynamic shared memory of a sweep, in bytes, for a dtype code (0 fp32: the
// column-chunked kernels, one layout; else at head dim D to 1024 the wgmma
// sweeps) and flags (1: segment ids, 2: the dK/dV sweep, else dQ); 0 for a
// head dim no kernel of this build takes.
extern "C" int attn_bwd_wide_shared_bytes(int dtype, int D, int flags) {
  if (dtype == 0) return int(WideLayout<float>::BYTES);
  return wide_bwd_smem(D, (flags & 1) != 0, (flags & 2) != 0);
}

extern "C" const char* attn_bwd_dkv_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* attn_bwd_dq_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
