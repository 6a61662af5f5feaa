// Attention forward at head dims above 256 (multiples of 128 up to 1024):
// the column-chunked kernel of wide.cuh, which says what it replaces, what
// bounds it and how it is cut, on two routes (ops/fwd_kernel.py fwd_route):
// "wide_mma" (bf16 / fp16 on mma.sync) and "wide_fp32" (true fp32 on the
// CUDA cores), each with every mode as a runtime flag (one instance a
// dtype).

#include "wide.cuh"

// The C entry, with the arguments of attn_fwd.cu's (attn_fwd_entry says
// what each is); D a multiple of 128 in (256, 1024]; route kRouteWideF32
// (dtype 0) or kRouteWideMma (dtype 1 or 2), any other call refused with
// cudaErrorInvalidValue.
extern "C" int attn_fwd_wide(const void* q, const void* k, const void* v, void* o,
    float* lse, const int* q_seg, const int* kv_seg, int dtype, int v_kind, int B, int Hq,
    int Hkv, int Nq, int Nkv, int D, float sm_scale, int causal, int window,
    float softcap, const float* slopes, float rate, float keep_scale, int seed, int route,
    void* stream) {
  if (B <= 0 || Hq <= 0 || Nq <= 0) return 0;
  if (!wide_head_dim(D) || Hkv <= 0 || Hq % Hkv != 0 || Nkv < 0 || rate < 0.f ||
      rate >= 1.f || v_kind < kVSame || v_kind > kVE5M2 ||
      (q_seg != nullptr && kv_seg == nullptr && Nkv > 0))
    return int(cudaErrorInvalidValue);
  WideArgs a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = lse; a.v_kind = v_kind;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.Nq = Nq; a.Nkv = Nkv; a.D = D;
  a.sm_scale = sm_scale; a.causal = causal; a.window = window; a.softcap = softcap;
  a.md = Mods{slopes, rate, keep_scale, uint32_t(seed), q_seg, kv_seg};
  a.T = 1; a.splits = 1;
  a.stream = static_cast<cudaStream_t>(stream);
  const dim3 grid((Nq + WROWS - 1) / WROWS, D / WCOLS, B * Hq);
  if (route == kRouteWideF32 && dtype == 0) return launch_wide_fwd<float, false>(a, grid);
  if (route == kRouteWideMma && dtype == 1) return launch_wide_fwd<__nv_bfloat16, false>(a, grid);
  if (route == kRouteWideMma && dtype == 2) return launch_wide_fwd<__half, false>(a, grid);
  return int(cudaErrorInvalidValue);
}

// Dynamic shared memory of the kernel for a dtype code (0 fp32, else 16-bit).
extern "C" int attn_fwd_wide_shared_bytes(int dtype) {
  return int(dtype == 0 ? WideLayout<float>::BYTES : WideLayout<__nv_bfloat16>::BYTES);
}

extern "C" const char* attn_fwd_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
