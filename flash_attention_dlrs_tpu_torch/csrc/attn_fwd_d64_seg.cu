// The attention forward at head dim 64 with segment ids (packed sequences): the
// kernels of attn_fwd.cuh (fp32) and attn_fwd_sm90.cuh (bf16 / fp16)
// instantiated at d 64 with SEG = true, ALiBi, dropout and fp8 V as flags.  One
// of six forward sources (a head dim and a segment-id flag each), which compile
// side by side.

#include "attn_fwd.cuh"
#include "attn_fwd_sm90.cuh"

extern "C" int attn_fwd_d64_seg(const void* q, const void* k, const void* v, void* o,
    float* lse, const int* q_seg, const int* kv_seg, int dtype, int v_kind, int B, int Hq,
    int Hkv, int Nq, int Nkv, int D, float sm_scale, int causal, int window,
    float softcap, const float* slopes, float rate, float keep_scale, int seed, int route,
    void* stream) {
  return attn_fwd_entry<true, 64>(q, k, v, o, lse, q_seg, kv_seg, dtype, v_kind, B, Hq,
      Hkv, Nq, Nkv, D, sm_scale, causal, window, softcap, slopes, rate, keep_scale, seed,
      route, stream);
}

// Dynamic shared memory of the build's kernel on a route (0 fp32, 1 wgmma)
// with (v8 1) or without fp8 V, in bytes.
extern "C" int attn_fwd_d64_seg_shared_bytes(int route, int v8) {
  return fwd_shared_bytes<true, 64>(route, v8);
}

extern "C" const char* attn_fwd_d64_seg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
