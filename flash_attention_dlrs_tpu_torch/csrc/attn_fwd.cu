// The attention forward without segment ids: the kernels of attn_fwd.cuh
// instantiated with SEG = false (attn_fwd_seg.cu holds the other half, so the two
// compile side by side), and the wgmma kernel of attn_fwd_sm90.cuh, the route of
// every bf16/fp16 call with V of q's type.

#include "attn_fwd.cuh"
#include "attn_fwd_sm90.cuh"

extern "C" int attn_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                        const int* q_seg, const int* kv_seg, int dtype, int v_kind, int B,
                        int Hq, int Hkv, int Nq, int Nkv, int D, float sm_scale, int causal,
                        int window, float softcap, const float* slopes, float rate,
                        float keep_scale, int seed, int route, void* stream) {
  return attn_fwd_entry<false>(q, k, v, o, lse, q_seg, kv_seg, dtype, v_kind, B, Hq, Hkv,
                               Nq, Nkv, D, sm_scale, causal, window, softcap, slopes,
                               rate, keep_scale, seed, route, stream);
}

extern "C" const char* attn_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
