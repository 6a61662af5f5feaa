// The attention backward sweeps at head dim 256 (Gemma's heads) with segment
// ids (packed sequences): the kernels of attn_bwd.cuh (fp32) and
// attn_bwd_sm90.cuh (bf16 / fp16) instantiated at d 256 with SEG = true, ALiBi
// and dropout as flags.  One of six backward sources (a head dim and a
// segment-id flag each), which compile side by side.  attn_bwd_sm90.cuh says how
// the d 256 sweeps differ from the others: dK/dV in one pass on 64-key CTAs
// (scores split by keys between the consumer warpgroups, P o M and dS
// exchanged through shared memory, the updates split by columns) streaming
// 64 q rows a stage, dQ pipelined on 32-key stages; attn_bwd.cuh, how the
// fp32 ones do: 32-row steps.

#include "attn_bwd.cuh"
#include "attn_bwd_sm90.cuh"

extern "C" int attn_bwd_dkv_d256_seg(const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, void* dk, void* dv,
    const int* q_seg, const int* kv_seg, int dtype, int B, int Hq, int Hkv, int Nq,
    int Nkv, int D, float sm_scale, int causal, int window, float softcap,
    const float* slopes, float rate, float keep_scale, int seed, int route, void* stream) {
  return attn_bwd_dkv_entry<true, 256>(q, k, v, dout, lse, delta, dk, dv, q_seg, kv_seg,
      dtype, B, Hq, Hkv, Nq, Nkv, D, sm_scale, causal, window, softcap, slopes, rate,
      keep_scale, seed, route, stream);
}

extern "C" int attn_bwd_dq_d256_seg(const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, void* dq, const int* q_seg,
    const int* kv_seg, int dtype, int B, int Hq, int Hkv, int Nq, int Nkv, int D,
    float sm_scale, int causal, int window, float softcap, const float* slopes, float rate,
    float keep_scale, int seed, int route, void* stream) {
  return attn_bwd_dq_entry<true, 256>(q, k, v, dout, lse, delta, dq, q_seg, kv_seg, dtype,
      B, Hq, Hkv, Nq, Nkv, D, sm_scale, causal, window, softcap, slopes, rate, keep_scale,
      seed, route, stream);
}

// Dynamic shared memory of a sweep of the build (dkv 1: dK/dV, 0: dQ) on a
// route (0 fp32, 1 wgmma), in bytes.
extern "C" int attn_bwd_d256_seg_shared_bytes(int dkv, int route) {
  return bwd_shared_bytes<true, 256>(dkv, route);
}

extern "C" const char* attn_bwd_dkv_d256_seg_error_string(int err) { return error_string(err); }
extern "C" const char* attn_bwd_dq_d256_seg_error_string(int err) { return error_string(err); }
