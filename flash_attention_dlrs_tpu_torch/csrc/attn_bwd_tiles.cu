// The attention backward sweeps on streamed tiles other than a head dim's
// own: the wgmma sweeps of attn_bwd_sm90.cuh streaming 32 rows a stage at
// d 64 and d 128 (4 stages; the builds of attn_bwd.cu and attn_bwd_d64.cu
// stream 64), bf16 and fp16, without ALiBi, dropout or segment ids.  Causal
// masking, the window, the softcap and GQA are runtime arguments.  The
// tuner (flash_attention_dlrs_tpu_torch/tuning.py) times them beside the
// builds' own stages; a source of its own, so that it compiles beside the
// others.

#include "attn_bwd.cuh"
#include "attn_bwd_sm90.cuh"

// The arguments of attn_bwd_dkv_entry (attn_bwd.cuh) and the streamed tile:
// 32 at D 64 or 128 on the wgmma route (bf16 / fp16), with no mode.  Any
// other tile, route, head dim or mode returns cudaErrorInvalidValue,
// launching nothing.
extern "C" int attn_bwd_dkv_tiles(const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, void* dk, void* dv,
    const int* q_seg, const int* kv_seg, int dtype, int B, int Hq, int Hkv, int Nq,
    int Nkv, int D, float sm_scale, int causal, int window, float softcap,
    const float* slopes, float rate, float keep_scale, int seed, int tile, int route,
    void* stream) {
  if (tile != 32 || q_seg != nullptr || kv_seg != nullptr) return int(cudaErrorInvalidValue);
  if (D == 64)
    return attn_bwd_dkv_entry<false, 64, 32>(q, k, v, dout, lse, delta, dk, dv, q_seg,
        kv_seg, dtype, B, Hq, Hkv, Nq, Nkv, D, sm_scale, causal, window, softcap, slopes,
        rate, keep_scale, seed, route, stream);
  if (D == 128)
    return attn_bwd_dkv_entry<false, 128, 32>(q, k, v, dout, lse, delta, dk, dv, q_seg,
        kv_seg, dtype, B, Hq, Hkv, Nq, Nkv, D, sm_scale, causal, window, softcap, slopes,
        rate, keep_scale, seed, route, stream);
  return int(cudaErrorInvalidValue);
}

// The dQ sweep, as attn_bwd_dkv_tiles.
extern "C" int attn_bwd_dq_tiles(const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, void* dq, const int* q_seg,
    const int* kv_seg, int dtype, int B, int Hq, int Hkv, int Nq, int Nkv, int D,
    float sm_scale, int causal, int window, float softcap, const float* slopes, float rate,
    float keep_scale, int seed, int tile, int route, void* stream) {
  if (tile != 32 || q_seg != nullptr || kv_seg != nullptr) return int(cudaErrorInvalidValue);
  if (D == 64)
    return attn_bwd_dq_entry<false, 64, 32>(q, k, v, dout, lse, delta, dq, q_seg, kv_seg,
        dtype, B, Hq, Hkv, Nq, Nkv, D, sm_scale, causal, window, softcap, slopes, rate,
        keep_scale, seed, route, stream);
  if (D == 128)
    return attn_bwd_dq_entry<false, 128, 32>(q, k, v, dout, lse, delta, dq, q_seg, kv_seg,
        dtype, B, Hq, Hkv, Nq, Nkv, D, sm_scale, causal, window, softcap, slopes, rate,
        keep_scale, seed, route, stream);
  return int(cudaErrorInvalidValue);
}

// Dynamic shared memory of a sweep (dkv 1: dK/dV, 0: dQ) at head dim D
// streaming `tile` rows a stage, in bytes; -1 for a tile it was not built
// with.
extern "C" int attn_bwd_tiles_shared_bytes(int dkv, int D, int tile) {
  if (tile != 32) return -1;
  if (D == 64) return bwd_shared_bytes<false, 64, 32, 32>(dkv, kRouteWgmma);
  if (D == 128) return bwd_shared_bytes<false, 128, 32, 32>(dkv, kRouteWgmma);
  return -1;
}

extern "C" const char* attn_bwd_dkv_tiles_error_string(int err) { return error_string(err); }
extern "C" const char* attn_bwd_dq_tiles_error_string(int err) { return error_string(err); }
