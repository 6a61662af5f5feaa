// The attention forward on key tiles other than a head dim's own: the wgmma
// kernel of attn_fwd_sm90.cuh on 64-key tiles at d 64 and d 128 (4 stages;
// the builds of attn_fwd.cu and attn_fwd_d64.cu take 128-key tiles), bf16
// and fp16, without ALiBi, dropout, segment ids or fp8 V.  Causal masking,
// the window, the softcap and GQA are runtime arguments, so these instances
// take the serving prefill, training and the encoder.  The tuner
// (flash_attention_dlrs_tpu_torch/tuning.py) times them beside the builds'
// own tiles; a source of its own, so that it compiles beside the others.

#include "attn_fwd.cuh"
#include "attn_fwd_sm90.cuh"

// The arguments of attn_fwd_entry (attn_fwd.cuh) and the key tile: 64 at
// D 64 or 128 on the wgmma route (bf16 / fp16), with no mode.  Any other
// tile, route, head dim or mode returns cudaErrorInvalidValue, launching
// nothing.
extern "C" int attn_fwd_tiles(const void* q, const void* k, const void* v, void* o,
    float* lse, const int* q_seg, const int* kv_seg, int dtype, int v_kind, int B, int Hq,
    int Hkv, int Nq, int Nkv, int D, float sm_scale, int causal, int window,
    float softcap, const float* slopes, float rate, float keep_scale, int seed, int tile,
    int route, void* stream) {
  if (tile != 64 || q_seg != nullptr || kv_seg != nullptr) return int(cudaErrorInvalidValue);
  if (D == 64)
    return attn_fwd_entry<false, 64, 64>(q, k, v, o, lse, q_seg, kv_seg, dtype, v_kind, B,
        Hq, Hkv, Nq, Nkv, D, sm_scale, causal, window, softcap, slopes, rate, keep_scale,
        seed, route, stream);
  if (D == 128)
    return attn_fwd_entry<false, 128, 64>(q, k, v, o, lse, q_seg, kv_seg, dtype, v_kind, B,
        Hq, Hkv, Nq, Nkv, D, sm_scale, causal, window, softcap, slopes, rate, keep_scale,
        seed, route, stream);
  return int(cudaErrorInvalidValue);
}

// Dynamic shared memory of the build's kernel at head dim D on tiles of
// `tile` keys, in bytes; -1 for a tile it was not built with.
extern "C" int attn_fwd_tiles_shared_bytes(int D, int tile) {
  if (tile != 64) return -1;
  if (D == 64) return fwd_shared_bytes<false, 64, 64>(kRouteWgmma, 0);
  if (D == 128) return fwd_shared_bytes<false, 128, 64>(kRouteWgmma, 0);
  return -1;
}

extern "C" const char* attn_fwd_tiles_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
