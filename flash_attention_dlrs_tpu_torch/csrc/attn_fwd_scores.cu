// The attention forward above head dim 1024 in bf16 / fp16 (route
// "wide_scores"): the score pass and the product pass of wide_scores.cuh,
// which says what they replace, what bounds them and how they are cut.  The
// caller (ops/wide_scores.py) allocates the scratch and runs the passes
// wave by wave.

#include "wide_scores.cuh"

namespace {

ws::WsArgs fwd_args(const void* q, const void* k, const void* v, const int* q_seg,
                    const int* kv_seg, int v_kind, int B, int Hq, int Hkv, int Nq, int Nkv, int D,
                    float sm_scale, int causal, int window, float softcap, const float* slopes,
                    float rate, float keep_scale, int seed, int f0, int f1, void* stream) {
  ws::WsArgs a{};
  a.q = q; a.k = k; a.v = v; a.v_kind = v_kind;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.Nq = Nq; a.Nkv = Nkv; a.D = D;
  a.sm_scale = sm_scale; a.causal = causal; a.window = window; a.softcap = softcap;
  a.md = Mods{slopes, rate, keep_scale, uint32_t(seed), q_seg, kv_seg};
  a.f0 = f0; a.f1 = f1;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// The score pass of tiles [f0, f1) (f = (b Hq + h) ceil(Nq / 128) + q
// tile): S in base-2 units into `s` ([(f1 - f0) 128][ceil(Nkv / 128) 128]
// fp32) and each row's (max, sum of exp2) of each key tile into `stats`
// ([(f1 - f0) 128][ceil(Nkv / 128)] float2), for the tiles the mask lets
// through.  dtype 1 (bf16) or 2 (fp16), D a multiple of 128 above 1024,
// route kRouteWideScores; any other call is refused with
// cudaErrorInvalidValue.  Returns the launch's error.
extern "C" int attn_fwd_scores(const void* q, const void* k, float* s, void* stats,
    const int* q_seg, const int* kv_seg, int dtype, int B, int Hq, int Hkv, int Nq, int Nkv,
    int D, float sm_scale, int causal, int window, float softcap, const float* slopes,
    float rate, float keep_scale, int seed, int f0, int f1, int route, void* stream) {
  ws::WsArgs a = fwd_args(q, k, nullptr, q_seg, kv_seg, kVSame, B, Hq, Hkv, Nq, Nkv, D,
                          sm_scale, causal, window, softcap, slopes, rate, keep_scale, seed,
                          f0, f1, stream);
  a.s = s;
  a.stats = static_cast<float2*>(stats);
  if (route != ws::kRouteWideScores || !ws::valid_call(a) || s == nullptr || stats == nullptr)
    return int(cudaErrorInvalidValue);
  if (dtype == 1) return ws::launch_fwd_scores<__nv_bfloat16>(a);
  if (dtype == 2) return ws::launch_fwd_scores<__half>(a);
  return int(cudaErrorInvalidValue);
}

// The product pass of tiles [f0, f1): O (in q's dtype) and lse (fp32,
// natural base) of their rows from the score pass's `s` and `stats` and V
// (of q's dtype, v_kind 0, or fp8: 1 e4m3, 2 e5m2); the arguments and the
// refusals as attn_fwd_scores.
extern "C" int attn_fwd_product(const void* s, const void* stats, const void* v, void* o,
    float* lse, int dtype, int v_kind, int B, int Hq, int Hkv, int Nq, int Nkv, int D,
    float sm_scale, int causal, int window, float softcap, const float* slopes, float rate,
    float keep_scale, int seed, int f0, int f1, int route, void* stream) {
  ws::WsArgs a = fwd_args(nullptr, nullptr, v, nullptr, nullptr, v_kind, B, Hq, Hkv, Nq, Nkv,
                          D, sm_scale, causal, window, softcap, slopes, rate, keep_scale, seed,
                          f0, f1, stream);
  a.q = o;  // a valid address for the unused V map of fp8 V
  a.s = const_cast<float*>(static_cast<const float*>(s));
  a.stats = const_cast<float2*>(static_cast<const float2*>(stats));
  a.o = o;
  a.lse_out = lse;
  if (route != ws::kRouteWideScores || !ws::valid_call(a) || v_kind < kVSame ||
      v_kind > kVE5M2 || s == nullptr || stats == nullptr)
    return int(cudaErrorInvalidValue);
  if (dtype == 1) return ws::launch_product<__nv_bfloat16, ws::kProductO>(a);
  if (dtype == 2) return ws::launch_product<__half, ws::kProductO>(a);
  return int(cudaErrorInvalidValue);
}

// Dynamic shared memory of a forward pass's CTA in bytes (geometry.py
// wide_scores_smem_bytes): kind 0 the score pass, 1 the product pass; 0 for
// another kind.
extern "C" int attn_fwd_scores_shared_bytes(int kind) {
  if (kind == 0) return int(ws::ScoreLayout<false>::BYTES);
  if (kind == 1) return int(ws::ProductLayout<ws::kProductO>::BYTES);
  return 0;
}

extern "C" const char* attn_fwd_scores_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* attn_fwd_product_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
