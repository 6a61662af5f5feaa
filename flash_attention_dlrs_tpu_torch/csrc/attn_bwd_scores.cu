// The attention backward sweeps above head dim 1024 in bf16 / fp16 (route
// "wide_scores"): the backward score pass and the dK / dV and dQ product
// passes of wide_scores.cuh, which says what they replace, what bounds them
// and how they are cut.  The caller (ops/wide_scores.py) runs
// attn_bwd.cu's preprocess first, allocates the scratch and runs the passes
// wave by wave.

#include "wide_scores.cuh"

namespace {

ws::WsArgs bwd_args(const void* q, const void* k, const void* v, const void* dout, int B,
                    int Hq, int Hkv, int Nq, int Nkv, int D, float sm_scale, int causal,
                    int window, float softcap, const float* slopes, float rate,
                    float keep_scale, int seed, const int* q_seg, const int* kv_seg, int f0,
                    int f1, void* stream) {
  ws::WsArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.v_kind = kVSame;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.Nq = Nq; a.Nkv = Nkv; a.D = D;
  a.sm_scale = sm_scale; a.causal = causal; a.window = window; a.softcap = softcap;
  a.md = Mods{slopes, rate, keep_scale, uint32_t(seed), q_seg, kv_seg};
  a.f0 = f0; a.f1 = f1;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// The backward score pass of tiles [f0, f1) (f = (b Hq + h) ceil(Nq / 128)
// + q tile): P o M and dS rounded to q's dtype into `p` and `ds` ([(f1 -
// f0) 128][ceil(Nkv / 128) 128] each), for the tiles the mask lets through,
// from the forward's lse and the preprocess's delta.  dtype 1 (bf16) or 2
// (fp16), D a multiple of 128 above 1024, route kRouteWideScores; any other
// call is refused with cudaErrorInvalidValue.  Returns the launch's error.
extern "C" int attn_bwd_scores(const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* p, void* ds, const int* q_seg,
    const int* kv_seg, int dtype, int B, int Hq, int Hkv, int Nq, int Nkv, int D,
    float sm_scale, int causal, int window, float softcap, const float* slopes, float rate,
    float keep_scale, int seed, int f0, int f1, int route, void* stream) {
  ws::WsArgs a = bwd_args(q, k, v, dout, B, Hq, Hkv, Nq, Nkv, D, sm_scale, causal, window,
                          softcap, slopes, rate, keep_scale, seed, q_seg, kv_seg, f0, f1, stream);
  a.lse = lse;
  a.delta = delta;
  a.p = p;
  a.ds = ds;
  if (route != ws::kRouteWideScores || !ws::valid_call(a) || p == nullptr || ds == nullptr)
    return int(cudaErrorInvalidValue);
  if (dtype == 1) return ws::launch_bwd_scores<__nv_bfloat16>(a);
  if (dtype == 2) return ws::launch_bwd_scores<__half>(a);
  return int(cudaErrorInvalidValue);
}

// A backward product pass of tiles [f0, f1): kind 1 dQ = sm_scale dS K of
// their rows (from `ds`); kind 2 dV = (P o M)^T dO and dK = sm_scale dS^T Q
// of the kv heads they touch (from `p` and `ds`), carried in `dk_acc` /
// `dv_acc` (fp32, dK's shape; null when one wave covers the call) where a
// kv head's tiles run on in another wave: the first wave of a head starts
// from 0, its last writes dK / dV in q's dtype.  The arguments and refusals
// as attn_bwd_scores.
extern "C" int attn_bwd_product(const void* p, const void* ds, const void* q, const void* k,
    const void* dout, void* dq, void* dk, void* dv, float* dk_acc, float* dv_acc, int kind,
    int dtype, int B, int Hq, int Hkv, int Nq, int Nkv, int D, float sm_scale, int causal,
    int window, int f0, int f1, int route, void* stream) {
  ws::WsArgs a = bwd_args(q, k, nullptr, dout, B, Hq, Hkv, Nq, Nkv, D, sm_scale, causal, window,
                          0.f, nullptr, 0.f, 1.f, 0, nullptr, nullptr, f0, f1, stream);
  a.p = const_cast<void*>(p);
  a.ds = const_cast<void*>(ds);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.dk_acc = dk_acc; a.dv_acc = dv_acc;
  if (route != ws::kRouteWideScores || !ws::valid_call(a) || ds == nullptr)
    return int(cudaErrorInvalidValue);
  if (kind == ws::kProductDq && dq != nullptr) {
    if (dtype == 1) return ws::launch_product<__nv_bfloat16, ws::kProductDq>(a);
    if (dtype == 2) return ws::launch_product<__half, ws::kProductDq>(a);
  }
  if (kind == ws::kProductDkv && p != nullptr && dk != nullptr && dv != nullptr) {
    // a wave that ends or starts inside a kv head's tiles carries its sum
    const int per_kv = Hq / Hkv * ws::cdiv(Nq, ws::BM);
    if ((f0 % per_kv != 0 || f1 % per_kv != 0) && (dk_acc == nullptr || dv_acc == nullptr))
      return int(cudaErrorInvalidValue);
    if (dtype == 1) return ws::launch_product<__nv_bfloat16, ws::kProductDkv>(a);
    if (dtype == 2) return ws::launch_product<__half, ws::kProductDkv>(a);
  }
  return int(cudaErrorInvalidValue);
}

// Dynamic shared memory of a backward pass's CTA in bytes (geometry.py
// wide_scores_smem_bytes): kind 0 the score pass, 1 the dQ product, 2 the
// dK / dV product; 0 for another kind.
extern "C" int attn_bwd_scores_shared_bytes(int kind) {
  if (kind == 0) return int(ws::ScoreLayout<true>::BYTES);
  if (kind == 1) return int(ws::ProductLayout<ws::kProductDq>::BYTES);
  if (kind == 2) return int(ws::ProductLayout<ws::kProductDkv>::BYTES);
  return 0;
}

extern "C" const char* attn_bwd_scores_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* attn_bwd_product_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
