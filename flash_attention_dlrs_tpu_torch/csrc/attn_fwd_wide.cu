// Attention forward at head dims above 256 (every multiple of 128): the
// kernels of wide.cuh, which says what they replace, what bounds them and
// how they are cut, on three routes (ops/fwd_kernel.py fwd_route):
// "wide_wgmma" (bf16 / fp16 up to 1024: warpgroup products, TMA, scores
// once a key tile, a cluster above 512 columns; one instance a dtype and
// head dim) and "wide_fp32" (true fp32 on the CUDA cores, column-chunked, D
// a runtime width), every mode a runtime flag.  bf16 / fp16 above 1024 take
// route "wide_scores" (attn_fwd_scores.cu).

#include "wide.cuh"

// The C entry, with the arguments of attn_fwd.cu's (attn_fwd_entry says
// what each is); D a multiple of 128 above 256; route kRouteWideF32
// (dtype 0) or kRouteWideWgmma (dtype 1 or 2, D at most 1024), any other
// call refused with cudaErrorInvalidValue.  Returns the launch's error (cudaGetLastError()
// after it), so a refused launch raises in the wrapper.
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
  const dim3 chunks((Nq + WROWS - 1) / WROWS, D / WCOLS, B * Hq);
  if (route == kRouteWideF32 && dtype == 0) return launch_wide_chunk<float, false>(a, chunks);
  if (route != kRouteWideWgmma || (dtype != 1 && dtype != 2) || !wide_cut_head_dim(D))
    return int(cudaErrorInvalidValue);
  // 3-D maps (d, N, heads): Q in boxes of 64 rows, K and V of a tile's 32
  // keys; with no keys the K / V maps cover q (no tile is loaded), fp8 V is
  // read by the producer without a map.
  const bool keys = Nkv > 0;
  CUtensorMap tm_q, tm_k, tm_v;
  auto encode = [&](auto t) {
    using T = decltype(t);
    return sm90::encode_map<T>(&tm_q, q, D, Nq, B * Hq, 64) &&
           sm90::encode_map<T>(&tm_k, keys ? k : q, D, keys ? Nkv : Nq, keys ? B * Hkv : B * Hq,
                               sm90::WBN) &&
           sm90::encode_map<T>(&tm_v, keys && v_kind == kVSame ? v : q, D,
                               keys && v_kind == kVSame ? Nkv : Nq,
                               keys && v_kind == kVSame ? B * Hkv : B * Hq, sm90::WBN);
  };
  const dim3 grid((Nq + 63) / 64, B * Hq);
  if (dtype == 1) {
    if (!encode(__nv_bfloat16{})) return int(cudaErrorInvalidValue);
    return launch_wide_wgmma<__nv_bfloat16, false>(a, tm_q, tm_k, tm_v, 0, grid);
  }
  if (!encode(__half{})) return int(cudaErrorInvalidValue);
  return launch_wide_wgmma<__half, false>(a, tm_q, tm_k, tm_v, 0, grid);
}

// Dynamic shared memory of the kernel, in bytes, for a dtype code (0 fp32:
// the column-chunked kernel, one layout; else at head dim D to 1024 the
// wide_wgmma kernel) and mode flags (1: segment ids, 2: fp8 V, 4: the layout
// of paged verify); 0 for a head dim no kernel of this build takes.
extern "C" int attn_fwd_wide_shared_bytes(int dtype, int D, int flags) {
  if (dtype == 0) return int(WideLayout<float>::BYTES);
  return wide_wgmma_smem(D, (flags & 1) != 0, (flags & 4) != 0);
}

extern "C" const char* attn_fwd_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
