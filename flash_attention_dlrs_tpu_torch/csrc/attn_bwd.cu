// The attention backward at head dim 128 without segment ids, and the D
// preprocess (any head dim): the sweeps of attn_bwd.cuh (fp32) and
// attn_bwd_sm90.cuh (bf16 / fp16) instantiated at d 128 with SEG = false,
// ALiBi and dropout as flags.  One of six backward sources (a head dim and
// a segment-id flag each), which compile side by side.

#include "attn_bwd.cuh"
#include "attn_bwd_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// D = rowsum(O * dO)
// ---------------------------------------------------------------------------

constexpr int PRE_THREADS = 256;  // one warp per row

template <typename T>
__global__ void __launch_bounds__(PRE_THREADS)
attn_bwd_preprocess_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ delta, int rows, int D) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (PRE_THREADS / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const T* op = o + size_t(row) * D;
  const T* dp = dout + size_t(row) * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_float(op[c]), to_float(dp[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

}  // namespace

// delta[r] = sum_c o[r, c] * dout[r, c] in fp32, for `rows` rows of D.
extern "C" int attn_bwd_preprocess(const void* o, const void* dout, float* delta,
                                   int dtype, int rows, int D, void* stream) {
  if (rows <= 0) return 0;
  const dim3 grid((rows + PRE_THREADS / 32 - 1) / (PRE_THREADS / 32));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      attn_bwd_preprocess_kernel<float><<<grid, PRE_THREADS, 0, s>>>(
          static_cast<const float*>(o), static_cast<const float*>(dout), delta, rows, D);
      break;
    case 1:
      attn_bwd_preprocess_kernel<__nv_bfloat16><<<grid, PRE_THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
          delta, rows, D);
      break;
    case 2:
      attn_bwd_preprocess_kernel<__half><<<grid, PRE_THREADS, 0, s>>>(
          static_cast<const __half*>(o), static_cast<const __half*>(dout), delta, rows, D);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

extern "C" int attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dk, void* dv,
                            const int* q_seg, const int* kv_seg, int dtype, int B, int Hq,
                            int Hkv, int Nq, int Nkv, int D, float sm_scale, int causal,
                            int window, float softcap, const float* slopes, float rate,
                            float keep_scale, int seed, int route, void* stream) {
  return attn_bwd_dkv_entry<false, 128>(q, k, v, dout, lse, delta, dk, dv, q_seg, kv_seg,
                                          dtype, B, Hq, Hkv, Nq, Nkv, D, sm_scale, causal,
                                          window, softcap, slopes, rate, keep_scale, seed,
                                          route, stream);
}

extern "C" int attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dq, const int* q_seg,
                           const int* kv_seg, int dtype, int B, int Hq, int Hkv, int Nq,
                           int Nkv, int D, float sm_scale, int causal, int window,
                           float softcap, const float* slopes, float rate, float keep_scale,
                           int seed, int route, void* stream) {
  return attn_bwd_dq_entry<false, 128>(q, k, v, dout, lse, delta, dq, q_seg, kv_seg,
                                         dtype, B, Hq, Hkv, Nq, Nkv, D, sm_scale, causal,
                                         window, softcap, slopes, rate, keep_scale, seed,
                                         route, stream);
}

// Dynamic shared memory of a sweep of the build (dkv 1: dK/dV, 0: dQ) on a
// route (0 fp32, 1 wgmma), in bytes.
extern "C" int attn_bwd_shared_bytes(int dkv, int route) {
  return bwd_shared_bytes<false, 128>(dkv, route);
}

extern "C" const char* attn_bwd_preprocess_error_string(int err) { return error_string(err); }
extern "C" const char* attn_bwd_dkv_error_string(int err) { return error_string(err); }
extern "C" const char* attn_bwd_dq_error_string(int err) { return error_string(err); }
