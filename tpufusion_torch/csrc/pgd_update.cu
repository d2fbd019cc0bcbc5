// Fused L-inf PGD update for Hopper, replacing the TPU kernel
// tpufusion/ops/pgd_update.py::pgd_update (_pgd_kernel):
//
//   adv' = clip(img + clip(adv + alpha * sign(g) - img, -eps, eps), cmin, cmax)
//
// computed in float32 and stored in the input dtype, any size. alpha, eps,
// cmin and cmax are kernel arguments.
//
// Bound on an H100: purely memory -- 4 x 25.2 MB at (2, 1024, 1024, 3)
// float32, about 30 us at 3.35 TB/s; the kernel does 7 operations per
// element, so it can only be limited by the bytes it moves. The streaming
// design (evict-first 16-byte loads and stores, a scalar head and tail, the
// grid picked by size) is in pixel_stream.cuh.
#include <cuda_bf16.h>

#include "pixel_stream.cuh"

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float pgd_one(float a, float g, float x, float alpha, float eps,
                                         float lo, float hi) {
  const float sgn = g > 0.f ? 1.f : (g < 0.f ? -1.f : 0.f);
  const float d = fminf(fmaxf(a + alpha * sgn - x, -eps), eps);
  return fminf(fmaxf(x + d, lo), hi);
}

// the waves grid from 32 MB of each stream (5 x 1024^2 x 3 float32 and up);
// below, the persistent one (pixel_stream.cuh)
constexpr long long kWavesFrom = 32ll << 20;

// streams: in = (adv, grad, img), out = (out)
template <typename T>
struct PgdOp {
  float alpha, eps, lo, hi;
  __device__ __forceinline__ void operator()(const T (&in)[3], T (&out)[1]) const {
    out[0] = from_f<T>(pgd_one(to_f(in[0]), to_f(in[1]), to_f(in[2]), alpha, eps, lo, hi));
  }
};

template <typename T>
int launch(const void* adv, const void* grad, const void* img, void* out, long long n,
           float alpha, float eps, float lo, float hi, cudaStream_t s) {
  tf_stream::Streams<T, 3, 1> st{
      {static_cast<const T*>(adv), static_cast<const T*>(grad), static_cast<const T*>(img)},
      {static_cast<T*>(out)}};
  return tf_stream::launch(st, n, PgdOp<T>{alpha, eps, lo, hi}, kWavesFrom, s);
}

}  // namespace

extern "C" int tf_pgd_update(const void* adv, const void* grad, const void* img, void* out,
                             long long n, int dtype, float alpha, float eps, float lo,
                             float hi, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(adv, grad, img, out, n, alpha, eps, lo, hi, s);
  return launch<__nv_bfloat16>(adv, grad, img, out, n, alpha, eps, lo, hi, s);
}
