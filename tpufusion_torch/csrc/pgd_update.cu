// Fused L-inf PGD update for Hopper, replacing the TPU kernel
// tpufusion/ops/pgd_update.py::pgd_update (_pgd_kernel):
//
//   adv' = clip(img + clip(adv + alpha * sign(g) - img, -eps, eps), cmin, cmax)
//
// computed in float32 and stored in the input dtype. One grid-stride pass:
// each thread moves 16 bytes of each of adv, g and img per load where the
// pointers are 16-byte aligned, and a masked scalar tail covers the rest, so
// any size is taken. alpha, eps, cmin and cmax are kernel arguments.
//
// Bound on an H100: purely memory -- 4 x 25.2 MB at (2, 1024, 1024, 3)
// float32, about 30 us at 3.35 TB/s; the kernel does 7 operations per 16
// bytes, so it can only be limited by the bytes it moves.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T>
__global__ void pgd_kernel(const T* __restrict__ adv, const T* __restrict__ grad,
                           const T* __restrict__ img, T* __restrict__ out, long long n,
                           int vectorized, float alpha, float eps, float lo, float hi) {
  constexpr int VEC = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = vectorized ? n / VEC : 0;
  const uint4* a4 = reinterpret_cast<const uint4*>(adv);
  const uint4* g4 = reinterpret_cast<const uint4*>(grad);
  const uint4* x4 = reinterpret_cast<const uint4*>(img);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  for (long long i = tid; i < nvec; i += stride) {
    const uint4 av = a4[i], gv = g4[i], xv = x4[i];
    uint4 ov;
    const T* ap = reinterpret_cast<const T*>(&av);
    const T* gp = reinterpret_cast<const T*>(&gv);
    const T* xp = reinterpret_cast<const T*>(&xv);
    T* op = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      op[k] = from_f<T>(pgd_one(to_f(ap[k]), to_f(gp[k]), to_f(xp[k]), alpha, eps, lo, hi));
    o4[i] = ov;
  }
  for (long long i = nvec * VEC + tid; i < n; i += stride)
    out[i] = from_f<T>(pgd_one(to_f(adv[i]), to_f(grad[i]), to_f(img[i]), alpha, eps, lo, hi));
}

template <typename T>
int launch(const void* adv, const void* grad, const void* img, void* out, long long n,
           int vectorized, float alpha, float eps, float lo, float hi, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const int threads = 256;
  const long long work = vectorized ? (n / VEC + n % VEC) : n;
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  pgd_kernel<T><<<(int)blocks, threads, 0, s>>>(
      static_cast<const T*>(adv), static_cast<const T*>(grad), static_cast<const T*>(img),
      static_cast<T*>(out), n, vectorized, alpha, eps, lo, hi);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tf_pgd_update(const void* adv, const void* grad, const void* img, void* out,
                             long long n, int dtype, int vectorized, float alpha, float eps,
                             float lo, float hi, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(adv, grad, img, out, n, vectorized, alpha, eps, lo, hi, s);
  return launch<__nv_bfloat16>(adv, grad, img, out, n, vectorized, alpha, eps, lo, hi, s);
}
