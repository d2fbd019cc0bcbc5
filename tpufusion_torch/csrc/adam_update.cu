// Fused Adam pixel update for Hopper, replacing the TPU kernel
// tpufusion/ops/adam_update.py::_pallas_adam (_adam_kernel): one
// optax-default Adam step (b1 0.9, b2 0.999, eps 1e-8) over a float32 pixel
// buffer, with x, mu and nu written in place:
//
//   mu' = B1*mu + (1-B1)*g        nu' = B2*nu + ((1-B2)*g)*g
//   x'  = x - lr * ((mu'/bc1) / (sqrt(nu'/bc2) + EPS))
//
// lr, bc1 = 1 - B1^t and bc2 = 1 - B2^t are kernel arguments (the wrapper
// computes them once per step in float32). Every operation is spelled with
// a round-to-nearest intrinsic, so nvcc cannot contract a*b + c into an FMA
// and the result is bit for bit the plain PyTorch version's
// (ops/adam_update.py::adam_update_plain), which rounds after every op.
// The constants are the float32 roundings of the same doubles the Python
// code uses.
//
// Bound on an H100: purely memory -- 4 reads (x, g, mu, nu) and 3 writes
// (x, mu, nu) of float32, 440.4 MB at (5, 1024, 1024, 3), about 0.131 ms at
// 3.35 TB/s; about 12 operations per 28 bytes is far below the compute
// rate. One grid-stride pass with 16-byte loads of all four buffers where
// the pointers are aligned, and a masked scalar tail otherwise, so any size
// is taken (the TPU kernel took only sizes divisible by 1024).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kB1 = static_cast<float>(0.9);
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kB2 = static_cast<float>(0.999);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kEps = static_cast<float>(1e-8);

__device__ __forceinline__ void adam_one(float& x, float g, float& mu, float& nu, float lr,
                                         float bc1, float bc2) {
  mu = __fadd_rn(__fmul_rn(kB1, mu), __fmul_rn(kOneMinusB1, g));
  nu = __fadd_rn(__fmul_rn(kB2, nu), __fmul_rn(__fmul_rn(kOneMinusB2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, bc2)), kEps);
  const float step = __fdiv_rn(__fdiv_rn(mu, bc1), den);
  x = __fsub_rn(x, __fmul_rn(lr, step));
}

__global__ void adam_kernel(float* __restrict__ x, const float* __restrict__ g,
                            float* __restrict__ mu, float* __restrict__ nu, long long n,
                            int vectorized, float lr, float bc1, float bc2) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = vectorized ? n / 4 : 0;
  float4* x4 = reinterpret_cast<float4*>(x);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* m4 = reinterpret_cast<float4*>(mu);
  float4* v4 = reinterpret_cast<float4*>(nu);
  for (long long i = tid; i < nvec; i += stride) {
    float4 xv = x4[i], mv = m4[i], vv = v4[i];
    const float4 gv = g4[i];
    adam_one(xv.x, gv.x, mv.x, vv.x, lr, bc1, bc2);
    adam_one(xv.y, gv.y, mv.y, vv.y, lr, bc1, bc2);
    adam_one(xv.z, gv.z, mv.z, vv.z, lr, bc1, bc2);
    adam_one(xv.w, gv.w, mv.w, vv.w, lr, bc1, bc2);
    x4[i] = xv;
    m4[i] = mv;
    v4[i] = vv;
  }
  for (long long i = nvec * 4 + tid; i < n; i += stride) {
    float xs = x[i], ms = mu[i], vs = nu[i];
    adam_one(xs, g[i], ms, vs, lr, bc1, bc2);
    x[i] = xs;
    mu[i] = ms;
    nu[i] = vs;
  }
}

}  // namespace

extern "C" int tf_adam_update(void* x, const void* g, void* mu, void* nu, long long n,
                              int vectorized, float lr, float bc1, float bc2, void* stream) {
  const int threads = 256;
  const long long work = vectorized ? (n / 4 + n % 4) : n;
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  adam_kernel<<<(int)blocks, threads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), static_cast<const float*>(g), static_cast<float*>(mu),
      static_cast<float*>(nu), n, vectorized, lr, bc1, bc2);
  return (int)cudaGetLastError();
}
