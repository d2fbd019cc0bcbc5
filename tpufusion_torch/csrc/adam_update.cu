// Fused Adam pixel update for Hopper, replacing the TPU kernel
// tpufusion/ops/adam_update.py::_pallas_adam (_adam_kernel): one
// optax-default Adam step (b1 0.9, b2 0.999, eps 1e-8) over a float32 pixel
// buffer, with x, mu and nu written in place:
//
//   mu' = B1*mu + (1-B1)*g        nu' = B2*nu + ((1-B2)*g)*g
//   x'  = x - lr * ((mu'/bc1) / (sqrt(nu'/bc2) + EPS))
//
// lr is a kernel argument; bc1 = 1 - B1^t and bc2 = 1 - B2^t are read from
// device memory, row min(*step, rows - 1) of a float32 (rows, 2) table that
// the wrapper fills once on the host (row r holds step t = r + 1; the last
// row is (1, 1), which every later step rounds to). The step counter is a
// device int, so a launch captured in a CUDA graph reads the next row on
// every replay. Every operation is spelled with
// a round-to-nearest intrinsic, so nvcc cannot contract a*b + c into an FMA
// and the result is bit for bit the plain PyTorch version's
// (ops/adam_update.py::adam_update_plain), which rounds after every op.
// The constants are the float32 roundings of the same doubles the Python
// code uses.
//
// Bound on an H100: purely memory -- 4 reads (x, g, mu, nu) and 3 writes
// (x, mu, nu) of float32, 440.4 MB at (5, 1024, 1024, 3), about 0.131 ms at
// 3.35 TB/s; about 12 operations per 28 bytes is far below the compute
// rate. The streaming design (evict-first 16-byte loads and stores, a
// scalar head and tail, any size: the TPU kernel took only sizes divisible
// by 1024) is in pixel_stream.cuh.
#include "pixel_stream.cuh"

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

// streams: in = (x, g, mu, nu), out = (x, mu, nu), in place; the bias
// corrections through the read-only path (the same two words for every
// thread: L1 hits after the first)
struct AdamOp {
  float lr;
  const float* table;
  const int* step;
  int rows;
  __device__ __forceinline__ void operator()(const float (&in)[4], float (&out)[3]) const {
    const int s = __ldg(step);
    const int r = s < rows - 1 ? s : rows - 1;
    const float bc1 = __ldg(table + 2 * r), bc2 = __ldg(table + 2 * r + 1);
    float x = in[0], mu = in[2], nu = in[3];
    adam_one(x, in[1], mu, nu, lr, bc1, bc2);
    out[0] = x;
    out[1] = mu;
    out[2] = nu;
  }
};

}  // namespace

extern "C" int tf_adam_update(void* x, const void* g, void* mu, void* nu, long long n,
                              float lr, const void* table, int rows, const void* step,
                              void* stream) {
  float* xf = static_cast<float*>(x);
  float* mf = static_cast<float*>(mu);
  float* vf = static_cast<float*>(nu);
  tf_stream::Streams<float, 4, 3> st{{xf, static_cast<const float*>(g), mf, vf}, {xf, mf, vf}};
  // the waves grid at every size (pixel_stream.cuh)
  const AdamOp op{lr, static_cast<const float*>(table), static_cast<const int*>(step), rows};
  return tf_stream::launch(st, n, op, 0, reinterpret_cast<cudaStream_t>(stream));
}
