// Fused StyleGAN2 styled conv for Hopper, replacing the TPU kernel
// tpufusion/ops/styled_conv.py::_pallas_styled_conv (_kernel):
//
//   y = lrelu(conv3x3(bf16(x * bf16(s)), W / sqrt(9 Cin)) * sigma + b + ns * noise, 0.2) * sqrt2
//
// with sigma = rsqrt(s^2 . sum W^2 + 1e-8) in float32 and one shared (H, W)
// noise plane. The wrapper (tpufusion_torch/ops/styled_conv.py) scales the
// weights, computes sigma and the pre-scaled noise plane; the kernel
// modulates its input, sums the conv in float32 and applies demodulation,
// bias, noise and the activation before its one store, so x is read once
// and y written once. style arrives as float32; the bf16 kernel rounds it
// to bf16 before the product, as the TPU kernel does.
//
// Bound on an H100 (bf16): from 64^2 up, 19.3 GFLOP per launch at batch 1,
// about 20 us at the 989 TFLOP/s tensor-core rate (operations-bound, 5x that
// at batch 5); at 512^2 / 1024^2 (C = 64 / 32) the bytes of x and y bound it
// instead (33-67 MB per sample, 10-20 us). bfloat16 runs on the tensor cores
// as an implicit GEMM (conv3x3_mma_kernel): the big planes take 256-pixel x
// 128-channel tiles for operand reuse, the 32/64-channel planes keep their
// weights resident and stream x once, the small planes take small tiles to
// give the 132 SMs more blocks. It reaches 20-27% of the operations bound,
// held back by ldmatrix traffic and instruction throughput (PERF.md). float32 runs the
// CUDA-core kernel, whose sums stay exact. See conv3x3_common.cuh.
#include "conv3x3_common.cuh"

extern "C" int tf_styled_conv_fwd(const void* x, const void* w, void* y, const void* style,
                                  const void* sigma, const void* bias, const void* noise,
                                  int N, int H, int W, int Cin, int Cout, int dtype,
                                  void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(style);
  const float* sg = static_cast<const float*>(sigma);
  const float* b = static_cast<const float*>(bias);
  const float* nz = static_cast<const float*>(noise);
  if (dtype == 0)
    return tf::launch_conv3x3_fwd<float, true>(x, w, y, st, sg, b, nz, N, H, W, Cin, Cout, s);
  return tf::launch_conv3x3_mma<true>(x, w, y, st, sg, b, nz, N, H, W, Cin, Cout, s);
}
