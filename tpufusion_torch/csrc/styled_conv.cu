// Fused StyleGAN2 styled conv for Hopper, replacing the TPU kernel
// tpufusion/ops/styled_conv.py::_pallas_styled_conv (_kernel):
//
//   y = lrelu(conv3x3(x * s, W / sqrt(9 Cin)) * sigma + b + ns * noise, 0.2) * sqrt2
//
// with sigma = rsqrt(s^2 . sum W^2 + 1e-8) in float32 and one shared (H, W)
// noise plane. The wrapper (tpufusion_torch/ops/styled_conv.py) scales the
// weights, computes sigma and the pre-scaled noise plane; this kernel does the
// modulation as it loads (prologue), the conv with float32 sums, and the
// demodulation, bias, noise and activation before its one store (epilogue),
// so x is read once and y written once.
//
// Bound on an H100 (bf16, batch 1): 19.3 GFLOP per launch from 64^2 up
// (about 20 us at the 989 TFLOP/s tensor-core rate, operations-bound), and
// memory-bound at 1024^2 / C = 32 (134 MB, ~40 us). This first kernel runs
// on the CUDA cores (67 TFLOP/s fp32), so at C >= 128 it is far from that
// bound; tensor cores (mma.sync / wgmma) are later work. See
// conv3x3_common.cuh for the tiling.
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
  return tf::launch_conv3x3_fwd<__nv_bfloat16, true>(x, w, y, st, sg, b, nz, N, H, W, Cin,
                                                     Cout, s);
}
