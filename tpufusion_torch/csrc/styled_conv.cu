// Fused StyleGAN2 styled conv for Hopper, replacing the TPU kernel
// tpufusion/ops/styled_conv.py::_pallas_styled_conv (_kernel):
//
//   y = lrelu(conv3x3(bf16(x * bf16(s)), W / sqrt(9 Cin)) * sigma + b + ns * noise, 0.2) * sqrt2
//
// with sigma = rsqrt(s^2 . sum W^2 + 1e-8) in float32 and one shared (H, W)
// noise plane. The wrapper (tpufusion_torch/ops/styled_conv.py) scales and
// packs the weights and computes sigma and the pre-scaled noise plane; the
// kernel modulates its input, sums the conv in float32 and applies
// demodulation, bias, noise and the activation before its one store, so x is
// read once and y written once. style arrives as float32; the bf16 kernel
// rounds it to bf16 before the product, as the TPU kernel does.
//
// Bound on an H100 (bf16): 2 * 9 * C^2 operations and 4 C bytes a pixel, so
// the 4^2-256^2 planes (C 512-128) are bound by operations (19.3 GFLOP a
// launch at batch 1 from 64^2 up, 20 us at 989 TFLOP/s), the 512^2 plane
// (C = 64, 288 operations a byte against the card's 295) sits on the ridge
// and needs both rates at once, the 1024^2 plane (C = 32, 144) is bound by
// its bytes. bfloat16 runs on
// conv3x3_wgmma_kernel (conv3x3_wgmma.cuh): TMA copies of the haloed input
// into a ring of mbarrier stages, wgmma with A from ldmatrix at tap-shifted
// rows (modulated in registers) and B, the packed weights, from shared
// memory; the tile class comes from ops/conv3x3.py::mma_class. Measured
// (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py phase 3, the kernel
// alone): 43-62% of the bound at the 512^2 / 1024^2 planes, 49-76% at the
// Wide planes (64^2-256^2; 32^2 from batch 5), 9-48% at the Mid and Small
// ones (4^2-32^2, and 64^2 at batch 1); summed over a white-box synthesis
// (batch 5) 1.073-1.079 ms against cuDNN's conv core's 1.263 (PERF.md
// section 6). float32 runs the CUDA-core kernel,
// whose sums stay exact.
#include "conv3x3_wgmma.cuh"

// w: float32 HWIO weights (dtype 0), else bf16 weights packed for tile class
// `cls` (ops/conv3x3.py::pack_mma_weights)
extern "C" int tf_styled_conv_fwd(const void* x, const void* w, void* y, const void* style,
                                  const void* sigma, const void* bias, const void* noise,
                                  int N, int H, int W, int Cin, int Cout, int dtype, int cls,
                                  void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(style);
  const float* sg = static_cast<const float*>(sigma);
  const float* b = static_cast<const float*>(bias);
  const float* nz = static_cast<const float*>(noise);
  if (dtype == 0)
    return tf::launch_conv3x3_fwd<float, true>(x, w, y, st, sg, b, nz, N, H, W, Cin, Cout, s);
  return tf::launch_conv3x3_wgmma<true>(cls, x, w, y, st, sg, b, nz, N, H, W, Cin, Cout, s);
}

// The styled up conv (y (N, 2H, 2W, Cout) from x (N, H, W, Cin)), bf16 only:
// w the phase weights (3, 3, Cin, 4 Cout) packed for tile class `cls`
// (ops/styled_conv.py::styled_conv_up_launcher), sigma (N, Cout) of the
// unfolded weights, bias (Cout), noise (H, W, 4) pre-scaled.
extern "C" int tf_styled_conv_up_fwd(const void* x, const void* w, void* y, const void* style,
                                     const void* sigma, const void* bias, const void* noise,
                                     int N, int H, int W, int Cin, int Cout, int cls,
                                     void* stream) {
  return tf::launch_styled_conv_up_wgmma(
      cls, x, w, y, static_cast<const float*>(style), static_cast<const float*>(sigma),
      static_cast<const float*>(bias), static_cast<const float*>(noise), N, H, W, Cin, Cout,
      reinterpret_cast<cudaStream_t>(stream));
}
