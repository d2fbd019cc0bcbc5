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
#include <type_traits>

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

// The backward of both styled convs (bf16). It replaces no TPU kernel: JAX's
// _fsc_bwd (tpufusion/ops/styled_conv.py) differentiates the recomputed XLA
// composite, as the port's fallback (ops/styled_conv.py::
// _recomputed_backward) still does for float32, the weights' gradients and
// shapes these kernels do not take. With c = conv(bf16(x bf16(s)), W),
// sigma = rsqrt(s^2 . W2 + 1e-8), z = c sigma + b + ns noise, y = sqrt2
// lrelu(z, 0.2) and g = dL/dy:
//
//   gz = g sqrt2 (z > 0 ? 1 : 0.2),  gc = gz sigma,  dL/dsigma = sum_hw gz c,
//   gxs = dgrad(gc, W),  gx = gxs bf16(s),
//   gs = sum_hw gxs x - s (W2 . (sigma^3 dL/dsigma)).
//
// Two launches on the forward's wgmma body (conv3x3_wgmma.cuh), each a
// kernel of its own name. K1 (styled_conv_bwd_wgmma_kernel) runs the
// forward's conv again from the saved x (nothing new is saved in the
// forward) and, in its epilogue, reads g where the forward stores y (the
// up conv: at the depth-to-space places), forms z, gz and gc from the
// float32 sum and stores gc in bf16 at the conv's own (N, H, W, Cout)
// place (the up conv: phase-major at the input plane, what its dgrad
// reads). K2 (styled_conv_dgrad_wgmma_kernel) is the conv of gc on the
// flipped, channel-transposed weights (the up conv's phase weights: 4 Co
// in, Cin out) and, in its epilogue, reads x at the output pixel and stores
// gx. Each epilogue stages its input rows (g, x) by cp.async, the first
// group under the mainloop, and writes one float32 partial row a warp and
// tile (sum_hw gz c; sum_hw gxs x): the wrapper adds them in a fixed order,
// so every launch gives the same bits. z, gz, dL/dsigma and the style sums
// stay in float32, where the composite rounds c, z and its sums to bf16.
//
// Bound on an H100: the pair does twice the forward's operations (2 x 2 x
// 9 x Cin x Cg a pixel of the conv's plane, Cg = Cout or 4 Co) and moves
// 2 x 3 x (Cin + Cg) bytes a pixel (K1: x, g in, gc out; K2: gc, x in, gx
// out), so it is operations-bound where the forward is (4^2 ... 256^2) and
// bytes-bound at 1024^2 (c32) and the 512^2 -> 1024^2 up conv: 3.45 ms of
// bound over a white-box synthesis at batch 5 (PERF.md section 6).
//
// K1 (ops/styled_conv.py::styled_conv_backward_launcher): the forward's
// conv of x with the
// weights w packed for tile class `cls` (up: the phase weights, Cout = 4 Co
// phase-major channels); in its epilogue g (N, H, W, Co; up: N, 2H, 2W, Co)
// read where y would be stored, gc = bf16(dL/dz sigma) stored (N, H, W,
// Cout) and partial (tiles x 4 TEAM_WGS, Cout) float32 sums of dL/dz c.
extern "C" int tf_styled_conv_bwd(const void* x, const void* w, const void* g, void* gc,
                                  const void* style, const void* sigma, const void* bias,
                                  const void* noise, void* partial, int N, int H, int W, int Cin,
                                  int Co, int up, int cls, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (up && Co % 8 != 0) return (int)cudaErrorInvalidValue;
  return tf::with_class(cls, [&](auto c) {
    using C = decltype(c);
    auto run = [&](auto kind) {
      return tf::launch_wgmma<decltype(kind)::value, C>(
          x, N, H, W, Cin, up ? 4 * Co : Co, s, static_cast<tf::BfIn>(w),
          static_cast<tf::BfOut>(gc), static_cast<const float*>(style),
          static_cast<const float*>(sigma), static_cast<const float*>(bias),
          static_cast<const float*>(noise), static_cast<tf::BfIn>(g),
          static_cast<float*>(partial));
    };
    return up ? run(std::integral_constant<int, tf::EPI_UP_BWD>{})
              : run(std::integral_constant<int, tf::EPI_BWD>{});
  });
}

// K2: the conv of gc (N, H, W, Cg) with the flipped, channel-transposed
// weights w (3, 3, Cg, Cin) packed for tile class `cls`; in its epilogue x
// read at the output pixel, gx = bf16(gxs bf16(s)) stored (null: skipped)
// and partial (tiles x 4 TEAM_WGS, Cin) float32 sums of gxs x.
extern "C" int tf_styled_conv_dgrad(const void* gc, const void* w, const void* x, void* gx,
                                    const void* style, void* partial, int N, int H, int W,
                                    int Cg, int Cin, int cls, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return tf::with_class(cls, [&](auto c) {
    return tf::launch_wgmma<tf::EPI_DGRAD, decltype(c)>(
        gc, N, H, W, Cg, Cin, s, static_cast<tf::BfIn>(w), static_cast<tf::BfOut>(gx),
        static_cast<const float*>(style), static_cast<tf::BfIn>(x), static_cast<float*>(partial));
  });
}
