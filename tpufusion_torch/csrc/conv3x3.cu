// Low-channel 3x3 SAME stride-1 convolution (forward, input grad, weight
// grad) for Hopper, replacing the width-packed TPU kernels
// tpufusion/ops/pallas_conv.py::_conv3x3_wp_fwd_impl (_fwd_kernel) and
// ::_conv3x3_wp_dw_impl (_dw_kernel).
//
// The input grad is the forward kernel on the spatially flipped,
// channel-transposed weights, as the TPU's _wp_bwd does; the wrapper
// (tpufusion_torch/ops/conv3x3.py) prepares and packs those weights.
//
// Bound on an H100 at the main-path shapes (C = 32 at 1024^2, C = 64 at
// 512^2, bf16): 2 * 9 * C^2 operations against 4 C bytes a pixel, 144
// (C = 32) and 288 (C = 64) operations a byte against the card's ridge of
// 295: C = 32 is bound by its bytes, C = 64 by both rates at once (car's
// 4 x 512^2 c64: 0.078 ms of operations, 0.080 ms of bytes). The bf16 forward and input grad run on conv3x3_wgmma_kernel
// (conv3x3_wgmma.cuh), the Narrow classes: all Cout in one block, the
// 9 x C x C weights resident in shared memory in wgmma's B layout (one bulk
// copy a block), the haloed input streamed once by TMA into a ring of
// mbarrier stages, A from ldmatrix at tap-shifted rows, two consumer
// warpgroups on alternate tiles so one's epilogue overlaps the other's
// wgmmas. Measured (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py phase 3,
// the kernel alone): forward and input grad 74-81% of the bound at c32,
// 59-61% at 4-5 x 512^2 c64 (car's 4 x 512^2: 0.133-0.134 ms against
// F.conv2d's 0.173), 54% at 1 x 512^2 c64 (PERF.md). The bf16 weight grad
// runs on conv3x3_wgrad_wgmma_kernel (conv3x3_wgrad.cuh): a GEMM over pixels,
// M = (tap, ci), N = co, K = 16 pixels of a tile row; the haloed x tile and
// the g tile streamed once by TMA into a ring of mbarrier stages, A (x) from
// ldmatrix.trans at tap-shifted pixels, B (g) MN-major by descriptor, one
// consumer warpgroup per kx; blocks write partials that a second pass adds
// in a fixed order.
// float32 runs the CUDA-core kernels, which keep exact float32 products.
// The 128-lane width packing of the TPU kernels (pack_weights / unpack_dw)
// is not carried over (it existed to fill the TPU's 128-lane matrix unit).
// See conv3x3_common.cuh, conv3x3_wgmma.cuh and conv3x3_wgrad.cuh.
#include "conv3x3_wgrad.cuh"

// w: HWIO weights (dtype 0: float32), else bf16 weights packed for tile
// class `cls` (ops/conv3x3.py::pack_mma_weights)
extern "C" int tf_conv3x3_fwd(const void* x, const void* w, void* y, int N, int H,
                              int W, int C, int dtype, int cls, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tf::launch_conv3x3_fwd<float, false>(x, w, y, nullptr, nullptr, nullptr,
                                                nullptr, N, H, W, C, C, s);
  return tf::launch_conv3x3_wgmma<false>(cls, x, w, y, nullptr, nullptr, nullptr, nullptr, N,
                                         H, W, C, C, s);
}

// partial: max_blocks * 9 * C * C float32 scratch; out: (3, 3, C, C) float32.
// Each route launches as many blocks as it has pixel tiles, at most max_blocks.
extern "C" int tf_conv3x3_wgrad(const void* x, const void* g, void* partial, void* out,
                                int N, int H, int W, int C, int max_blocks, int dtype,
                                void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* dw = static_cast<float*>(out);
  if (dtype != 0) {
    if (C == 32) return tf::launch_wgrad_wgmma<tf::Wgrad32>(x, g, part, dw, N, H, W, max_blocks, s);
    if (C == 64) return tf::launch_wgrad_wgmma<tf::Wgrad64>(x, g, part, dw, N, H, W, max_blocks, s);
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles = (long long)N * ((H + tf::WT_H - 1) / tf::WT_H) *
                          ((W + tf::WT_W - 1) / tf::WT_W);
  const int nblocks = (int)(tiles < max_blocks ? tiles : max_blocks);
  const int nt = C / tf::WT_C;
  tf::conv3x3_wgrad_kernel<float><<<dim3(nblocks, nt * nt), tf::WT_THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), part, N, H, W, C);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return tf::launch_sum_partials(part, dw, nblocks, 9 * C * C, s);
}
