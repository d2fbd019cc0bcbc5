// Low-channel 3x3 SAME stride-1 convolution (forward, input grad, weight
// grad) for Hopper, replacing the width-packed TPU kernels
// tpufusion/ops/pallas_conv.py::_conv3x3_wp_fwd_impl (_fwd_kernel) and
// ::_conv3x3_wp_dw_impl (_dw_kernel).
//
// The input grad is the forward kernel on the spatially flipped,
// channel-transposed weights, as the TPU's _wp_bwd does; the wrapper
// (tpufusion_torch/ops/conv3x3.py) prepares those weights.
//
// Bound on an H100 at the main-path shapes (C = 32 at 1024^2, C = 64 at
// 512^2, bf16): 0.6-1.2 GFLOP per sample against 4 and 2 bytes of x and y
// per output channel and pixel (33 MB a sample), so the memory rate bounds
// it (10-20 us a sample). The bf16 forward and input grad run on the tensor
// cores (conv3x3_mma_kernel, the Narrow class): all Cout in one block,
// the 9 x C x C weights resident in shared memory, x streamed once through
// a cp.async ring with the zero halo filled by the copy, y staged for
// 16-byte stores. The bf16 weight grad (conv3x3_wgrad_mma_kernel) is a
// tensor-core GEMM over pixels: per tap a C x C product with K = pixels,
// both operands read from the staged [pixel][channel] tiles with
// ldmatrix.trans, one block summing all 9 x C x C outputs so that x and g
// are read once; at C = 32 the bytes bound it (127 FLOP per byte moved), at
// C = 64 the tensor cores' fragment loads do. Blocks write partials that a
// second pass adds in a fixed order. float32 runs the CUDA-core kernels,
// which keep exact float32 products. The 128-lane width packing of the TPU
// kernels (pack_weights / unpack_dw) is not carried over (it existed to
// fill the TPU's 128-lane matrix unit). See conv3x3_common.cuh for the
// tiling.
#include "conv3x3_common.cuh"

extern "C" int tf_conv3x3_fwd(const void* x, const void* w, void* y, int N, int H,
                              int W, int C, int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tf::launch_conv3x3_fwd<float, false>(x, w, y, nullptr, nullptr, nullptr,
                                                nullptr, N, H, W, C, C, s);
  return tf::launch_conv3x3_mma<false>(x, w, y, nullptr, nullptr, nullptr, nullptr, N, H, W,
                                       C, C, s);
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
    if (C == 32) return tf::launch_wgrad_mma<tf::Wgrad32>(x, g, part, dw, N, H, W, max_blocks, s);
    if (C == 64) return tf::launch_wgrad_mma<tf::Wgrad64>(x, g, part, dw, N, H, W, max_blocks, s);
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
