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
// 16-byte stores. float32 runs the CUDA-core kernel. The weight grad stays
// on the CUDA cores. The 128-lane width packing of the TPU kernel is not
// carried over (it existed to fill the TPU's 128-lane matrix unit). See
// conv3x3_common.cuh for the tiling.
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

// partial: nblocks * 9 * C * C float32 scratch; out: (3, 3, C, C) float32
extern "C" int tf_conv3x3_wgrad(const void* x, const void* g, void* partial, void* out,
                                int N, int H, int W, int C, int nblocks, int dtype,
                                void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int nt = C / tf::WT_C;
  dim3 grid(nblocks, nt * nt);
  if (dtype == 0)
    tf::conv3x3_wgrad_kernel<float><<<grid, tf::WT_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<float*>(partial), N, H, W, C);
  else
    tf::conv3x3_wgrad_kernel<__nv_bfloat16><<<grid, tf::WT_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
        static_cast<float*>(partial), N, H, W, C);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int total = 9 * C * C;
  tf::sum_partials_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), nblocks, total);
  return (int)cudaGetLastError();
}
