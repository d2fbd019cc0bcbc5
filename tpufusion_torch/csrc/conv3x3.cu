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
// 512^2, bf16): about 0.6-1.2 GFLOP per launch against 32-64 MB moved, so
// the memory rate bounds it (~20-40 us). This first kernel runs on the CUDA
// cores; the 128-lane width packing of the TPU kernel is not carried over
// (it existed to fill the TPU's 128-lane matrix unit). See
// conv3x3_common.cuh for the tiling.
#include "conv3x3_common.cuh"

extern "C" int tf_conv3x3_fwd(const void* x, const void* w, void* y, int N, int H,
                              int W, int C, int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tf::launch_conv3x3_fwd<float, false>(x, w, y, nullptr, nullptr, nullptr,
                                                nullptr, N, H, W, C, C, s);
  return tf::launch_conv3x3_fwd<__nv_bfloat16, false>(x, w, y, nullptr, nullptr, nullptr,
                                                      nullptr, N, H, W, C, C, s);
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
