// Direct 3x3 SAME stride-1 convolution over NHWC activations for Hopper,
// shared by styled_conv.cu (modulated, with the StyleGAN2 epilogue) and
// conv3x3.cu (plain forward, input grad and weight grad).
//
// Layouts: x (N, H, W, Cin) and y (N, H, W, Cout) contiguous NHWC, weights
// (3, 3, Cin, Cout) contiguous HWIO -- the byte layouts the TPU kernels read.
// Activations and weights are float32 or bfloat16; every sum is float32.
//
// Design (a simple, right kernel first; tensor cores are later work):
// - forward: each block owns one sample, an 8x16 tile of output pixels and
//   32 output channels. It loops over the input channels in chunks of 16,
//   staging the haloed 10x18 input tile (zero outside the image; multiplied
//   by the style s[n, ci] as it loads when STYLED) and the 3x3x16x32 weight
//   slice in shared memory. Each of the 256 threads keeps a 4-pixel x
//   4-channel float32 accumulator in registers; a row of 6 staged inputs is
//   reused across the 3 horizontal taps. The epilogue (STYLED) applies
//   sigma[n, co], bias[co], the pre-scaled noise plane and leaky-ReLU * sqrt2.
// - weight grad: blocks stride over 4x32-pixel tiles of all samples and keep
//   a 9x4 float32 accumulator per thread for one 32x32 (ci, co) weight tile;
//   each block writes its own partial sum, and a second small pass adds the
//   partials in block order. No atomics: the result is the same run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ---- forward -------------------------------------------------------------
constexpr int FT_H = 8;            // output rows per block
constexpr int FT_W = 16;           // output columns per block
constexpr int FT_CO = 32;          // output channels per block
constexpr int FT_CI = 16;          // input channels per shared-memory chunk
constexpr int FT_CIP = FT_CI + 1;  // padded pixel pitch: no bank conflicts
constexpr int FT_IN_H = FT_H + 2;
constexpr int FT_IN_W = FT_W + 2;
constexpr int FT_THREADS = 256;

template <typename T, bool STYLED>
__global__ void __launch_bounds__(FT_THREADS)
conv3x3_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                   const float* __restrict__ style, const float* __restrict__ sigma,
                   const float* __restrict__ bias, const float* __restrict__ noise,
                   int H, int W, int Cin, int Cout) {
  __shared__ float s_in[FT_IN_H * FT_IN_W * FT_CIP];
  __shared__ __align__(16) float s_w[9 * FT_CI * FT_CO];

  const int tiles_w = (W + FT_W - 1) / FT_W;
  const int h0 = (blockIdx.x / tiles_w) * FT_H;
  const int w0 = (blockIdx.x % tiles_w) * FT_W;
  const int co0 = blockIdx.y * FT_CO;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int cog = tid % 8;        // channels co0 + cog*4 .. +3
  const int pg = tid / 8;         // pixels: row pr, columns pc .. pc+3
  const int pr = pg / 4;
  const int pc = (pg % 4) * 4;

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  }

  const size_t x_n = (size_t)n * H * W * Cin;
  for (int ci0 = 0; ci0 < Cin; ci0 += FT_CI) {
    for (int idx = tid; idx < FT_IN_H * FT_IN_W * FT_CI; idx += FT_THREADS) {
      const int ci = idx % FT_CI;
      const int pix = idx / FT_CI;
      const int gh = h0 + pix / FT_IN_W - 1;
      const int gw = w0 + pix % FT_IN_W - 1;
      float v = 0.f;
      if (gh >= 0 && gh < H && gw >= 0 && gw < W) {
        v = to_f(x[x_n + ((size_t)gh * W + gw) * Cin + ci0 + ci]);
        if (STYLED) v *= style[(size_t)n * Cin + ci0 + ci];
      }
      s_in[pix * FT_CIP + ci] = v;
    }
    for (int idx = tid; idx < 9 * FT_CI * FT_CO; idx += FT_THREADS) {
      const int co = idx % FT_CO;
      const int rest = idx / FT_CO;
      const int ci = rest % FT_CI;
      const int k = rest / FT_CI;
      s_w[idx] = to_f(w[((size_t)k * Cin + ci0 + ci) * Cout + co0 + co]);
    }
    __syncthreads();
    for (int ci = 0; ci < FT_CI; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float xv[6];
#pragma unroll
        for (int j = 0; j < 6; ++j)
          xv[j] = s_in[((pr + ky) * FT_IN_W + pc + j) * FT_CIP + ci];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4 wv = *reinterpret_cast<const float4*>(
              &s_w[((ky * 3 + kx) * FT_CI + ci) * FT_CO + cog * 4]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float a = xv[j + kx];
            acc[j][0] += a * wv.x;
            acc[j][1] += a * wv.y;
            acc[j][2] += a * wv.z;
            acc[j][3] += a * wv.w;
          }
        }
      }
    }
    __syncthreads();
  }

  const int oh = h0 + pr;
  if (oh >= H) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ow = w0 + pc + j;
    if (ow < W) {
      T* dst = y + (((size_t)n * H + oh) * W + ow) * Cout + co0 + cog * 4;
      const float nz = STYLED ? noise[(size_t)oh * W + ow] : 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v = acc[j][c];
        if (STYLED) {
          const int co = co0 + cog * 4 + c;
          v = v * sigma[(size_t)n * Cout + co] + bias[co] + nz;
          v = (v >= 0.f ? v : 0.2f * v) * 1.4142135623730951f;
        }
        dst[c] = from_f<T>(v);
      }
    }
  }
}

template <typename T, bool STYLED>
int launch_conv3x3_fwd(const void* x, const void* w, void* y, const float* style,
                       const float* sigma, const float* bias, const float* noise,
                       int N, int H, int W, int Cin, int Cout, cudaStream_t stream) {
  dim3 grid(((H + FT_H - 1) / FT_H) * ((W + FT_W - 1) / FT_W), Cout / FT_CO, N);
  conv3x3_fwd_kernel<T, STYLED><<<grid, FT_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      style, sigma, bias, noise, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}

// ---- weight grad -----------------------------------------------------------
constexpr int WT_H = 4;   // pixel sub-tile rows
constexpr int WT_W = 32;  // pixel sub-tile columns
constexpr int WT_C = 32;  // ci and co of one weight tile
constexpr int WT_IN_H = WT_H + 2;
constexpr int WT_IN_W = WT_W + 2;
constexpr int WT_THREADS = 256;

// partial[b] (3, 3, C, C) float32 = sum over block b's pixel tiles of
// x[n, h+ky-1, w+kx-1, ci] * g[n, h, w, co]
template <typename T>
__global__ void __launch_bounds__(WT_THREADS)
conv3x3_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     float* __restrict__ partial, int N, int H, int W, int C) {
  __shared__ __align__(16) float s_x[WT_IN_H * WT_IN_W * WT_C];
  __shared__ float s_g[WT_H * WT_W * WT_C];

  const int nt = C / WT_C;
  const int ci0 = (blockIdx.y / nt) * WT_C;
  const int co0 = (blockIdx.y % nt) * WT_C;
  const int tid = threadIdx.x;
  const int co = tid % WT_C;
  const int cig = tid / WT_C;  // channels ci0 + cig*4 .. +3 (one per warp)

  float acc[9][4];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[k][i] = 0.f;
  }

  const int tiles_w = (W + WT_W - 1) / WT_W;
  const int tiles_h = (H + WT_H - 1) / WT_H;
  const long long per_n = (long long)tiles_h * tiles_w;
  const long long tiles = (long long)N * per_n;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n = (int)(t / per_n);
    const int rem = (int)(t % per_n);
    const int h0 = (rem / tiles_w) * WT_H;
    const int w0 = (rem % tiles_w) * WT_W;
    __syncthreads();  // the previous tile's reads are done
    for (int idx = tid; idx < WT_IN_H * WT_IN_W * WT_C; idx += WT_THREADS) {
      const int ci = idx % WT_C;
      const int pix = idx / WT_C;
      const int gh = h0 + pix / WT_IN_W - 1;
      const int gw = w0 + pix % WT_IN_W - 1;
      float v = 0.f;
      if (gh >= 0 && gh < H && gw >= 0 && gw < W)
        v = to_f(x[(((size_t)n * H + gh) * W + gw) * C + ci0 + ci]);
      s_x[idx] = v;
    }
    for (int idx = tid; idx < WT_H * WT_W * WT_C; idx += WT_THREADS) {
      const int c = idx % WT_C;
      const int pix = idx / WT_C;
      const int gh = h0 + pix / WT_W;
      const int gw = w0 + pix % WT_W;
      float v = 0.f;
      if (gh < H && gw < W)
        v = to_f(g[(((size_t)n * H + gh) * W + gw) * C + co0 + c]);
      s_g[idx] = v;
    }
    __syncthreads();
    for (int p = 0; p < WT_H * WT_W; ++p) {
      const int r = p / WT_W;
      const int c = p % WT_W;
      const float gv = s_g[p * WT_C + co];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4 xv = *reinterpret_cast<const float4*>(
              &s_x[((r + ky) * WT_IN_W + c + kx) * WT_C + cig * 4]);
          acc[ky * 3 + kx][0] += xv.x * gv;
          acc[ky * 3 + kx][1] += xv.y * gv;
          acc[ky * 3 + kx][2] += xv.z * gv;
          acc[ky * 3 + kx][3] += xv.w * gv;
        }
      }
    }
  }

  float* dst = partial + (size_t)blockIdx.x * 9 * C * C;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dst[((size_t)k * C + ci0 + cig * 4 + i) * C + co0 + co] = acc[k][i];
  }
}

// out[i] = sum over blocks b, in order, of partial[b][i]
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int nblocks, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += partial[(size_t)b * total + i];
  out[i] = s;
}

}  // namespace tf
