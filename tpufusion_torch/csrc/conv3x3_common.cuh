// 3x3 SAME stride-1 convolution over NHWC activations for Hopper: what
// styled_conv.cu (modulated, with the StyleGAN2 epilogue) and conv3x3.cu
// (plain forward, input grad and weight grad) share. It replaces the TPU
// kernels tpufusion/ops/styled_conv.py::_pallas_styled_conv and
// tpufusion/ops/pallas_conv.py::_conv3x3_wp_fwd_impl / _conv3x3_wp_dw_impl.
//
// Layouts: x (N, H, W, Cin) and y (N, H, W, Cout) contiguous NHWC, weights
// (3, 3, Cin, Cout) contiguous HWIO -- the byte layouts the TPU kernels read
// -- except the bf16 forward's, which the wrapper packs for wgmma. Every sum
// is float32. This file holds:
// - the float32 forward, conv3x3_fwd_kernel: a direct conv on the CUDA cores
//   (an 8x16 pixel x 32 channel tile, 16-channel chunks, a 4x4 float32
//   accumulator per thread), which keeps float32 products exact where TF32
//   tensor cores would not; the fp32 policy is not the main path. The bf16
//   forward (the main path) is conv3x3_wgmma_kernel in conv3x3_wgmma.cuh.
// - the bf16 weight grad, conv3x3_wgrad_mma_kernel, a tensor-core GEMM over
//   pixels on mma.sync. Per tap, D[ci, co] += A[ci, px] * B[px, co] with
//   K = pixels: nine C x C products that share one B (the g tile). Tiles land
//   in shared memory as [pixel][channel] through a cp.async ring (a haloed
//   x tile and a g tile per stage, out-of-range pixels zero-filled, so the
//   halo and a ragged edge add 0), which is K-strided for both operands, so
//   both fragments come from ldmatrix.trans. A k-step is 16 consecutive
//   pixels of a tile row and a tap is a shift of the x row address. A warp
//   owns a 16 (ci) x 32 (co) slab of all nine taps (144 float32
//   accumulators a thread), so each x fragment feeds 4 MMAs, and walks a
//   16-pixel strip of the tile row by row: the three x fragments (kx = 0, 1,
//   2) of a halo row serve ky = 2, 1, 0 of three successive rows, so a row
//   costs 3 new x fragment loads and 2 g loads for 36 MMAs. At C = 64 the 8
//   warps are the 8 slabs and each walks every pixel; at C = 32 there are 2
//   slabs and the 8 warps form 4 groups that split the tile's strips and
//   rows, added in group order through shared memory when the block is
//   done. One block computes all 9 x C x C outputs, so x and g are read once
//   (plus the halo: 20% of x at 16 x 32 pixels, 33% at 8 x 32). The next
//   tile's copies are issued a few per row step beside this tile's MMAs.
//   Persistent blocks stride over the tiles in a fixed order and write one
//   partial each; sum_partials_kernel adds them in a fixed order. No
//   atomics: the same bits every run. It runs on no main path (the attacks
//   freeze the weights).
// - the float32 weight grad, conv3x3_wgrad_kernel, on the CUDA cores (blocks
//   stride over 4x32-pixel tiles and keep a 9x4 float32 accumulator per
//   thread for one 32x32 (ci, co) weight tile), with the same second pass.
// - the PTX helpers the tensor-core kernels share (cp.async, ldmatrix,
//   mma.sync, bf16 pairs).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tf {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ---- float32 forward on the CUDA cores -------------------------------------
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
  static_assert(std::is_same<T, float>::value, "bf16 runs on conv3x3_wgmma_kernel");
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

// ---- PTX helpers of the tensor-core kernels ---------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_ok false writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool src_ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t hmul2_bits(uint32_t a, uint32_t b) {
  return bf16x2_bits(__hmul2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b)));
}

// ---- weight grad, bfloat16 on the tensor cores ------------------------------
// One tile class of the weight-grad GEMM: C channels, a TH x TW pixel tile
// (TW a multiple of the 16-pixel k-step), WARPS warps that each own a
// 16 (ci) x 32 (co) slab of all nine taps. The GROUPS warps of a slab split
// the tile's 16-pixel strips (COL_GROUPS) and then its rows (ROW_GROUPS).
// Shared memory: a ring of STAGES (haloed x tile, g tile) pairs, pixel pitch
// padded by 8 bf16; the block's float32 sums are staged over it at the end.
template <int C_, int TH_, int TW_, int WARPS_, int STAGES_>
struct WgradTile {
  static constexpr int C = C_, TH = TH_, TW = TW_, WARPS = WARPS_, STAGES = STAGES_;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int NW = 32, NF = NW / 8;             // a slab's co and its n8 tiles
  static constexpr int M_SLABS = C / 16, SLABS = M_SLABS * (C / NW);
  static constexpr int GROUPS = WARPS / SLABS;           // warps sharing one slab
  static constexpr int STRIPS = TW / 16;
  static constexpr int COL_GROUPS = GROUPS < STRIPS ? GROUPS : STRIPS;
  static constexpr int ROW_GROUPS = GROUPS / COL_GROUPS;
  static constexpr int ROWS = TH / ROW_GROUPS;           // rows a warp walks per strip
  static constexpr int HALO_W = TW + 2, HALO_PIX = (TH + 2) * (TW + 2), PIX = TH * TW;
  static constexpr int PITCH = C + 8;                    // bf16 elements
  static constexpr int X_STAGE = HALO_PIX * PITCH * 2;   // bytes
  static constexpr int G_STAGE = PIX * PITCH * 2;
  static constexpr int STAGE = X_STAGE + G_STAGE;
  static constexpr int OUT = 9 * C * C;                  // float32 sums of a block
  static constexpr int SMEM = STAGES * STAGE > OUT * 4 ? STAGES * STAGE : OUT * 4;
  static_assert(TW % 16 == 0 && C % NW == 0 && WARPS % SLABS == 0 &&
                    STRIPS % COL_GROUPS == 0 && GROUPS == COL_GROUPS * ROW_GROUPS &&
                    TH % ROW_GROUPS == 0,
                "a k-step is 16 pixels of one tile row; warps split evenly over the slabs, "
                "strips and rows");
};

// The tile classes, chosen by timing candidates on the H100 at the 1024^2 /
// 512^2 planes (PERF.md).    C  TH  TW warps stages
using Wgrad32 = WgradTile<32, 16, 32, 8, 2>;  // 2 slabs x (2 strips x 2 row halves)
using Wgrad64 = WgradTile<64, 8, 32, 8, 2>;   // 8 slabs, every warp walks both strips

// partial[b] (3, 3, C, C) float32 = sum over block b's pixel tiles of
// x[n, h+ky-1, w+kx-1, ci] * g[n, h, w, co]; gridDim.x <= the number of tiles
template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
conv3x3_wgrad_mma_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ g, float* __restrict__ partial,
                         int N, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int C = T::C;
  const int tiles_w = (W + T::TW - 1) / T::TW;
  const int per_n = ((H + T::TH - 1) / T::TH) * tiles_w;
  const int tiles = N * per_n;
  const int my_tiles = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slab = warp % T::SLABS, group = warp / T::SLABS;
  const int ci0 = (slab % T::M_SLABS) * 16, co0 = (slab / T::M_SLABS) * T::NW;

  auto tile_of = [&](int it, int& n, int& h0, int& w0) {
    const int t = blockIdx.x + it * gridDim.x;
    n = t / per_n;
    const int r = t % per_n;
    h0 = (r / tiles_w) * T::TH;
    w0 = (r % tiles_w) * T::TW;
  };

  // Staging. A thread copies the same 16-byte part of every STEP-th pixel of
  // a tile (first the haloed x tile, then the g tile), walking the tile's
  // rows and columns without a division per copy. The copies of the tile
  // STAGES - 1 ahead are issued a few per row step over the first half of
  // this tile's row steps, so that their address arithmetic runs beside the
  // MMAs instead of before them; a tile's math takes several times the
  // memory's latency, so they land long before the next tile starts.
  constexpr int PARTS = C / 8, STEP = T::THREADS / PARTS;
  static_assert(T::THREADS % PARTS == 0, "one 16-byte part per thread and pixel");
  constexpr int X_COPIES = (T::HALO_PIX + STEP - 1) / STEP;
  constexpr int COPIES = X_COPIES + (T::PIX + STEP - 1) / STEP;  // per thread and tile
  constexpr int STEPS = (T::STRIPS / T::COL_GROUPS) * T::ROWS;   // row steps per tile
  constexpr int PER_STEP = (2 * COPIES + STEPS - 1) / STEPS;
  const int part8 = (tid % PARTS) * 8, p0 = tid / PARTS;
  size_t l_org = 0;  // the tile being staged: its first pixel's offset in x and g,
  int l_h0 = 0, l_w0 = 0, l_r = 0, l_c = 0;  // its origin, the next copy's row and column
  uint32_t l_base = 0;

  auto begin_load = [&](int it) {
    int n;
    tile_of(it, n, l_h0, l_w0);
    l_org = (((size_t)n * H + l_h0) * W + l_w0) * C + part8;
    l_base = smem_u32(smem + (it % T::STAGES) * T::STAGE);
  };
  auto copy = [&](int k) {  // the k-th of a thread's COPIES copies of a tile
    if (k == 0) l_r = p0 / T::HALO_W, l_c = p0 % T::HALO_W;
    if (k == X_COPIES) l_r = p0 / T::TW, l_c = p0 % T::TW;
    if (k < X_COPIES) {
      const int p = p0 + k * STEP;
      if (p < T::HALO_PIX) {
        const int gh = l_h0 + l_r - 1, gw = l_w0 + l_c - 1;
        const bool ok = gh >= 0 && gh < H && gw >= 0 && gw < W;
        cp_async16(l_base + (p * T::PITCH + part8) * 2,
                   ok ? x + l_org + ((l_r - 1) * W + l_c - 1) * C : x, ok);
      }
      l_r += STEP / T::HALO_W;
      l_c += STEP % T::HALO_W;
      if (l_c >= T::HALO_W) l_c -= T::HALO_W, ++l_r;
    } else {
      const int p = p0 + (k - X_COPIES) * STEP;
      if (p < T::PIX) {
        const bool ok = l_h0 + l_r < H && l_w0 + l_c < W;
        cp_async16(l_base + T::X_STAGE + (p * T::PITCH + part8) * 2,
                   ok ? g + l_org + (l_r * W + l_c) * C : g, ok);
      }
      l_r += STEP / T::TW;
      l_c += STEP % T::TW;
      if (l_c >= T::TW) l_c -= T::TW, ++l_r;
    }
  };

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < my_tiles) {
      begin_load(s);
#pragma unroll
      for (int k = 0; k < COPIES; ++k) copy(k);
    }
    cp_async_commit();
  }

  // each lane's ldmatrix.trans row, in bytes from a k-step's first pixel:
  // A (x): matrices (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7),
  // (k 8-15, m 8-15) = a0..a3; B (g): (k 0-7 | 8-15) x (n 0-7 | 8-15) = the
  // b0, b1 of two n8 tiles
  const uint32_t a_lane =
      (((lane & 7) + ((lane >> 4) << 3)) * T::PITCH + ci0 + ((lane >> 3) & 1) * 8) * 2;
  const uint32_t b_lane = ((lane & 15) * T::PITCH + co0 + (lane >> 4) * 8) * 2;

  float acc[9][T::NF][4];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int nf = 0; nf < T::NF; ++nf)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[tap][nf][j] = 0.f;

  for (int it = 0; it < my_tiles; ++it) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1's slot
    const bool more = it + T::STAGES - 1 < my_tiles;
    if (more) begin_load(it + T::STAGES - 1);

    const uint32_t x_base = smem_u32(smem + (it % T::STAGES) * T::STAGE);
    const uint32_t g_base = x_base + T::X_STAGE;
#pragma unroll
    for (int si = 0; si < T::STRIPS / T::COL_GROUPS; ++si) {
      const int c0 = (group % T::COL_GROUPS + si * T::COL_GROUPS) * 16;
      const int r0 = (group / T::COL_GROUPS) * T::ROWS;
      const uint32_t a_col = x_base + (r0 * T::HALO_W + c0) * T::PITCH * 2 + a_lane;
      const uint32_t b_col = g_base + (r0 * T::TW + c0) * T::PITCH * 2 + b_lane;
      // x fragments of three halo rows in turn: row r + ky sits in slot (r + ky) % 3
      uint32_t a[3][3][4];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
          ldsm_x4_t(a[hr][kx], a_col + (hr * T::HALO_W + kx) * T::PITCH * 2);
#pragma unroll
      for (int r = 0; r < T::ROWS; ++r) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
          ldsm_x4_t(a[(r + 2) % 3][kx], a_col + ((r + 2) * T::HALO_W + kx) * T::PITCH * 2);
        uint32_t b[T::NF][2];
#pragma unroll
        for (int nf2 = 0; nf2 < T::NF / 2; ++nf2) {
          uint32_t q[4];
          ldsm_x4_t(q, b_col + r * T::TW * T::PITCH * 2 + nf2 * 32);
          b[2 * nf2][0] = q[0];
          b[2 * nf2][1] = q[1];
          b[2 * nf2 + 1][0] = q[2];
          b[2 * nf2 + 1][1] = q[3];
        }
        if (more) {
#pragma unroll
          for (int j = 0; j < PER_STEP; ++j)
            if ((si * T::ROWS + r) * PER_STEP + j < COPIES)
              copy((si * T::ROWS + r) * PER_STEP + j);
        }
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
#pragma unroll
          for (int nf = 0; nf < T::NF; ++nf)
            mma_bf16(acc[tap][nf], a[(r + tap / 3) % 3][tap % 3], b[nf][0], b[nf][1]);
      }
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the block's sums over it

  // the groups add their sums in group order, then the block stores its
  // partial with 16-byte writes
  float* s_out = reinterpret_cast<float*>(smem);
  for (int turn = 0; turn < T::GROUPS; ++turn) {
    if (group == turn) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll
        for (int nf = 0; nf < T::NF; ++nf)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int ci = ci0 + (lane >> 2) + half * 8;
            const int co = co0 + nf * 8 + (lane & 3) * 2;
            float2* q = reinterpret_cast<float2*>(s_out + (tap * C + ci) * C + co);
            float2 v = make_float2(acc[tap][nf][half * 2], acc[tap][nf][half * 2 + 1]);
            if (turn > 0) {
              const float2 o = *q;
              v.x = o.x + v.x;
              v.y = o.y + v.y;
            }
            *q = v;
          }
    }
    __syncthreads();
  }
  float4* dst = reinterpret_cast<float4*>(partial + (size_t)blockIdx.x * T::OUT);
  for (int i = tid; i < T::OUT / 4; i += T::THREADS)
    dst[i] = reinterpret_cast<const float4*>(s_out)[i];
}

// ---- weight grad, float32 on the CUDA cores ----------------------------------
constexpr int WT_H = 4;   // pixel sub-tile rows
constexpr int WT_W = 32;  // pixel sub-tile columns
constexpr int WT_C = 32;  // ci and co of one weight tile
constexpr int WT_IN_H = WT_H + 2;
constexpr int WT_IN_W = WT_W + 2;
constexpr int WT_THREADS = 256;

// partial[b] as above, for one 32 x 32 (ci, co) weight tile per blockIdx.y
template <typename T>
__global__ void __launch_bounds__(WT_THREADS)
conv3x3_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     float* __restrict__ partial, int N, int H, int W, int C) {
  static_assert(std::is_same<T, float>::value, "bf16 runs on conv3x3_wgrad_mma_kernel");
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

// out[i] = sum over blocks b of partial[b][i], in a fixed order: thread row r
// adds the blocks b = r, r + SP_ROWS, ... in turn, then the rows' sums are
// added in row order
constexpr int SP_COLS = 32;  // outputs per block
constexpr int SP_ROWS = 8;   // interleaved sums per output

__global__ void __launch_bounds__(SP_COLS * SP_ROWS)
sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ out, int nblocks,
                    int total) {
  __shared__ float s[SP_ROWS][SP_COLS];
  const int col = threadIdx.x % SP_COLS, row = threadIdx.x / SP_COLS;
  const int i = blockIdx.x * SP_COLS + col;
  float v = 0.f;
  if (i < total)
    for (int b = row; b < nblocks; b += SP_ROWS) v += partial[(size_t)b * total + i];
  s[row][col] = v;
  __syncthreads();
  if (row == 0 && i < total) {
    float sum = s[0][col];
#pragma unroll
    for (int r = 1; r < SP_ROWS; ++r) sum += s[r][col];
    out[i] = sum;
  }
}

inline int launch_sum_partials(const float* partial, float* out, int nblocks, int total,
                               cudaStream_t stream) {
  sum_partials_kernel<<<(total + SP_COLS - 1) / SP_COLS, SP_COLS * SP_ROWS, 0, stream>>>(
      partial, out, nblocks, total);
  return (int)cudaGetLastError();
}

// The bf16 weight grad: out (3, 3, C, C) float32 from at most max_blocks
// partials of the scratch `partial`.
template <class T>
int launch_wgrad_mma(const void* x, const void* g, float* partial, float* out, int N, int H,
                     int W, int max_blocks, cudaStream_t stream) {
  auto kern = conv3x3_wgrad_mma_kernel<T>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const long long tiles =
      (long long)N * ((H + T::TH - 1) / T::TH) * ((W + T::TW - 1) / T::TW);
  const int grid = (int)(tiles < max_blocks ? tiles : max_blocks);
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                              static_cast<const __nv_bfloat16*>(g), partial,
                                              N, H, W);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_sum_partials(partial, out, grid, T::OUT, stream);
}

}  // namespace tf
