// The bf16 3x3 weight grad for Hopper (sm_90a), conv3x3.cu's weight grad in
// bfloat16. It replaces the TPU kernel
// tpufusion/ops/pallas_conv.py::_conv3x3_wp_dw_impl (_dw_kernel).
//
// dW[ky, kx, ci, co] = sum over n, h, w of x[n, h+ky-1, w+kx-1, ci] * g[n, h, w, co]
// with x outside the plane 0; bf16 products (exact in float32), float32 sums.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): 2 * 9 * C^2
// operations and 4 C bytes (x and g) a pixel, 4.5 C operations a byte
// against the card's ridge of 295: C = 32 (1024^2, 144) is bound by its
// bytes, C = 64 (512^2, 288) sits on the ridge and needs the full tensor rate
// and the full memory rate at once (car's 4 x 512^2: 0.080 ms of bytes,
// 0.078 ms of operations).
//
// Design: a GEMM over pixels, D[(tap, ci), co] += x[p + shift(tap), ci] *
// g[p, co], on the tensor cores by wgmma.mma_async.m64nCk16 (bf16 in,
// float32 sums in registers). K is 16 pixels of one tile row.
// - A block is three warpgroups (and, at C = 32, a producer warp). One
//   thread issues, per 16 x TH pixel tile, two TMA loads into a ring of
//   STAGES mbarrier-tracked slots: the haloed x tile, a box of
//   (C, 18, TH+2, 1) at (0, w0-1, h0-1, n), and the g tile, (C, 16, TH, 1)
//   at (0, w0, h0, n). The TMA's zero fill of what lies outside the tensor
//   is the halo and the ragged edge: out-of-range g pixels add 0. Tile s
//   goes into its slot once every thread is done with tile s - STAGES; at
//   C = 64 the issuing thread is thread 0, which at each tile's start waits
//   for that tile's copy if it is not out yet, then issues those of the
//   next tiles whose slots are free, without waiting.
// - Warpgroup kx owns the taps (0, kx), (1, kx), (2, kx): M = 3 C
//   rows (ky, ci) in MT m64 tiles (C = 64: 3 tiles, one a tap row; C = 32:
//   2 tiles of which the last half is padding, its sums dropped).
// - A is x, taken into registers by ldmatrix.trans at tap-shifted pixels of
//   the one staged, swizzled x tile (the trans gives wgmma's K pairs, the
//   per-lane XOR undoes the TMA's swizzle): a tap is a shift of the row
//   address, so nothing is staged twice. Walking a tile's rows, tap row ky
//   of row r reads halo row r + ky, which tap row ky - 1 reads at row r + 1:
//   each warp loads one new fragment a row into a ring of SLOTS register
//   sets, the next row's while this row's wgmmas run.
// - B is the g tile, read from shared memory by a descriptor: MN-major (co
//   contiguous, the TMA's 64-byte swizzle at C = 32 and 128-byte at C = 64),
//   wgmma's transpose-B. All nine taps share it.
// - Blocks are persistent over the pixel tiles in a fixed order; each keeps
//   its sums in registers over all its tiles and writes one float32 partial
//   (3, 3, C, C), the warpgroups' disjoint taps straight from registers.
//   sum_partials_kernel (conv3x3_common.cuh) adds the partials in a fixed
//   order: no atomics, the same bits on every launch.
// - Registers: at C = 64 (96 float32 sums and four fragment sets a thread)
//   the block is 384 threads, so each may hold 168. With a producer
//   warpgroup (512 threads) or warp (416: registers are split over the SM's
//   four quarters by warp) ptxas held every thread to 128 whatever
//   setmaxnreg gave the others at run time, spilled and serialized the
//   wgmmas. C = 32 needs under 128 and keeps a producer warp: issuing from
//   a warpgroup's thread made it slower.
// A wait on an mbarrier that lasts over WATCHDOG_NS traps, so a fault in a
// copy ends the launch with an error instead of hanging the card.
#pragma once

#include "conv3x3_wgmma.cuh"

namespace tf {

// One tile class of the weight grad: C channels, TH x 16 pixel tiles, a ring
// of STAGES (haloed x tile, g tile) slots. Shared memory from a 1024-byte
// aligned base: the slots (x at 0, g at G_OFF, both on swizzle-atom
// boundaries), then the barriers.
template <int C_, int TH_, int STAGES_>
struct WgradTile {
  static constexpr int C = C_, TH = TH_, TW = 16, STAGES = STAGES_;
  static constexpr int WGS = 3;                    // consumer warpgroups, one per kx
  // C = 32 needs under 128 registers a thread, so a producer warp issues the
  // copies (13 warps); C = 64 needs 146, so the block stays at 384 threads
  // and its thread 0 issues them
  static constexpr bool PRODUCER_WARP = C == 32;
  static constexpr int THREADS = 128 * WGS + (PRODUCER_WARP ? 32 : 0);
  static constexpr int MT = (3 * C + 63) / 64;     // m64 tiles of a warpgroup's 3 C rows
  static constexpr int ROWB = 2 * C;               // bytes of a staged pixel (the swizzle span)
  static constexpr int HALO_W = TW + 2, HALO_H = TH + 2;
  static constexpr int X_BYTES = HALO_H * HALO_W * ROWB;  // the x box
  static constexpr int G_OFF = (X_BYTES + 1023) / 1024 * 1024;
  static constexpr int G_BYTES = TH * TW * ROWB;          // the g box
  static constexpr int STAGE = (G_OFF + G_BYTES + 1023) / 1024 * 1024;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
  static constexpr int OUT = 9 * C * C;                   // float32 sums of a partial
  // m64 tile t of warp w holds tap rows ky = (64 t + 16 w) / C: those of
  // its first tile plus D_t = 64 t / C. A warp's fragments of a row span D + 1
  // halo rows; one more slot holds the next row's while this row's run.
  static constexpr int D = 64 * (MT - 1) / C;
  static constexpr int SLOTS = D + 2;
  static_assert(C == 32 || C == 64, "a staged pixel is one 64- or 128-byte swizzle span");
  static_assert(SMEM <= 232448, "the ring fits a block's shared memory");
};

// The tile classes; ops/conv3x3.py::WGRAD_CLASSES mirrors this table. Each
// was chosen by timing on the H100 at the 1024^2 / 512^2 planes (PERF.md).
//                           C  TH stages
using Wgrad32 = WgradTile<32, 32, 2>;
using Wgrad64 = WgradTile<64, 16, 3>;

// partial[b] (3, 3, C, C) float32 = sum over block b's pixel tiles of
// x[n, h+ky-1, w+kx-1, ci] * g[n, h, w, co]. x and g arrive as tensor maps
// (NHWC, boxes (C, 18, TH + 2, 1) and (C, 16, TH, 1)); gridDim.x <= tiles.
template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
conv3x3_wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap gmap, float* __restrict__ partial,
                           int N, int H, int W) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  constexpr int C = T::C;

  const int tiles_w = (W + T::TW - 1) / T::TW;
  const int per_n = ((H + T::TH - 1) / T::TH) * tiles_w;
  const int tiles = N * per_n;
  const int my_tiles = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  const uint32_t bars = base + T::STAGES * T::STAGE;
  auto full = [&](int i) { return bars + 8 * i; };
  auto empty = [&](int i) { return bars + 8 * (T::STAGES + i); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < T::STAGES; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), 128 * T::WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The copies: tile s of this block into slot s % STAGES once every
  // consumer thread is done with tile s - STAGES. `block` waits for that;
  // otherwise it stops at the first slot still in use.
  int issued = 0;
  auto produce = [&](int limit, bool block) {
    for (; issued < limit; ++issued) {
      const int slot = issued % T::STAGES;
      if (issued >= T::STAGES) {
        const uint32_t parity = ((issued / T::STAGES) - 1) & 1;
        if (block)
          mbar_wait(empty(slot), parity);
        else if (!mbar_test_wait(empty(slot), parity))
          return;
      }
      const int t = blockIdx.x + issued * gridDim.x;
      const int n = t / per_n, r = t % per_n;
      const int h0 = (r / tiles_w) * T::TH, w0 = (r % tiles_w) * T::TW;
      const uint32_t dst = base + slot * T::STAGE;
      mbar_expect_tx(full(slot), T::X_BYTES + T::G_BYTES);
      tma_load_4d(dst, &xmap, full(slot), 0, w0 - 1, h0 - 1, n);
      tma_load_4d(dst + T::G_OFF, &gmap, full(slot), 0, w0, h0, n);
    }
  };
  const int issuer = T::PRODUCER_WARP ? 128 * T::WGS : 0;  // the thread that issues
  if (tid == issuer) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&xmap))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&gmap))
                 : "memory");
    produce(T::PRODUCER_WARP ? my_tiles : min(my_tiles, T::STAGES), true);
  }
  if (warp >= 4 * T::WGS) return;  // the producer warp is done

  // ---- warpgroup kx, warp wl of it
  const int kx = warp >> 2, wl = warp & 3;
  // this warp's rows of m64 tile t are (ky, ci) = (o + D_t, ci0 + 0..15)
  const int o = 16 * wl / C, ci0 = 16 * wl % C;
  // this lane's ldmatrix.trans row: matrices (k 0-7 | 8-15) x (m 0-7 | 8-15)
  // in the order a0 (k 0-7, m 0-7), a1 (k 0-7, m 8-15), a2, a3 -- pixel
  // (lane & 7) + 8 (lane >> 4) of the k-step, 16-byte chunk ci0 / 8 +
  // ((lane >> 3) & 1) of that pixel
  const int lpix = (lane & 7) + ((lane >> 4) << 3) + kx;
  const int lchunk = ci0 / 8 + ((lane >> 3) & 1);

  float acc[T::MT][C / 2];
#pragma unroll
  for (int t = 0; t < T::MT; ++t) {
#pragma unroll
    for (int i = 0; i < C / 2; ++i) acc[t][i] = 0.f;
    fence_regs(acc[t]);
  }
  uint32_t fr[T::SLOTS][4];

  for (int s = 0; s < my_tiles; ++s) {
    const int slot = s % T::STAGES;
    if (!T::PRODUCER_WARP) {
      // this tile's copy, whatever it waits for, then those of the next
      // tiles whose slots are free
      if (tid == 0) {
        produce(s + 1, true);
        produce(min(my_tiles, s + T::STAGES), false);
      }
      __syncwarp();
    }
    mbar_wait(full(slot), (s / T::STAGES) & 1);
    const uint32_t xs = base + slot * T::STAGE;
    const uint64_t desc0 = mnmajor_desc(xs + T::G_OFF, T::ROWB);
    // the fragment of halo row `row`, shifted by kx (the padding rows of
    // C = 32 read up to row TH + 2, past the x box but inside the slot)
    auto load = [&](uint32_t(&f)[4], int row) {
      const int p = row * T::HALO_W + lpix;
      const int chunk = lchunk ^ (((p * T::ROWB) >> 7) & (T::ROWB / 16 - 1));
      ldsm_x4_t(f, xs + p * T::ROWB + (chunk << 4));
    };
#pragma unroll
    for (int j = 0; j <= T::D; ++j) load(fr[j], o + j);
    // halo row o + j sits in slot j % SLOTS
#pragma unroll
    for (int r = 0; r < T::TH; ++r) {
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < T::MT; ++t)
        Wgmma<C>::template mma<1>(acc[t], fr[(r + 64 * t / C) % T::SLOTS],
                                  desc0 + (uint64_t)((r * T::TW * T::ROWB) >> 4));
      wgmma_commit();
      if (r + 1 < T::TH) {
        // row r - 1's wgmmas are done, so its first slot takes row r + 1's last fragment
        wgmma_wait<1>();
        load(fr[(r + T::D + 1) % T::SLOTS], o + r + T::D + 1);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < T::MT; ++t) fence_regs(acc[t]);
    mbar_arrive(empty(slot));
  }

  // wgmma's accumulator layout: acc[t][4 nb + 2 h + e] is row 16 wl + g8 +
  // 8 h of m64 tile t, column 8 nb + 2 t4 + e
  float* dst = partial + (size_t)blockIdx.x * T::OUT;
  const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int t = 0; t < T::MT; ++t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 64 * t + 16 * wl + g8 + 8 * h;
      const int ky = m / C, ci = m % C;
      if (ky < 3) {
        float* row = dst + ((size_t)(ky * 3 + kx) * C + ci) * C + 2 * t4;
#pragma unroll
        for (int nb = 0; nb < C / 8; ++nb)
          *reinterpret_cast<float2*>(row + nb * 8) =
              make_float2(acc[t][4 * nb + 2 * h], acc[t][4 * nb + 2 * h + 1]);
      }
    }
  }
}

// The bf16 weight grad: out (3, 3, C, C) float32 from at most max_blocks
// partials of the scratch `partial`.
template <class T>
int launch_wgrad_wgmma(const void* x, const void* g, float* partial, float* out, int N, int H,
                       int W, int max_blocks, cudaStream_t stream) {
  CUtensorMap xmap, gmap;
  int e = encode_x_map(&xmap, x, N, H, W, T::C, T::C, T::HALO_W, T::HALO_H);
  if (e != 0) return e;
  e = encode_x_map(&gmap, g, N, H, W, T::C, T::C, T::TW, T::TH);
  if (e != 0) return e;
  auto kern = conv3x3_wgrad_wgmma_kernel<T>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const long long tiles =
      (long long)N * ((H + T::TH - 1) / T::TH) * ((W + T::TW - 1) / T::TW);
  const int grid = (int)(tiles < max_blocks ? tiles : max_blocks);
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(xmap, gmap, partial, N, H, W);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_sum_partials(partial, out, grid, T::OUT, stream);
}

}  // namespace tf
