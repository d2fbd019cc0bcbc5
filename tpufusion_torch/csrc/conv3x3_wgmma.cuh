// The bf16 3x3 SAME stride-1 forward for Hopper (sm_90a): the conv core of
// styled_conv.cu and of conv3x3.cu's forward and input grad. It replaces the
// TPU kernels tpufusion/ops/styled_conv.py::_pallas_styled_conv (_kernel)
// and tpufusion/ops/pallas_conv.py::_conv3x3_wp_fwd_impl (_fwd_kernel; the
// input grad, _wp_bwd, is the same conv on flipped weights).
//
// y[n, h, w, co] = epi(sum over ky, kx, ci of xs[n, h+ky-1, w+kx-1, ci] * W[ky, kx, ci, co])
// with xs = bf16(x * bf16(s[n, ci])) when STYLED (rounded once, as the TPU
// kernel's xs = x * s.astype(x.dtype)) and x otherwise; the sum in float32;
// epi = leaky-ReLU(v * sigma[n, co] + bias[co] + noise[h, w], 0.2) * sqrt2
// in float32 when STYLED, the identity otherwise; one rounding to bf16.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): 2 * 9 * Cin * Cout
// operations and 2 * (Cin + Cout) bytes a pixel. At Cin = Cout = C that is
// 4.5 * C operations a byte against the card's ridge of 295: C = 64 (512^2,
// 288) sits on the ridge (car's 4 x 512^2 c64: 0.078 ms of operations,
// 0.080 ms of bytes) and needs the full tensor rate and the full memory
// rate at once; C = 32 (1024^2, 144) is bound by its bytes; C >= 128 (the
// 4^2-256^2 planes) by operations.
//
// Design: an implicit GEMM, M = output pixels of a tile, N = Cout, K = 9 taps
// x Cin, on the tensor cores by wgmma.mma_async.m64nNk16 (bf16 in, float32
// sums in registers).
// - A block is one producer warpgroup and one or two consumer warpgroups.
//   One producer thread issues, per (tile, channel chunk), one TMA load of
//   the haloed input tile -- a box of (CK channels, TW+2, TH+2, 1) of x's
//   NHWC tensor map starting at (c0, w0-1, h0-1, n); the TMA's zero fill of
//   what lies outside the tensor is the halo and the ragged edge -- and, for
//   the classes whose weights do not stay resident, one bulk copy of that
//   chunk's weights, and (STYLED) one of the chunk's float32 style, into a
//   ring of STAGES slots tracked by mbarriers (full: the bytes landed;
//   empty: every consumer thread is done with it). Staging the style with
//   its tile keeps its load off the mainloop's path.
// - The input tile lands swizzled (the TMA's 32/64/128-byte swizzle for
//   32/64/128-byte pixel rows). A is taken from it into registers by
//   ldmatrix, one row address a lane, so a tap (ky, kx) is a shift of the
//   row address inside the one staged tile; the swizzle keeps the 8 rows of
//   each ldmatrix on 8 bank groups. wgmma reads A from those registers
//   (each warp's 16 rows of the m64 tile) and B from shared memory by a
//   descriptor.
// - Where a warp's 16 rows are one 16-pixel output row (TW = 16), its MT
//   m64 tiles are MT successive rows, so tap row ky of tile j and tap row
//   ky - 1 of tile j + 1 read the same input row: a warp loads MT + 2
//   fragments for each (kx, k-step) and issues 3 * MT wgmmas on them.
//   Fragments rotate over three register sets (one per kx), so the loads of
//   the next step overlap the wgmmas of this one (wgmma.wait_group 1).
// - B, the weights, are packed by the wrapper (ops/conv3x3.py::
//   pack_mma_weights) into wgmma's canonical K-major layout without swizzle:
//   8 x 8 core matrices of 128 contiguous bytes, one 16 x BN block per
//   (chunk, tap, k-step). The Narrow classes keep all of them resident in
//   shared memory (one bulk copy a block); the others stream a chunk's with
//   its input tile.
// - The modulation (STYLED) is one __hmul2 of each A register by bf16(s),
//   on the fragments as they are loaded.
// - Epilogue: float32 sigma, bias, noise, leaky-ReLU * sqrt2 on the
//   accumulators, one rounding to bf16, stmatrix into a per-warp staging
//   tile, 16-byte stores of NHWC rows.
// - The styled up conv (styled_conv_up_wgmma_kernel, EPI_UP) is this conv
//   on phase weights: the stride-2 transposed 3x3 conv and the 4x4 blur
//   after it fold into one 6x6 transposed conv whose four output phases
//   each read input offsets {-1, 0, +1}, so Cout = 4 Co phase-major channels
//   of a "same" 3x3 conv at the input plane. Its epilogue reads sigma and
//   bias at channel c % Co and the noise of the phase's output pixel, and
//   stores each 8-channel part at its depth-to-space place in y (N, 2H, 2W,
//   Co): x read once, y written once.
// - The Narrow classes give each consumer warpgroup its own tiles (the
//   stages alternate between them), so neither waits for the other's
//   epilogue; the other classes share each stage between both.
// - Blocks are persistent over the M tiles of one Cout slice; each output
//   is one block's float32 sum in a fixed order, with no split-K and no
//   atomics: the same bits on every launch.
// - The producer warpgroup gives its registers to the consumers
//   (setmaxnreg): 232 a consumer thread in the one-block-a-SM classes.
// A wait on an mbarrier that lasts over WATCHDOG_NS traps, so a fault in a
// copy ends the launch with an error instead of hanging the card.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phase 3, the
// kernel alone on a cold L2; PERF.md section 6): Narrow32 74-81% of the
// bound (1-5 x 1024^2 c32), Narrow64 54% at 1 x 512^2 c64 and 59-61% at
// 4-5 x 512^2 (conv3x3; styled 43-50%), Wide 49-76% of the operations
// bound (487-755 TFLOP/s), Mid 28-48%, Small 9-26% (the 4^2-32^2 planes,
// 14.5-19 us, where a block walks 16 channel chunks one after another).
// Held back: shared-memory operand traffic
// (A by ldmatrix and B by descriptor: by arithmetic about 100 of the 128
// bytes a clock an SM serves, at the full tensor rate of m64n64k16), the
// epilogue's idle tensor time, and in Wide 112-232 bytes of spills.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_common.cuh"

namespace tf {

// ---- mbarriers, TMA, wgmma ---------------------------------------------------
constexpr unsigned long long WATCHDOG_NS = 4000000000ull;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// the same test without waiting: try_wait may suspend the thread for a
// while before it gives up, test_wait never does
__device__ __forceinline__ bool mbar_test_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > WATCHDOG_NS) __trap();
}

// TMA: a box of the 4-d tensor map at coordinates (c0, c1, c2, c3) into
// shared memory; completion counted on the barrier's transaction bytes
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
// one contiguous bulk copy global -> shared (16-byte aligned, bytes % 16 == 0)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of accumulators across a
// wgmma fence or wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A wgmma shared-memory matrix descriptor: K-major, no swizzle. lbo = bytes
// between the two 8-column core matrices along K, sbo = bytes between 8-row
// core-matrix groups along M/N.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
// A descriptor of an MN-major operand (wgmma with TRANS_B) as the TMA's
// 64- or 128-byte swizzle `swz` lays it out: rows of `swz` bytes (N = swz / 2
// bf16, one swizzle atom, so no stride between atoms along N is ever taken),
// 8-row groups along K `8 * swz` bytes apart. Both offset fields get that K
// stride; the start address must be a multiple of 8 * swz.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr, uint32_t swz) {
  const uint64_t layout = swz == 128 ? 1 : 2;  // the descriptor's 128B / 64B swizzle
  const uint64_t kgroup = (8 * swz) >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (kgroup << 16) | (kgroup << 32) | (layout << 62);
}

__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// d (64 x N float32, wgmma's accumulator layout) += a (64 x 16 bf16, each
// warp's 16 rows in registers, mma.m16n8k16's A layout) * b (16 x N bf16 in
// shared memory by descriptor: K-major, or MN-major with TRANS_B)
template <int N>
struct Wgmma;
template <>
struct Wgmma<32> {
  template <int TRANS_B = 0>
  __device__ __forceinline__ static void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15 "
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TRANS_B));
  }
};

template <>
struct Wgmma<64> {
  template <int TRANS_B = 0>
  __device__ __forceinline__ static void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31 "
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TRANS_B));
  }
};

template <>
struct Wgmma<128> {
  template <int TRANS_B = 0>
  __device__ __forceinline__ static void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63 "
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TRANS_B));
  }
};

// ---- tile classes ------------------------------------------------------------
// TH x TW output pixels a tile (per team of TEAM_WGS consumer warpgroups,
// each of MT m64 tiles), BN output channels (the wgmma's N) a block, CK input
// channels a stage, STAGES slots, RESIDENT weights, MIN_BLOCKS a SM for the
// register budget. Shared memory (from a 1024-byte aligned base): the ring of
// stages (the haloed input box with the chunk's style in its slot's tail,
// then a streamed chunk's weights), the resident weights, a 16-row staging
// tile for each consumer warp, the barriers.
template <int TH_, int TW_, int WGS_, int TEAM_WGS_, int MT_, int BN_, int CK_, int STAGES_,
          bool RESIDENT_, int MIN_BLOCKS_>
struct WgTile {
  static constexpr int TH = TH_, TW = TW_, WGS = WGS_, TEAM_WGS = TEAM_WGS_, MT = MT_;
  static constexpr int BN = BN_, CK = CK_, STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr bool RESIDENT = RESIDENT_;
  static constexpr int TEAMS = WGS / TEAM_WGS;
  static constexpr int THREADS = 128 * (WGS + 1);  // the consumers, then the producer warpgroup
  // registers a thread: what the launch gives every thread (MIN_BLOCKS
  // blocks a SM), then the producer's and the consumers' after setmaxnreg
  static constexpr int REGS = (65536 / MIN_BLOCKS / THREADS) / 8 * 8;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS_ = (REGS * THREADS - PRODUCER_REGS * 128) / (128 * WGS) / 8 * 8;
  static constexpr int CONSUMER_REGS = CONSUMER_REGS_ > 240 ? 240 : CONSUMER_REGS_;
  static constexpr int KS = CK / 16;                      // k-steps a chunk
  static constexpr bool REUSE = TW == 16;                 // a warp's 16 rows = one tile row
  static constexpr int NF = REUSE ? MT + 2 : 3 * MT;      // A fragments a (kx, k-step)
  static constexpr int HALO_W = TW + 2, HALO_H = TH + 2;
  static constexpr int ROWB = CK * 2;                     // bytes of a staged pixel
  static constexpr int X_BYTES = HALO_H * HALO_W * ROWB;  // the TMA box
  static constexpr int X_SLOT = (X_BYTES + 1023) / 1024 * 1024;
  static constexpr int STY_OFF = (X_BYTES + 15) / 16 * 16;  // a chunk's float32 style
  static_assert(STY_OFF + CK * 4 <= X_SLOT, "the style fits the input slot's tail");
  static constexpr int W_CHUNK = 9 * CK * BN * 2;         // packed weights of a chunk
  static constexpr int STAGE = RESIDENT ? X_SLOT : (X_SLOT + W_CHUNK + 1023) / 1024 * 1024;
  static constexpr int OUT_PITCH = BN * 2 + 16;           // bytes of a staged output row
  static constexpr int OUT_BYTES = 4 * WGS * 16 * OUT_PITCH;
  static_assert(TH * TW == TEAM_WGS * MT * 64, "a team's tile is its warpgroups' m64 tiles");
  static_assert(TW % 8 == 0 && (CK == 16 || CK == 32 || CK == 64) && BN % 16 == 0 &&
                    WGS % TEAM_WGS == 0,
                "ldmatrix rows stay in one tile row; a staged pixel is one swizzle span");
  __host__ __device__ static size_t w_resident(int nchunks) {
    return RESIDENT ? ((size_t)nchunks * W_CHUNK + 1023) / 1024 * 1024 : 0;
  }
  __host__ __device__ static size_t smem_bytes(int nchunks) {
    return 1024 + (size_t)STAGES * STAGE + w_resident(nchunks) + OUT_BYTES +
           (2 * STAGES + 1) * 8;
  }
};

// The tile classes; ops/conv3x3.py::MMA_CLASSES mirrors this table and picks
// one from the shapes. Each was chosen by timing candidates at the
// synthesis planes on the H100 (PERF.md section 6).
//                        TH  TW wgs team MT   BN  CK stages resident blocks/SM
using WgNarrow32 = WgTile<16, 16, 2, 1, 4, 32, 32, 8, true, 1>;
using WgNarrow64 = WgTile<8, 16, 2, 1, 2, 64, 64, 5, true, 1>;
using WgWide = WgTile<16, 16, 2, 2, 2, 128, 16, 4, false, 1>;
using WgMid = WgTile<8, 16, 2, 2, 1, 64, 32, 3, false, 1>;
using WgSmall = WgTile<8, 8, 1, 1, 1, 32, 32, 4, false, 2>;

constexpr size_t MMA_SMEM_MAX = 232448;  // sm_90: 227 KB of dynamic shared memory a block

// The epilogues of the body below: none (conv3x3), the styled conv's, and
// the styled up conv's (EPI_UP: Cout = 4 Co phase-major channels, phase
// p = 2 a + b of channel co stored at output pixel (2 h + a, 2 w + b) of
// y (N, 2H, 2W, Co); sigma (N, Co), bias (Co); noise (H, W, 4), the
// pre-scaled noise of each input pixel's four output pixels). The styled
// convs' backward (styled_conv.cu's source note): EPI_BWD and EPI_UP_BWD
// (K1) run the forward's modulated conv and read aux = g = dL/dy where the
// forward would store y; EPI_DGRAD (K2) runs the plain conv of gc on the
// flipped weights and reads aux = x at the output pixel. Both store y (gc,
// gx) at the conv's own NHWC place and write float32 partial sums over each
// tile's pixels, one row of Cout a consumer warp: partial[(tile * 4 TEAM_WGS
// + warp of the team) * Cout + co].
constexpr int EPI_NONE = 0, EPI_STYLED = 1, EPI_UP = 2, EPI_BWD = 3, EPI_UP_BWD = 4, EPI_DGRAD = 5;
constexpr float SQRT2 = 1.4142135623730951f;

// The backward epilogues of the body below, on one consumer warp's MT m64
// tiles of the tile at (n, h0, w0), Cout slice co0: for each 16-row group,
// the warp stages aux's rows at this slice's channels in its staging rows
// (stage_rows; the first group's while the mainloop runs), reads them back in the
// accumulators' layout by ldmatrix, forms its outputs and their partial
// sums' terms in float32, rounds the outputs once, and stores them as the
// forward stores y at the conv's own NHWC place (y null: K2 without gx).
// BWD (K1): aux = g at the place the forward would store y (UP: the
// depth-to-space place); z = c sigma + bias + noise, gz = g sqrt2 (z > 0 ? 1 :
// 0.2); y = bf16(gz sigma); terms gz c. DGRAD (K2): aux = x; y = bf16(acc
// bf16(s)); terms acc x. The terms replace the accumulators they
// came from, then are summed over the warp's rows in a fixed order (its
// tiles, rows g and g + 8, then the 8 lanes of each channel pair by
// butterfly) into its partial row: no atomics, the same bits every launch.
// 16 bytes global -> shared by cp.async (bypassing L1); src_bytes 0 fills
// zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Loads that stay where they are written (volatile): the backward
// epilogue's sigma, bias, style and noise, read at each use. As plain loads
// of read-only memory the compiler hoists them over the mainloop and holds
// them there, and the mainloop of the one-block-a-SM classes then spills.
__device__ __forceinline__ float ld_here(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float2 ld_here2(const float* p) {
  float2 v;
  asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "l"(p));
  return v;
}
__device__ __forceinline__ float4 ld_here4(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// A backward epilogue's input rows: aux's 16 rows of 16-row group grp of
// the tile at (n, h0, w0), at the Cout slice co0's channels, into the warp's
// staging rows `rows` by cp.async (zero outside the plane); K1 reads g where
// the forward would store y (UP: the depth-to-space place), K2 reads x.
template <bool UP, class C>
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* __restrict__ aux, uint32_t rows,
                                           int grp, int n, int h0, int w0, int H, int W, int Cout,
                                           int co0) {
  const int lane = threadIdx.x & 31;
  const int Co = UP ? Cout / 4 : Cout;
  constexpr int CH = C::BN / 8;  // 16-byte parts of a row
#pragma unroll
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, part = i % CH;
    const int m = grp * 16 + r;
    const int oh = h0 + m / C::TW, ow = w0 + m % C::TW;
    const bool in = oh < H && ow < W;
    const __nv_bfloat16* src = aux;
    if (in) {
      if (UP) {
        const int ph = (co0 + part * 8) / Co;
        src = aux + (((size_t)n * 2 * H + 2 * oh + (ph >> 1)) * 2 * W + 2 * ow + (ph & 1)) * Co +
              co0 + part * 8 - ph * Co;
      } else {
        src = aux + (((size_t)n * H + oh) * W + ow) * Cout + co0 + part * 8;
      }
    }
    cp_async16(rows + r * C::OUT_PITCH + part * 16, src, in ? 16 : 0);
  }
}

template <bool UP, bool BWD, class C>
__device__ __forceinline__ void backward_epilogue(
    float (&acc)[C::MT][C::BN / 2], const float* __restrict__ style,
    const float* __restrict__ sigma, const float* __restrict__ bias,
    const float* __restrict__ noise, const __nv_bfloat16* __restrict__ aux,
    __nv_bfloat16* __restrict__ y, float* __restrict__ partial, int tile, int slot,
    unsigned char* smem, uint32_t base, uint32_t o_off, int g0, int n, int h0, int w0, int H,
    int W, int Cout, int co0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3, mi = lane >> 3;
  const int Co = UP ? Cout / 4 : Cout;
  constexpr int CH = C::BN / 8;  // 16-byte parts of a row
  // UP: each n8 block's phase in two bits (Co % 8 == 0: a block lies in one phase)
  uint32_t phs = 0;
  if (UP) {
#pragma unroll
    for (int nb = 0; nb < CH; ++nb) phs |= (uint32_t)((co0 + nb * 8) / Co) << (2 * nb);
  }
#pragma unroll
  for (int t = 0; t < C::MT; ++t) {
    const int grp = g0 + t;
    // BWD: the pre-scaled noise of this lane's rows g and g + 8 (UP: their
    // four output pixels)
    float nz[2][UP ? 4 : 1];
    if (BWD) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = grp * 16 + g + 8 * h;
        const int oh = h0 + m / C::TW, ow = w0 + m % C::TW;
        const bool in = oh < H && ow < W;
        if constexpr (UP) {
          const float4 v = in ? ld_here4(noise + ((size_t)oh * W + ow) * 4)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
          nz[h][0] = v.x;
          nz[h][1] = v.y;
          nz[h][2] = v.z;
          nz[h][3] = v.w;
        } else {
          nz[h][0] = in ? ld_here(noise + (size_t)oh * W + ow) : 0.f;
        }
      }
    }
    // group 0's rows were staged as the tile's mainloop began
    if (t > 0) stage_rows<UP, C>(aux, base + o_off, grp, n, h0, w0, H, W, Cout, co0);
    cp_async_wait_all();
    __syncwarp();
#pragma unroll
    for (int nb2 = 0; nb2 < C::BN / 16; ++nb2) {
      // matrices: rows 0-7 / 8-15 of n8 block 2 nb2, then of 2 nb2 + 1
      const uint32_t rows =
          base + o_off + ((mi & 1) * 8 + (lane & 7)) * C::OUT_PITCH + (2 * nb2 + (mi >> 1)) * 16;
      uint32_t a[4], p[4];
      ldsm_x4(a, rows);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int nb = 2 * nb2 + q;
        // this lane's channel pair: BWD sigma and bias (UP: of channel c %
        // Co), DGRAD bf16(s), as the forward modulates; read here, not held
        // across the epilogue, so that the accumulators keep the registers
        int co = co0 + nb * 8 + 2 * t4;
        const uint32_t ph = UP ? (phs >> (2 * nb)) & 3 : 0;
        co -= ph * Co;
        float2 sg, bs;
        if constexpr (BWD) {
          sg = ld_here2(sigma + (size_t)n * Co + co);
          bs = ld_here2(bias + co);
        } else {
          const float2 v = ld_here2(style + (size_t)n * Cout + co);
          sg = __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i0 = 4 * nb + 2 * h;
          const float2 av = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[2 * q + h]));
          const float v0 = acc[t][i0], v1 = acc[t][i0 + 1];
          float o0, o1;
          if constexpr (BWD) {
            float zn = nz[h][0];
            if constexpr (UP) zn = ph == 0 ? zn : ph == 1 ? nz[h][1] : ph == 2 ? nz[h][2] : nz[h][3];
            const float z0 = v0 * sg.x + bs.x + zn, z1 = v1 * sg.y + bs.y + zn;
            const float gz0 = av.x * (z0 > 0.f ? SQRT2 : 0.2f * SQRT2);
            const float gz1 = av.y * (z1 > 0.f ? SQRT2 : 0.2f * SQRT2);
            acc[t][i0] = gz0 * v0;
            acc[t][i0 + 1] = gz1 * v1;
            o0 = gz0 * sg.x;
            o1 = gz1 * sg.y;
          } else {
            acc[t][i0] = v0 * av.x;
            acc[t][i0 + 1] = v1 * av.y;
            o0 = v0 * sg.x;
            o1 = v1 * sg.y;
          }
          p[2 * q + h] = bf16x2_bits(__floats2bfloat162_rn(o0, o1));
        }
      }
      __syncwarp();  // every lane's ldmatrix of these rows is done
      stsm_x4(rows, p[0], p[1], p[2], p[3]);
    }
    __syncwarp();
    if (y != nullptr) {
#pragma unroll
      for (int i = lane; i < 16 * CH; i += 32) {
        const int r = i / CH, part = i % CH;
        const int m = grp * 16 + r;
        const int oh = h0 + m / C::TW, ow = w0 + m % C::TW;
        if (oh < H && ow < W)
          *reinterpret_cast<uint4*>(y + (((size_t)n * H + oh) * W + ow) * Cout + co0 + part * 8) =
              *reinterpret_cast<const uint4*>(smem + o_off + r * C::OUT_PITCH + part * 16);
      }
    }
    __syncwarp();
  }
  float* dst = partial + ((size_t)tile * 4 * C::TEAM_WGS + slot) * Cout + co0 + 2 * t4;
#pragma unroll
  for (int nb = 0; nb < C::BN / 8; ++nb) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int t = 0; t < C::MT; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s0 += acc[t][4 * nb + 2 * h];
        s1 += acc[t][4 * nb + 2 * h + 1];
      }
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (g == 0) *reinterpret_cast<float2*>(dst + nb * 8) = make_float2(s0, s1);
  }
}

// y = conv3x3(x [* s]) [epilogue], bf16 in and out. x arrives as the tensor
// map `xmap` (NHWC, box (CK, TW + 2, TH + 2, 1)); wpk is the packed weights
// (pack_mma_weights): [Cout / BN][chunks][9][KS][2][BN / 8][8][8]. grid
// (persistent blocks over the M tiles, Cout / BN); gridDim.x <= M tiles.
// The body of each __global__ kernel below, one per epilogue, so that each
// keeps a name of its own in a profile.
template <int EPI, class C>
__device__ __forceinline__ void conv3x3_wgmma_body(
    const CUtensorMap& xmap, const __nv_bfloat16* __restrict__ wpk,
    __nv_bfloat16* __restrict__ y, const float* __restrict__ style,
    const float* __restrict__ sigma, const float* __restrict__ bias,
    const float* __restrict__ noise, const __nv_bfloat16* __restrict__ aux,
    float* __restrict__ partial, int N, int H, int W, int Cin, int Cout) {
  // STYLED: the mainloop modulates x by the style; UP: channels are phases
  // at depth-to-space places; BWD: K1's epilogue; DGRAD: K2's
  constexpr bool STYLED = EPI != EPI_NONE && EPI != EPI_DGRAD;
  constexpr bool UP = EPI == EPI_UP || EPI == EPI_UP_BWD;
  constexpr bool BWD = EPI == EPI_BWD || EPI == EPI_UP_BWD, DGRAD = EPI == EPI_DGRAD;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  const int nchunks = (Cin + C::CK - 1) / C::CK;
  const int tiles_w = (W + C::TW - 1) / C::TW;
  const int per_n = ((H + C::TH - 1) / C::TH) * tiles_w;
  const int m_tiles = N * per_n;
  const int my_tiles = (m_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int co0 = blockIdx.y * C::BN;
  const uint32_t w_bytes = (uint32_t)nchunks * C::W_CHUNK;  // this Cout slice's weights
  const unsigned char* w_src = reinterpret_cast<const unsigned char*>(wpk) +
                               (size_t)blockIdx.y * w_bytes;

  const uint32_t stage0 = base;
  const uint32_t w_res = stage0 + C::STAGES * C::STAGE;
  const uint32_t out_off = C::STAGES * C::STAGE + (uint32_t)C::w_resident(nchunks);
  const uint32_t bars = base + out_off + C::OUT_BYTES;
  auto full = [&](int i) { return bars + 8 * i; };
  auto empty = [&](int i) { return bars + 8 * (C::STAGES + i); };
  const uint32_t w_bar = bars + 16 * C::STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), 128 * C::TEAM_WGS);
    }
    mbar_init(w_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto tile_of = [&](int j, int& n, int& h0, int& w0) {
    const int t = blockIdx.x + j * gridDim.x;
    n = t / per_n;
    const int r = t % per_n;
    h0 = (r / tiles_w) * C::TH;
    w0 = (r % tiles_w) * C::TW;
  };

  if (warp >= 4 * C::WGS) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS));
    if (warp == 4 * C::WGS && lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&xmap))
                   : "memory");
      if (C::RESIDENT) {
        mbar_expect_tx(w_bar, w_bytes);
        bulk_load(w_res, w_src, w_bytes, w_bar);
      }
      const int total = my_tiles * nchunks;
      for (int s = 0; s < total; ++s) {
        const int slot = s % C::STAGES;
        if (s >= C::STAGES) mbar_wait(empty(slot), ((s / C::STAGES) - 1) & 1);
        int n, h0, w0;
        tile_of(s / nchunks, n, h0, w0);
        const int c = s % nchunks;
        const uint32_t dst = stage0 + slot * C::STAGE;
        // STYLED: the chunk's float32 style rides with its input tile
        const uint32_t sty_bytes = STYLED ? 4 * (uint32_t)min(C::CK, Cin - c * C::CK) : 0;
        mbar_expect_tx(full(slot), C::X_BYTES + (C::RESIDENT ? 0 : C::W_CHUNK) + sty_bytes);
        tma_load_4d(dst, &xmap, full(slot), c * C::CK, w0 - 1, h0 - 1, n);
        if (sty_bytes)
          bulk_load(dst + C::STY_OFF, style + (size_t)n * Cin + c * C::CK, sty_bytes, full(slot));
        if (!C::RESIDENT)
          bulk_load(dst + C::X_SLOT, w_src + (size_t)c * C::W_CHUNK, C::W_CHUNK, full(slot));
      }
    }
    return;
  }

  // ---- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS));
  const int wg = warp >> 2, wl = warp & 3;
  const int team = wg / C::TEAM_WGS;
  const int g0 = (wg % C::TEAM_WGS) * 4 * C::MT + wl * C::MT;  // this warp's first 16-pixel group
  // each fragment's staged pixel for this lane at kx = 0: REUSE, fragment f
  // is halo row g0 + f (tap row ky of tile j is fragment j + ky); else
  // fragment (j, ky) = 3 * j + ky
  int fpix[C::NF];
#pragma unroll
  for (int f = 0; f < C::NF; ++f) {
    const int grp = C::REUSE ? g0 + f : g0 + f / 3;
    const int ky = C::REUSE ? 0 : f % 3;
    const int m = grp * 16 + (lane & 15);
    fpix[f] = (m / C::TW + ky) * C::HALO_W + m % C::TW;
  }
  const int khalf = lane >> 4;
  if (C::RESIDENT) mbar_wait(w_bar, 0);

  float acc[C::MT][C::BN / 2];
  uint32_t fr[3][C::NF][4];
  for (int j = team; j < my_tiles; j += C::TEAMS) {
    int n, h0, w0;
    tile_of(j, n, h0, w0);
#pragma unroll
    for (int t = 0; t < C::MT; ++t) {
#pragma unroll
      for (int i = 0; i < C::BN / 2; ++i) acc[t][i] = 0.f;
      fence_regs(acc[t]);
    }
    if constexpr (BWD || DGRAD)  // the backward epilogue's first rows, staged under the mainloop
      stage_rows<UP, C>(aux, base + out_off + warp * 16 * C::OUT_PITCH, g0, n, h0, w0, H, W, Cout,
                        co0);
    int pending = -1;  // the slot to give back once its wgmmas are done
    for (int c = 0; c < nchunks; ++c) {
      const int s = j * nchunks + c;
      const int slot = s % C::STAGES;
      mbar_wait(full(slot), (s / C::STAGES) & 1);
      const uint32_t xs = stage0 + slot * C::STAGE;
      const uint32_t wb = C::RESIDENT ? w_res + c * C::W_CHUNK : xs + C::X_SLOT;
      const uint64_t desc0 = kmajor_desc(wb, C::BN * 16, 128);
      const int ci0 = c * C::CK;
      const int ksteps = min(C::KS, (Cin - ci0) / 16);
      uint32_t sty[C::KS][2];
      if (STYLED) {  // bf16(s) for this lane's channels 2t, 2t+1 and 2t+8, 2t+9 of each k-step,
                     // from the staged chunk (past Cin: 0, the slot's tail is stale)
#pragma unroll
        for (int ks = 0; ks < C::KS; ++ks) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ch = ci0 + ks * 16 + 2 * (lane & 3) + 8 * h;
            const float2 v = ch < Cin ? *reinterpret_cast<const float2*>(
                                            smem + (xs - base) + C::STY_OFF + (ch - ci0) * 4)
                                      : make_float2(0.f, 0.f);
            sty[ks][h] = bf16x2_bits(__floats2bfloat162_rn(v.x, v.y));
          }
        }
      }
#pragma unroll
      for (int ks = 0; ks < C::KS; ++ks) {
        if (ks >= ksteps) break;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
          for (int f = 0; f < C::NF; ++f) {
            const int p = fpix[f] + kx;
            const int chunk = (ks * 2 + khalf) ^ (((p * C::ROWB) >> 7) & (C::ROWB / 16 - 1));
            ldsm_x4(fr[kx][f], xs + p * C::ROWB + (chunk << 4));
            if (STYLED) {
              fr[kx][f][0] = hmul2_bits(fr[kx][f][0], sty[ks][0]);
              fr[kx][f][1] = hmul2_bits(fr[kx][f][1], sty[ks][0]);
              fr[kx][f][2] = hmul2_bits(fr[kx][f][2], sty[ks][1]);
              fr[kx][f][3] = hmul2_bits(fr[kx][f][3], sty[ks][1]);
            }
          }
          wgmma_fence();
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {  // successive wgmmas on different accumulators
#pragma unroll
            for (int t = 0; t < C::MT; ++t) {
              const int tap = ky * 3 + kx;
              Wgmma<C::BN>::mma(acc[t], fr[kx][C::REUSE ? t + ky : 3 * t + ky],
                                desc0 + (uint64_t)((tap * C::KS + ks) * 2 * C::BN));
            }
          }
          wgmma_commit();
          // one group left in flight: the next step's fragment set (one of
          // three) is no pending group's, and after this stage's first step
          // every wgmma of the previous stage is done
          wgmma_wait<1>();
          if (pending >= 0) {
            mbar_arrive(empty(pending));
            pending = -1;
          }
        }
      }
      pending = slot;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < C::MT; ++t) fence_regs(acc[t]);
    mbar_arrive(empty(pending));

    const uint32_t o_off = out_off + warp * 16 * C::OUT_PITCH;  // this warp's staging rows
    if constexpr (BWD || DGRAD) {
      backward_epilogue<UP, BWD, C>(acc, style, sigma, bias, noise, aux, y, partial,
                                    blockIdx.x + j * gridDim.x, (wg % C::TEAM_WGS) * 4 + wl, smem,
                                    base, o_off, g0, n, h0, w0, H, W, Cout, co0);
      continue;
    }
    // epilogue: float32 -> (STYLED: sigma, bias, noise, lrelu * sqrt2) ->
    // bf16, stmatrix into this warp's staging rows, 16-byte NHWC stores
    const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3;
    // this lane's sigma and bias pairs (channels co0 + 8 nb + 2 t4, + 1) and
    // the noise of its rows, all loaded before the first use. UP: channel c
    // is phase c / Co of channel c % Co (Co % 8 == 0, so a pair and an
    // 8-channel part lie in one phase); phs packs each n8 block's phase in
    // two bits, and each row keeps the noise of its four output pixels
    const int Co = UP ? Cout / 4 : Cout;
    uint32_t phs = 0;
    float2 sg[C::BN / 8], bs[C::BN / 8];
    float nz[C::MT][2][UP ? 4 : 1];
    if (STYLED) {
#pragma unroll
      for (int nb = 0; nb < C::BN / 8; ++nb) {
        int co = co0 + nb * 8 + 2 * t4;
        if (UP) {
          const int ph = (co0 + nb * 8) / Co;
          phs |= (uint32_t)ph << (2 * nb);
          co -= ph * Co;
        }
        sg[nb] = *reinterpret_cast<const float2*>(sigma + (size_t)n * Co + co);
        bs[nb] = *reinterpret_cast<const float2*>(bias + co);
      }
#pragma unroll
      for (int t = 0; t < C::MT; ++t) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = (g0 + t) * 16 + g + 8 * h;
          const int oh = h0 + m / C::TW, ow = w0 + m % C::TW;
          const bool in = oh < H && ow < W;
          if constexpr (UP) {
            const float4 v = in ? *reinterpret_cast<const float4*>(noise + ((size_t)oh * W + ow) * 4)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
            nz[t][h][0] = v.x;
            nz[t][h][1] = v.y;
            nz[t][h][2] = v.z;
            nz[t][h][3] = v.w;
          } else {
            nz[t][h][0] = in ? noise[(size_t)oh * W + ow] : 0.f;
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < C::MT; ++t) {
      const int grp = g0 + t;
#pragma unroll
      for (int nb2 = 0; nb2 < C::BN / 16; ++nb2) {
        uint32_t p[4];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int nb = 2 * nb2 + q;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = acc[t][4 * nb + 2 * h], v1 = acc[t][4 * nb + 2 * h + 1];
            if (STYLED) {
              float z = nz[t][h][0];
              if constexpr (UP) {
                const uint32_t ph = (phs >> (2 * nb)) & 3;
                z = ph == 0 ? z : ph == 1 ? nz[t][h][1] : ph == 2 ? nz[t][h][2] : nz[t][h][3];
              }
              v0 = v0 * sg[nb].x + bs[nb].x + z;
              v1 = v1 * sg[nb].y + bs[nb].y + z;
              v0 = (v0 >= 0.f ? v0 : 0.2f * v0) * SQRT2;
              v1 = (v1 >= 0.f ? v1 : 0.2f * v1) * SQRT2;
            }
            p[2 * q + h] = bf16x2_bits(__floats2bfloat162_rn(v0, v1));
          }
        }
        // matrices: rows 0-7 / 8-15 of n8 block 2 nb2, then of 2 nb2 + 1
        stsm_x4(base + o_off + ((mi & 1) * 8 + (lane & 7)) * C::OUT_PITCH + (2 * nb2 + (mi >> 1)) * 16,
                p[0], p[1], p[2], p[3]);
      }
      __syncwarp();
      constexpr int CH = C::BN / 8;  // 16-byte parts of a row
#pragma unroll
      for (int i = lane; i < 16 * CH; i += 32) {
        const int r = i / CH, part = i % CH;
        const int m = grp * 16 + r;
        const int oh = h0 + m / C::TW, ow = w0 + m % C::TW;
        if (oh < H && ow < W) {
          __nv_bfloat16* dst;
          if (UP) {  // depth-to-space: phase (a, b) to output pixel (2 oh + a, 2 ow + b)
            const int ph = (phs >> (2 * part)) & 3;
            dst = y + (((size_t)n * 2 * H + 2 * oh + (ph >> 1)) * 2 * W + 2 * ow + (ph & 1)) * Co +
                  co0 + part * 8 - ph * Co;
          } else {
            dst = y + (((size_t)n * H + oh) * W + ow) * Cout + co0 + part * 8;
          }
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(smem + o_off + r * C::OUT_PITCH + part * 16);
        }
      }
      __syncwarp();
    }
  }
}

// the conv3x3 forward and input grad (STYLED false) and the styled conv
template <bool STYLED, class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __nv_bfloat16* __restrict__ wpk, __nv_bfloat16* __restrict__ y,
                     const float* __restrict__ style, const float* __restrict__ sigma,
                     const float* __restrict__ bias, const float* __restrict__ noise, int N,
                     int H, int W, int Cin, int Cout) {
  conv3x3_wgmma_body<STYLED ? EPI_STYLED : EPI_NONE, C>(xmap, wpk, y, style, sigma, bias, noise,
                                                        nullptr, nullptr, N, H, W, Cin, Cout);
}

// the styled up conv: the phase conv (Cout = 4 Co) with EPI_UP's epilogue
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
styled_conv_up_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __nv_bfloat16* __restrict__ wpk,
                            __nv_bfloat16* __restrict__ y, const float* __restrict__ style,
                            const float* __restrict__ sigma, const float* __restrict__ bias,
                            const float* __restrict__ noise, int N, int H, int W, int Cin,
                            int Cout) {
  conv3x3_wgmma_body<EPI_UP, C>(xmap, wpk, y, style, sigma, bias, noise, nullptr, nullptr, N, H,
                                W, Cin, Cout);
}

// the styled convs' backward, K1: the forward's conv of x (UP: the phase
// conv, Cout = 4 Co), g read in the epilogue, gc (N, H, W, Cout) and the
// partials of dL/dsigma written
template <bool UP, class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
styled_conv_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                             const __nv_bfloat16* __restrict__ wpk,
                             __nv_bfloat16* __restrict__ gc, const float* __restrict__ style,
                             const float* __restrict__ sigma, const float* __restrict__ bias,
                             const float* __restrict__ noise, const __nv_bfloat16* __restrict__ g,
                             float* __restrict__ partial, int N, int H, int W, int Cin,
                             int Cout) {
  conv3x3_wgmma_body<UP ? EPI_UP_BWD : EPI_BWD, C>(xmap, wpk, gc, style, sigma, bias, noise, g,
                                                   partial, N, H, W, Cin, Cout);
}

// the styled convs' backward, K2: the conv of gc (xmap, Cin channels) on the
// flipped, channel-transposed weights to Cout = the forward's Cin, x read in
// the epilogue, gx (null: not stored) and the partials of sum_hw gxs x
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
styled_conv_dgrad_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                               const __nv_bfloat16* __restrict__ wpk,
                               __nv_bfloat16* __restrict__ gx, const float* __restrict__ style,
                               const __nv_bfloat16* __restrict__ x, float* __restrict__ partial,
                               int N, int H, int W, int Cin, int Cout) {
  conv3x3_wgmma_body<EPI_DGRAD, C>(xmap, wpk, gx, style, nullptr, nullptr, nullptr, x, partial, N,
                                   H, W, Cin, Cout);
}

// ---- host side ---------------------------------------------------------------
// cuTensorMapEncodeTiled is a driver call; the libraries link only the
// runtime, so it is looked up once through the runtime's entry-point query.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
// C entries return a cudaError_t, or this plus the CUresult when the tensor
// map cannot be encoded
constexpr int TENSOR_MAP_ERROR = 100000;

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// x (N, H, W, Cin) bf16 NHWC as a tiled tensor map with a (ck, bw, bh, 1) box,
// swizzled by the box's pixel row (32, 64 or 128 bytes)
inline int encode_x_map(CUtensorMap* map, const void* x, int N, int H, int W, int Cin, int ck,
                        int bw, int bh) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)Cin * 2, (cuuint64_t)W * Cin * 2,
                                 (cuuint64_t)H * W * Cin * 2};
  const cuuint32_t box[4] = {(cuuint32_t)ck, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = ck == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : ck == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)r;
}

// One launch of the kernel of epilogue EPI in tile class C on x (N, H, W,
// Cin) -> (..., Cout): the checks, x's tensor map, the kernel's attributes
// (once) and a persistent grid over the M tiles of each Cout slice. `args`
// are the kernel's arguments between the tensor map and the shapes.
template <int EPI, class C, class... Args>
int launch_wgmma(const void* x, int N, int H, int W, int Cin, int Cout, cudaStream_t stream,
                 Args... args) {
  const int nchunks = (Cin + C::CK - 1) / C::CK;
  const size_t smem = C::smem_bytes(nchunks);
  if (Cout % C::BN != 0 || Cin % 16 != 0 || smem > MMA_SMEM_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int e = encode_x_map(&map, x, N, H, W, Cin, C::CK, C::TW + 2, C::TH + 2);
  if (e != 0) return e;
  auto kern = [] {
    if constexpr (EPI == EPI_UP)
      return styled_conv_up_wgmma_kernel<C>;
    else if constexpr (EPI == EPI_BWD || EPI == EPI_UP_BWD)
      return styled_conv_bwd_wgmma_kernel<EPI == EPI_UP_BWD, C>;
    else if constexpr (EPI == EPI_DGRAD)
      return styled_conv_dgrad_wgmma_kernel<C>;
    else
      return conv3x3_wgmma_kernel<EPI == EPI_STYLED, C>;
  }();
  static int regs_ok = -1;  // the launch gives each thread what setmaxnreg redistributes
  if (regs_ok < 0) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kern);
    if (err != cudaSuccess) return (int)err;
    regs_ok = attr.numRegs * C::THREADS >= C::PRODUCER_REGS * 128 + C::CONSUMER_REGS * 128 * C::WGS;
  }
  if (!regs_ok) return (int)cudaErrorInvalidConfiguration;
  static size_t smem_set = 0;  // the kernel's dynamic shared memory limit so far
  if (smem > smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  // blocks per SM at each shared memory size asked (a class sees one size a
  // chunk count): after an attack step's eager warm-up, a launch captured
  // in a CUDA graph makes no runtime call but the launch's own
  static size_t occ_smem[8] = {};
  static int occ_blocks[8] = {};
  int per_sm = 0;
  for (int i = 0; i < 8 && occ_smem[i] != 0 && per_sm == 0; ++i)
    if (occ_smem[i] == smem) per_sm = occ_blocks[i];
  if (per_sm == 0) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, C::THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    for (int i = 0; i < 8; ++i)
      if (occ_smem[i] == 0) {
        occ_smem[i] = smem;
        occ_blocks[i] = per_sm;
        break;
      }
  }
  const int n_tiles = Cout / C::BN;
  const int m_tiles = N * ((H + C::TH - 1) / C::TH) * ((W + C::TW - 1) / C::TW);
  int gx = per_sm * sms / n_tiles;
  gx = gx < 1 ? 1 : (gx > m_tiles ? m_tiles : gx);
  kern<<<dim3(gx, n_tiles), C::THREADS, smem, stream>>>(map, args..., N, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}

// f(C{}) for the tile class C of code `cls` (ops/conv3x3.py::MMA_CLASSES)
template <class F>
int with_class(int cls, F&& f) {
  switch (cls) {
    case 0:
      return f(WgNarrow32{});
    case 1:
      return f(WgNarrow64{});
    case 2:
      return f(WgWide{});
    case 3:
      return f(WgMid{});
    case 4:
      return f(WgSmall{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

typedef const __nv_bfloat16* BfIn;
typedef __nv_bfloat16* BfOut;

// The bf16 forward with the tile class `cls` that ops/conv3x3.py::mma_class
// picked (its codes: MMA_CLASSES); wpk packed for that class.
template <bool STYLED>
int launch_conv3x3_wgmma(int cls, const void* x, const void* wpk, void* y, const float* style,
                         const float* sigma, const float* bias, const float* noise, int N, int H,
                         int W, int Cin, int Cout, cudaStream_t stream) {
  return with_class(cls, [&](auto c) {
    return launch_wgmma<STYLED ? EPI_STYLED : EPI_NONE, decltype(c)>(
        x, N, H, W, Cin, Cout, stream, static_cast<BfIn>(wpk), static_cast<BfOut>(y), style,
        sigma, bias, noise);
  });
}

// The styled up conv: x (N, H, W, Cin) -> y (N, 2H, 2W, Co), the phase conv
// to Cout = 4 Co channels in the tile class `cls` that ops/conv3x3.py::
// mma_class picked for it; wpk the phase weights packed for that class.
inline int launch_styled_conv_up_wgmma(int cls, const void* x, const void* wpk, void* y,
                                       const float* style, const float* sigma,
                                       const float* bias, const float* noise, int N, int H,
                                       int W, int Cin, int Co, cudaStream_t stream) {
  if (Co % 8 != 0) return (int)cudaErrorInvalidValue;
  return with_class(cls, [&](auto c) {
    return launch_wgmma<EPI_UP, decltype(c)>(x, N, H, W, Cin, 4 * Co, stream,
                                             static_cast<BfIn>(wpk), static_cast<BfOut>(y), style,
                                             sigma, bias, noise);
  });
}

}  // namespace tf
