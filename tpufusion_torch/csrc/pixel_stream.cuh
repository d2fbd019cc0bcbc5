// Streaming machinery of the two pixel-update kernels (pgd_update.cu,
// adam_update.cu): an elementwise op over NIN input streams and NOUT output
// streams of one element type, each element read once and written once.
//
// Bound on an H100: the bytes (a few operations per 16 bytes), so the design
// is about bytes in flight, the head and tail of the buffer, how evenly the
// SMs share the work, and the cost of a launch. Where every pointer has the
// same offset from a 16-byte boundary (all aligned, or a view a few elements
// off), the elements between the first aligned one and the last whole
// 16-byte vector (the body) go through 16-byte evict-first loads and stores
// (ld/st.global.cs: each byte is touched once); the head, the ragged tail,
// and the whole buffer where the pointers are misaligned differently take a
// masked scalar loop. The body's grid is one of two, picked per launch from
// the body's bytes per stream (measured on the shapes of the attacks,
// PERF.md section 6):
//
// - waves, from the op's ``waves_from`` bytes up: a block per 256 vectors,
//   one vector of each stream a thread, as many blocks as the body has; the
//   hardware hands each block to whichever SM frees first, so the SMs end
//   together. fused_adam (4 reads, 3 writes) at every size, pgd_update
//   (3 reads, 1 write) from 5 x 1024^2 x 3 up.
// - persistent, below it: as many blocks as the SMs hold, each thread
//   loading kUnroll vectors of every stream before it computes any, then the
//   next kUnroll. pgd_update up to 2 x 1024^2 x 3 (10% faster than waves at
//   4 x 512^2 x 3).
//
// A launch allocates nothing and runs on the caller's stream, and after its
// first call asks the runtime nothing but the current device, so it can be
// captured in a CUDA graph.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf_stream {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // persistent: vectors of each stream in flight a thread

template <typename T, int NIN, int NOUT>
struct Streams {
  const T* in[NIN];
  T* out[NOUT];
};

// [head, head + body) streams; the rest, n - body elements, is scalar.
struct Split {
  long long head, body;
};

inline Split split(const void* const* ptrs, int nptr, long long n, int esz) {
  const uintptr_t m = reinterpret_cast<uintptr_t>(ptrs[0]) % 16;
  for (int i = 1; i < nptr; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != m) return {n, 0};
  if (m % esz) return {n, 0};
  long long head = static_cast<long long>((16 - m) % 16) / esz;
  if (head > n) head = n;
  const long long vec = 16 / esz;
  return {head, (n - head) / vec * vec};
}

// the op on one lane of a 16-byte vector of each stream
template <typename T, int NIN, int NOUT, class Op>
__device__ __forceinline__ void apply_vec(const Op& op, const uint4 (&v)[NIN],
                                          uint4 (&o)[NOUT]) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    T a[NIN], b[NOUT];
#pragma unroll
    for (int i = 0; i < NIN; ++i) a[i] = reinterpret_cast<const T*>(&v[i])[k];
    op(a, b);
#pragma unroll
    for (int j = 0; j < NOUT; ++j) reinterpret_cast<T*>(&o[j])[k] = b[j];
  }
}

// the head, the tail, or (body == 0) the whole buffer, one element a thread
template <typename T, int NIN, int NOUT, class Op>
__device__ __forceinline__ void scalar_part(const Streams<T, NIN, NOUT>& s, long long n,
                                            Split sp, const Op& op) {
  const long long rest = n - sp.body;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < rest; i += stride) {
    const long long e = i < sp.head ? i : i + sp.body;
    T a[NIN], b[NOUT];
#pragma unroll
    for (int ii = 0; ii < NIN; ++ii) a[ii] = s.in[ii][e];
    op(a, b);
#pragma unroll
    for (int j = 0; j < NOUT; ++j) s.out[j][e] = b[j];
  }
}

// The register kernel: each thread takes vectors base, base + stride, ...
// (stride = kThreads * gridDim.x), U at a time, all U loads before any
// compute. With one vector of each stream a thread (the waves grid) the loop
// runs once.
template <typename T, int NIN, int NOUT, class Op, int U>
__global__ void __launch_bounds__(kThreads)
    stream_reg_kernel(Streams<T, NIN, NOUT> s, long long n, Split sp, Op op) {
  constexpr int VEC = 16 / sizeof(T);
  scalar_part(s, n, sp, op);
  const long long nvec = sp.body / VEC;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long base = (long long)blockIdx.x * kThreads + threadIdx.x; base < nvec;
       base += U * stride) {
    uint4 v[U][NIN];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * stride < nvec)
#pragma unroll
        for (int i = 0; i < NIN; ++i)
          v[u][i] = __ldcs(reinterpret_cast<const uint4*>(s.in[i] + sp.head) + base + u * stride);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * stride < nvec) {
        uint4 o[NOUT];
        apply_vec<T>(op, v[u], o);
#pragma unroll
        for (int j = 0; j < NOUT; ++j)
          __stcs(reinterpret_cast<uint4*>(s.out[j] + sp.head) + base + u * stride, o[j]);
      }
  }
}

// Launch `kernel` on `grid` blocks, or, with grid 0, on as many as the SMs
// hold at once (at most `want`); returns a cudaError_t.
template <auto kernel, class... Args>
int launch_on(long long grid, long long want, cudaStream_t st, Args... args) {
  if (grid == 0) {
    static int per_sm = 0;  // resident blocks per SM, one value per kernel
    if (per_sm == 0) {
      const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                          kThreads, 0);
      if (e != cudaSuccess) return (int)e;
    }
    static int sm_count[64] = {};  // SMs of each device, asked once
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (sm_count[dev] == 0) {
      e = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return (int)e;
    }
    const int sms = sm_count[dev];
    grid = want < (long long)sms * per_sm ? want : (long long)sms * per_sm;
  }
  kernel<<<dim3((unsigned)(grid < 1 ? 1 : grid)), kThreads, 0, st>>>(args...);
  return (int)cudaGetLastError();
}

// Launch the op over n elements on stream st: the waves grid where the body
// holds at least waves_from bytes of each stream, else the persistent one.
// Returns a cudaError_t.
template <typename T, int NIN, int NOUT, class Op>
int launch(const Streams<T, NIN, NOUT>& s, long long n, const Op& op, long long waves_from,
           cudaStream_t st) {
  const void* ptrs[NIN + NOUT];
  for (int i = 0; i < NIN; ++i) ptrs[i] = s.in[i];
  for (int j = 0; j < NOUT; ++j) ptrs[NIN + j] = s.out[j];
  const Split sp = split(ptrs, NIN + NOUT, n, sizeof(T));
  // blocks for every vector of the body, one a thread (or element of the rest)
  const long long vec = 16 / sizeof(T);
  long long blocks = (sp.body / vec + kThreads - 1) / kThreads;
  const long long rest = (n - sp.body + kThreads - 1) / kThreads;
  if (rest > blocks) blocks = rest;
  if (sp.body * (long long)sizeof(T) >= waves_from)
    return launch_on<stream_reg_kernel<T, NIN, NOUT, Op, 1>>(blocks, blocks, st, s, n, sp, op);
  return launch_on<stream_reg_kernel<T, NIN, NOUT, Op, kUnroll>>(0, blocks, st, s, n, sp, op);
}

}  // namespace tf_stream
