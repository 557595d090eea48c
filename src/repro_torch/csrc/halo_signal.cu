// Put-with-signal halo kernels for Hopper (sm_90a), batched over the
// virtual domain mesh.
//
// Replaces the TPU kernels of the JAX package:
//   halo_put_signal_b*    <- src/repro/kernels/halo_pack.py:put_signal
//                            (_put_signal_kernel)
//   halo_put_signal_<s>_to_<w>  <- the same with wire_dtype= (scratch, put
//                            and receive buffer in the wire dtype)
//   halo_fused_pulses_b*  <- src/repro/kernels/halo_pack.py:fused_pulses
//                            (_fused_pulses_kernel)
//
// The domain layout is the port's virtual mesh: src is (n_dom, R, F) with
// the domains row-major over the mesh, and one index map serves every
// domain.  A "put" is a store into the neighbour domain's receive slab,
// so the pack, the put and the ring shift are one pass (no pack followed
// by a roll).  Along the exchange axis (size `ring`, domain stride
// `inner`) domain b's neighbour is b + ((c + shift) mod ring - c) * inner,
// c being b's coordinate on that axis.
//
// Signals.  After a CTA has written its chunk into the receiver's slab it
// synchronises the block, and one thread releases the chunk with
// __threadfence() + atomicAdd on the receiver's arrival word (the pattern
// of a cooperative-groups grid sync).  A chunk is one row of the map, so
// after a pulse every arrival word equals M.  Words are reset with
// cudaMemsetAsync on the caller's stream before each launch (no epochs):
// the caller owns them (the halo plan allocates them once) and can read
// them back.  Padding rows (index -1) land as zero rows and count.
//
// fused_pulses runs all pulses of one dim in one launch.  Work items are
// (pulse, source domain, row), numbered pulse-major, and each CTA takes
// its item from an atomic ticket counter rather than from blockIdx.  An
// entry in [n_local, n_local + M) reads row (entry - n_local) of the
// previous pulse's receive buffer of its own domain (staged forwarding):
// the CTA first acquire-waits until that buffer's arrival word equals M
// (one thread spins on a volatile load with __nanosleep backoff, then
// __threadfence() and __syncthreads()).  Every item such a wait depends on
// has a smaller ticket, so it was taken by a CTA that is already resident
// and can finish: the wait cannot deadlock at any grid size, with no
// cooperative launch and no persistent-grid sizing.  The kernel writes the
// buffer it reads, so `out` is not __restrict__ and the forwarded rows are
// read with __ldcg (L2, coherent across SMs), never through the
// non-coherent read-only path.
//
// Faults of the map trap the kernel, as the plain forms raise: an index
// >= R (put_signal), an index >= n_local in pulse 0, or >= n_local + M in
// any pulse (fused_pulses).  The reference clamps instead and would read
// its own unfilled buffer.
//
// Bound: pure data movement, every payload element read once and written
// once, at 3.35 TB/s of device memory.  At the MD path's halo sizes one
// launch moves well under a megabyte, so launch latency bounds it in
// practice; the design keeps each pulse (put_signal) or each dim
// (fused_pulses) to one launch for all domains, and moves 16-byte words
// where the row width and the bases allow.  Kernels are bit copies keyed
// on element width (b4 serves f32 and int32, b8 f64), except put_signal's
// converting form, keyed on (source, wire) element type: it rounds each
// gathered element to the wire dtype in registers and stores only the
// narrow row in the receiver's slab (the reference's wire-dtyped scratch
// and put), so the wire rows are written once and never staged.  It rounds
// as XLA's convert does (WireConv, wire_conv.cuh, shared with halo_pack.cu).
// Kernels run on the caller's stream, allocate nothing and do not
// synchronise.  Each C entry point
// returns cudaGetLastError() (or the memset's error).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "wire_conv.cuh"

#include <cstdint>

namespace {

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int threads_for(int64_t width) {
  // one warp per 32 words of the row, between one warp and 256 threads
  int64_t t = ((width + 31) / 32) * 32;
  if (t < 32) t = 32;
  if (t > 256) t = 256;
  return static_cast<int>(t);
}

template <typename W>
__device__ __forceinline__ W zero_word() {
  return W{};
}

template <>
__device__ __forceinline__ uint4 zero_word<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ int64_t neighbour(int64_t b, int64_t ring,
                                             int64_t inner, int64_t shift) {
  const int64_t c = (b / inner) % ring;
  const int64_t to = ((c + shift) % ring + ring) % ring;
  return b + (to - c) * inner;
}

__device__ __forceinline__ void release(int* word) {
  __syncthreads();  // every thread's stores of the chunk are done
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(word, 1);
  }
}

// ---- put_signal: recv[nb(b), m, :] = idx[m] >= 0 ? src[b, idx[m], :] : 0 --

template <typename W>
__global__ void put_signal_kernel(const W* __restrict__ src,
                                  const int32_t* __restrict__ idx,
                                  W* __restrict__ out, int* signal,
                                  int64_t R, int64_t M, int64_t F,
                                  int64_t ring, int64_t inner,
                                  int64_t shift) {
  const int64_t m = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t dst = neighbour(b, ring, inner, shift);
  const int32_t i = idx[m];
  if (i >= R) __trap();
  W* to = out + (dst * M + m) * F;
  if (i < 0) {
    const W zero = zero_word<W>();
    for (int64_t f = threadIdx.x; f < F; f += blockDim.x) to[f] = zero;
  } else {
    const W* row = src + (b * R + i) * F;
    for (int64_t f = threadIdx.x; f < F; f += blockDim.x) to[f] = row[f];
  }
  release(signal + dst);
}

// ---- put_signal, converting: recv[nb(b), m, :] = wire(src[b, idx[m], :]) --
//
// Each element rounds as WireConv says; a padding row is the wire dtype's +0.

template <typename S, typename D>
__global__ void put_signal_convert_kernel(const S* __restrict__ src,
                                          const int32_t* __restrict__ idx,
                                          D* __restrict__ out, int* signal,
                                          int64_t R, int64_t M, int64_t F,
                                          int64_t ring, int64_t inner,
                                          int64_t shift) {
  const int64_t m = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t dst = neighbour(b, ring, inner, shift);
  const int32_t i = idx[m];
  if (i >= R) __trap();
  D* to = out + (dst * M + m) * F;
  if (i < 0) {
    const D zero = WireConv<S, D>::apply(S(0));
    for (int64_t f = threadIdx.x; f < F; f += blockDim.x) to[f] = zero;
  } else {
    const S* row = src + (b * R + i) * F;
    for (int64_t f = threadIdx.x; f < F; f += blockDim.x)
      to[f] = WireConv<S, D>::apply(row[f]);
  }
  release(signal + dst);
}

// ---- fused_pulses: all pulses of one dim, put to the -1 neighbour ----------

template <typename W>
__global__ void fused_pulses_kernel(const W* __restrict__ src,
                                    const int32_t* __restrict__ idx, W* out,
                                    int* arrival, int* ticket, int64_t n_dom,
                                    int64_t R, int64_t n_local, int64_t P,
                                    int64_t M, int64_t F, int64_t ring,
                                    int64_t inner) {
  __shared__ int s_item;
  if (threadIdx.x == 0) s_item = atomicAdd(ticket, 1);
  __syncthreads();
  const int64_t item = s_item;
  const int64_t m = item % M;
  const int64_t b = (item / M) % n_dom;
  const int64_t p = item / (M * n_dom);
  const int32_t i = idx[p * M + m];
  if (i >= n_local + M || (p == 0 && i >= n_local)) __trap();
  const bool dep = i >= n_local;
  if (dep && threadIdx.x == 0) {
    // acquire: the previous pulse's receive buffer of this domain is full
    volatile int* flag = arrival + b * P + (p - 1);
    unsigned ns = 32;
    while (*flag < M) {
      __nanosleep(ns);
      if (ns < 1024) ns *= 2;
    }
    __threadfence();
  }
  __syncthreads();
  const int64_t dst = neighbour(b, ring, inner, -1);
  W* to = out + ((dst * P + p) * M + m) * F;
  if (i < 0) {
    const W zero = zero_word<W>();
    for (int64_t f = threadIdx.x; f < F; f += blockDim.x) to[f] = zero;
  } else if (dep) {
    const W* row = out + ((b * P + (p - 1)) * M + (i - n_local)) * F;
    for (int64_t f = threadIdx.x; f < F; f += blockDim.x)
      to[f] = __ldcg(row + f);
  } else {
    const W* row = src + (b * R + i) * F;
    for (int64_t f = threadIdx.x; f < F; f += blockDim.x) to[f] = row[f];
  }
  release(arrival + dst * P + p);
}

bool mesh_ok(int64_t n_dom, int64_t ring, int64_t inner) {
  return n_dom >= 1 && ring >= 1 && inner >= 1 && n_dom % (ring * inner) == 0;
}

template <typename W>
int launch_put_signal(const void* src, const void* idx, void* out,
                      void* signal, int64_t n_dom, int64_t R, int64_t M,
                      int64_t F, int64_t ring, int64_t inner, int64_t shift,
                      void* stream) {
  if (!mesh_ok(n_dom, ring, inner) || n_dom > 65535 || M < 1 ||
      M > 2147483647 || F < 1 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(signal, 0, n_dom * sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(M), static_cast<unsigned>(n_dom));
  const int64_t row_bytes = F * static_cast<int64_t>(sizeof(W));
  const int32_t* ix = static_cast<const int32_t*>(idx);
  int* sig = static_cast<int*>(signal);
  if (row_bytes % 16 == 0 && aligned16(src) && aligned16(out)) {
    const int64_t V = row_bytes / 16;
    put_signal_kernel<uint4><<<grid, threads_for(V), 0, s>>>(
        static_cast<const uint4*>(src), ix, static_cast<uint4*>(out), sig, R,
        M, V, ring, inner, shift);
  } else {
    put_signal_kernel<W><<<grid, threads_for(F), 0, s>>>(
        static_cast<const W*>(src), ix, static_cast<W*>(out), sig, R, M, F,
        ring, inner, shift);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename S, typename D>
int launch_put_signal_convert(const void* src, const void* idx, void* out,
                              void* signal, int64_t n_dom, int64_t R,
                              int64_t M, int64_t F, int64_t ring,
                              int64_t inner, int64_t shift, void* stream) {
  if (!mesh_ok(n_dom, ring, inner) || n_dom > 65535 || M < 1 ||
      M > 2147483647 || F < 1 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(signal, 0, n_dom * sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(M), static_cast<unsigned>(n_dom));
  put_signal_convert_kernel<S, D><<<grid, threads_for(F), 0, s>>>(
      static_cast<const S*>(src), static_cast<const int32_t*>(idx),
      static_cast<D*>(out), static_cast<int*>(signal), R, M, F, ring, inner,
      shift);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
int launch_fused_pulses(const void* src, const void* idx, void* out,
                        void* words, int64_t n_dom, int64_t R,
                        int64_t n_local, int64_t P, int64_t M, int64_t F,
                        int64_t ring, int64_t inner, void* stream) {
  if (!mesh_ok(n_dom, ring, inner) || M < 1 || F < 1 || P < 1 ||
      n_local < 1 || n_local > R || P * n_dom * M > 2147483647)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // arrival[n_dom * P] then the ticket counter
  cudaError_t e =
      cudaMemsetAsync(words, 0, (n_dom * P + 1) * sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  int* arrival = static_cast<int*>(words);
  int* ticket = arrival + n_dom * P;
  const unsigned grid = static_cast<unsigned>(P * n_dom * M);
  const int64_t row_bytes = F * static_cast<int64_t>(sizeof(W));
  const int32_t* ix = static_cast<const int32_t*>(idx);
  if (row_bytes % 16 == 0 && aligned16(src) && aligned16(out)) {
    const int64_t V = row_bytes / 16;
    fused_pulses_kernel<uint4><<<grid, threads_for(V), 0, s>>>(
        static_cast<const uint4*>(src), ix, static_cast<uint4*>(out),
        arrival, ticket, n_dom, R, n_local, P, M, V, ring, inner);
  } else {
    fused_pulses_kernel<W><<<grid, threads_for(F), 0, s>>>(
        static_cast<const W*>(src), ix, static_cast<W*>(out), arrival,
        ticket, n_dom, R, n_local, P, M, F, ring, inner);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// by element width in bytes: both kernels are bit copies
#define REPRO_SIGNAL_ENTRIES(BYTES, W)                                       \
  extern "C" int halo_put_signal_b##BYTES(                                   \
      const void* src, const void* idx, void* out, void* signal,             \
      int64_t n_dom, int64_t R, int64_t M, int64_t F, int64_t ring,          \
      int64_t inner, int64_t shift, void* stream) {                          \
    return launch_put_signal<W>(src, idx, out, signal, n_dom, R, M, F, ring, \
                                inner, shift, stream);                       \
  }                                                                          \
  extern "C" int halo_fused_pulses_b##BYTES(                                 \
      const void* src, const void* idx, void* out, void* words,              \
      int64_t n_dom, int64_t R, int64_t n_local, int64_t P, int64_t M,       \
      int64_t F, int64_t ring, int64_t inner, void* stream) {                \
    return launch_fused_pulses<W>(src, idx, out, words, n_dom, R, n_local,   \
                                  P, M, F, ring, inner, stream);             \
  }

// put_signal's converting form by (source, wire) element type
#define REPRO_PUT_SIGNAL_CONVERT_ENTRY(NAME, S, D)                           \
  extern "C" int halo_put_signal_##NAME(                                     \
      const void* src, const void* idx, void* out, void* signal,             \
      int64_t n_dom, int64_t R, int64_t M, int64_t F, int64_t ring,          \
      int64_t inner, int64_t shift, void* stream) {                          \
    return launch_put_signal_convert<S, D>(src, idx, out, signal, n_dom, R,  \
                                           M, F, ring, inner, shift,         \
                                           stream);                          \
  }

REPRO_SIGNAL_ENTRIES(4, unsigned int)
REPRO_SIGNAL_ENTRIES(8, unsigned long long)
REPRO_PUT_SIGNAL_CONVERT_ENTRY(f64_to_f32, double, float)
REPRO_PUT_SIGNAL_CONVERT_ENTRY(f64_to_bf16, double, __nv_bfloat16)
REPRO_PUT_SIGNAL_CONVERT_ENTRY(f64_to_f16, double, __half)
REPRO_PUT_SIGNAL_CONVERT_ENTRY(f32_to_bf16, float, __nv_bfloat16)
REPRO_PUT_SIGNAL_CONVERT_ENTRY(f32_to_f16, float, __half)
