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
// Signals.  put_signal runs on a flat grid (below), where a block is no
// longer a row: a wide row spans several blocks, and on a narrow launch one
// block spans several destinations.  So a destination is released once,
// when all of its rows are stored, by the last block to store into it (the
// last-arriver pattern of CUDA's threadFenceReduction sample).  Each block,
// after its stores, synchronises; then for each source domain of its span
// one thread adds the words the block stored for that domain to the
// counter of the domain's destination, with an acquire-release atomic
// (atom.acq_rel.gpu).  The add that completes a destination's M x V words
// raises the destination's arrival word by M with a release reduction
// (red.release.gpu), so after a launch every arrival word equals M, as it
// did when each row released itself.  The
// caller's buffer holds the n_dom arrival words, then the n_dom counters;
// one cudaMemsetAsync on the caller's stream resets both before each
// launch (no epochs), so a stale M of an earlier launch never stands for
// this one's rows.  The caller owns the words (the halo plan allocates
// them once) and can read them back.  Padding rows (index -1) land as zero
// rows and count.
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
// non-coherent read-only path.  Each of its CTAs is one row: after its
// stores it synchronises the block, and one thread releases the row with
// __threadfence() + atomicAdd of 1 on the receiver's arrival word of that
// pulse, so after a launch every arrival word equals M.
//
// Faults of the map trap the kernel, as the plain forms raise: an index
// >= R (put_signal), an index >= n_local in pulse 0, or >= n_local + M in
// any pulse (fused_pulses).  The reference clamps instead and would read
// its own unfilled buffer.
//
// Bound: pure data movement, every payload element read once and written
// once, at 3.35 TB/s of device memory.  At the MD path's halo sizes one
// launch moves well under a megabyte (0.15 us at 3.35 TB/s for a forward
// f32 pulse of grappa-45k on 2x2x2 domains), so launch latency and how
// fast the card fills with loads bound it in practice.  put_signal's
// design, as B1's pack (halo_pack.cu):
//   * one launch per pulse for all domains, on a flat grid: one thread per
//     output word of all n_dom x M x V words, 256-thread blocks, so the
//     forward z pulse (M = 1 row of 31 KB per domain) spreads over ~60
//     blocks rather than 8, and the x pulse's 64 narrow rows share blocks;
//   * a word is 16 bytes where the row's byte width and every base allow
//     it, else 8, else the element (flat_grid.cuh, shared with
//     halo_pack.cu); the converting form moves N elements a thread, N x
//     the wire's width being a 16- or 8-byte output word (f64 -> f32: 4,
//     from two 16-byte loads into one 16-byte store), else one element,
//     on the same grid;
//   * 32-bit index arithmetic, the neighbour with the shift taken mod the
//     ring on the host; a launch of 2^31 words or more is refused
//     (cudaErrorInvalidValue);
//   * the release costs one barrier and, per destination in a block's span
//     (one or two on the MD path's launches), one acquire-release atomic,
//     plus a release reduction for the last arriver: a memset node and one
//     kernel node a launch, nothing else.  The atomic waits for the block's
//     stores to drain and makes a round trip to L2 on the last block's
//     path, which is what the release adds to B1's time.
// fused_pulses keeps one block per work item (above).  The bit copies are
// keyed on element width (b4 serves f32 and int32, b8 f64); put_signal's
// converting form is keyed on (source, wire) element type: it rounds each
// gathered element to the wire dtype in registers and stores only the
// narrow row in the receiver's slab (the reference's wire-dtyped scratch
// and put), so the wire rows are written once and never staged.  It rounds
// as XLA's convert does (WireConv, wire_conv.cuh, shared with halo_pack.cu).
// Kernels run on the caller's stream, allocate nothing and do not
// synchronise.  Each C entry point returns cudaGetLastError() (or the
// memset's error).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "flat_grid.cuh"
#include "wire_conv.cuh"

#include <cstdint>

namespace {

// N elements of T moved as one word, aligned to its size up to 16 bytes (a
// longer word is read as 16-byte loads)
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Lanes {
  T v[N];
};

// the converting put's elements a thread: N wire elements make a 16- or
// 8-byte output word where F and the output base allow it, and the source
// base allows its N elements' 16-byte loads; else one element (never a
// 4-byte word of two 16-bit elements: the launch has no kernel for it)
template <typename S, typename D>
int convert_lanes(int64_t F, const void* src, const void* out) {
  for (int w = 16; w >= 8 && w > static_cast<int>(sizeof(D)); w /= 2) {
    const int n = w / static_cast<int>(sizeof(D));
    const int64_t load = n * sizeof(S) < 16 ? n * sizeof(S) : 16;
    if (F % n == 0 && reinterpret_cast<uintptr_t>(out) % w == 0 &&
        reinterpret_cast<uintptr_t>(src) % load == 0)
      return n;
  }
  return 1;
}

// domain b's neighbour along the exchange axis, in 32-bit arithmetic; the
// shift is taken mod the ring on the host, so 0 <= shift < ring
struct Ring {
  int ring, inner, shift;
  __device__ __forceinline__ int operator()(int b) const {
    const int c = (b / inner) % ring;
    const int to = c + shift < ring ? c + shift : c + shift - ring;
    return b + (to - c) * inner;
  }
};

Ring ring_of(int64_t ring, int64_t inner, int64_t shift) {
  return {static_cast<int>(ring), static_cast<int>(inner),
          static_cast<int>((shift % ring + ring) % ring)};
}

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

// ---- put_signal's release: the last arriver raises a destination ----------
//
// After the block's stores: the words the block stored for each source
// domain of its span [g0, g1) are added to the counter of that domain's
// destination (nb is a bijection, so a destination has one source); the
// add that completes the destination's MV words raises its arrival word by
// M.  The add is acquire-release at device scope: it releases the block's
// stores (ordered before it by the barrier) and acquires those released by
// every earlier add on the counter, so the raise, a release, publishes
// every block's stores into the destination.  One ordered atomic each way
// costs less on the card than __threadfence() around relaxed atomics.

__device__ __forceinline__ int add_acq_rel(int* word, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(word), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ void add_release(int* word, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(word), "r"(v)
               : "memory");
}

__device__ __forceinline__ void release_span(int* arrival, int* stored,
                                             int total, int M, int MV,
                                             Ring nb) {
  __syncthreads();  // every thread's stores of the span are done
  const int g0 = static_cast<int>(blockIdx.x) * kThreads;
  const int g1 = min(g0 + kThreads, total);
  const int b0 = g0 / MV;
  const int n = (g1 - 1) / MV - b0 + 1;  // <= kThreads source domains
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int b = b0 + k;
    const int words = min(g1, (b + 1) * MV) - max(g0, b * MV);
    const int d = nb(b);
    if (add_acq_rel(stored + d, words) + words == MV)
      add_release(arrival + d, M);
  }
}

// ---- put_signal: recv[nb(b), m, :] = idx[m] >= 0 ? src[b, idx[m], :] : 0 --
//
// A copy of bits, so it moves words of W (uint4, uint2, uint32_t) whatever
// the element type; all-zero bits are +0 for every element type.  A
// negative index is padding and writes a zero word.

template <typename W>
__global__ void __launch_bounds__(kThreads)
    put_signal_kernel(const W* __restrict__ src,
                      const int32_t* __restrict__ idx, W* __restrict__ out,
                      int* arrival, int* stored, int R, int M, int V,
                      int total, Ring nb) {
  const int g = static_cast<int>(blockIdx.x) * kThreads + threadIdx.x;
  if (g < total) {
    const int row = g / V;  // b * M + m
    const int v = g - row * V;
    const int b = row / M;
    const int m = row - b * M;
    const int32_t i = __ldg(idx + m);
    if (i >= R) __trap();
    W w{};
    if (i >= 0) w = src[(b * R + i) * V + v];
    out[(nb(b) * M + m) * V + v] = w;
  }
  release_span(arrival, stored, total, M, M * V, nb);
}

// ---- put_signal, converting: recv[nb(b), m, :] = wire(src[b, idx[m], :]) --
//
// A thread converts the N source elements of one output word; each element
// rounds as WireConv says; a padding row is the wire dtype's +0.

template <typename S, typename D, int N>
__global__ void __launch_bounds__(kThreads)
    put_signal_convert_kernel(const Lanes<S, N>* __restrict__ src,
                              const int32_t* __restrict__ idx,
                              Lanes<D, N>* __restrict__ out, int* arrival,
                              int* stored, int R, int M, int V, int total,
                              Ring nb) {
  const int g = static_cast<int>(blockIdx.x) * kThreads + threadIdx.x;
  if (g < total) {
    const int row = g / V;  // b * M + m
    const int v = g - row * V;
    const int b = row / M;
    const int m = row - b * M;
    const int32_t i = __ldg(idx + m);
    if (i >= R) __trap();
    Lanes<D, N> w;
    if (i >= 0) {
      const Lanes<S, N> x = src[(b * R + i) * V + v];
#pragma unroll
      for (int k = 0; k < N; ++k) w.v[k] = WireConv<S, D>::apply(x.v[k]);
    } else {
      const D zero = WireConv<S, D>::apply(S(0));
#pragma unroll
      for (int k = 0; k < N; ++k) w.v[k] = zero;
    }
    out[(nb(b) * M + m) * V + v] = w;
  }
  release_span(arrival, stored, total, M, M * V, nb);
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

bool put_signal_ok(int64_t n_dom, int64_t R, int64_t M, int64_t F,
                   int64_t ring, int64_t inner) {
  return mesh_ok(n_dom, ring, inner) && R >= 1 && M >= 1 && F >= 1;
}

// the arrival words, then the per-destination word counters
cudaError_t reset_words(void* signal, int64_t n_dom, cudaStream_t s) {
  return cudaMemsetAsync(signal, 0, 2 * n_dom * sizeof(int), s);
}

template <typename W>
void put_words(const void* src, const int32_t* idx, void* out, int* signal,
               int64_t n_dom, int64_t R, int64_t M, int64_t V, Ring nb,
               cudaStream_t s) {
  const int64_t total = n_dom * M * V;
  put_signal_kernel<W><<<flat_blocks(total), kThreads, 0, s>>>(
      static_cast<const W*>(src), idx, static_cast<W*>(out), signal,
      signal + n_dom, static_cast<int>(R), static_cast<int>(M),
      static_cast<int>(V), static_cast<int>(total), nb);
}

int launch_put_signal(int elem, const void* src, const void* idx, void* out,
                      void* signal, int64_t n_dom, int64_t R, int64_t M,
                      int64_t F, int64_t ring, int64_t inner, int64_t shift,
                      void* stream) {
  if (!put_signal_ok(n_dom, R, M, F, ring, inner))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t row_bytes = F * elem;
  const int w = word_bytes(row_bytes, elem, {src, out});
  const int64_t V = row_bytes / w;
  if (!fits_32(n_dom * (R > M ? R : M) * V))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = reset_words(signal, n_dom, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  int* sig = static_cast<int*>(signal);
  const Ring nb = ring_of(ring, inner, shift);
  if (w == 16)
    put_words<uint4>(src, ix, out, sig, n_dom, R, M, V, nb, s);
  else if (w == 8)
    put_words<uint2>(src, ix, out, sig, n_dom, R, M, V, nb, s);
  else
    put_words<uint32_t>(src, ix, out, sig, n_dom, R, M, V, nb, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, typename D, int N>
void put_convert_words(const void* src, const int32_t* idx, void* out,
                       int* signal, int64_t n_dom, int64_t R, int64_t M,
                       int64_t V, Ring nb, cudaStream_t s) {
  const int64_t total = n_dom * M * V;
  put_signal_convert_kernel<S, D, N><<<flat_blocks(total), kThreads, 0, s>>>(
      static_cast<const Lanes<S, N>*>(src), idx,
      static_cast<Lanes<D, N>*>(out), signal, signal + n_dom,
      static_cast<int>(R), static_cast<int>(M), static_cast<int>(V),
      static_cast<int>(total), nb);
}

template <typename S, typename D>
int launch_put_signal_convert(const void* src, const void* idx, void* out,
                              void* signal, int64_t n_dom, int64_t R,
                              int64_t M, int64_t F, int64_t ring,
                              int64_t inner, int64_t shift, void* stream) {
  if (!put_signal_ok(n_dom, R, M, F, ring, inner))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = convert_lanes<S, D>(F, src, out);
  const int64_t V = F / n;
  if (!fits_32(n_dom * (R > M ? R : M) * V))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = reset_words(signal, n_dom, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  int* sig = static_cast<int*>(signal);
  const Ring nb = ring_of(ring, inner, shift);
  constexpr int N16 = 16 / sizeof(D);  // elements of a 16-byte wire word
  if (n == N16)
    put_convert_words<S, D, N16>(src, ix, out, sig, n_dom, R, M, V, nb, s);
  else if (n == N16 / 2)
    put_convert_words<S, D, N16 / 2>(src, ix, out, sig, n_dom, R, M, V, nb,
                                     s);
  else
    put_convert_words<S, D, 1>(src, ix, out, sig, n_dom, R, M, V, nb, s);
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

// by element width in bytes: both kernels are bit copies (put_signal picks
// its word from the width and the bases, fused_pulses moves W or uint4)
#define REPRO_SIGNAL_ENTRIES(BYTES, W)                                       \
  extern "C" int halo_put_signal_b##BYTES(                                   \
      const void* src, const void* idx, void* out, void* signal,             \
      int64_t n_dom, int64_t R, int64_t M, int64_t F, int64_t ring,          \
      int64_t inner, int64_t shift, void* stream) {                          \
    return launch_put_signal(BYTES, src, idx, out, signal, n_dom, R, M, F,  \
                             ring, inner, shift, stream);                    \
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
