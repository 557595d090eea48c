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
// fused_pulses runs all pulses of one dim in one launch, on the same flat
// grid.  Its work space is P pulses x n_dom x M x V words, pulse-major, and
// each pulse is padded up to a whole number of blocks, so no block
// straddles two pulses.  A block takes its place in that space from an
// atomic ticket counter rather than from blockIdx.  An entry in [n_local,
// n_local + M) reads row (entry - n_local) of the previous pulse's receive
// buffer of its own domain (staged forwarding): a block that holds such a
// word (__syncthreads_or) first acquire-waits until the arrival word of
// (source domain, p - 1) equals M, for each source domain of its span (one
// thread a domain spins on ld.acquire.gpu with __nanosleep backoff, then
// the block syncs); a block of local or padding words never waits.  Every
// block such a wait depends on holds words of an earlier pulse, so it took
// a smaller ticket: it is already resident and can finish, and the wait
// cannot deadlock at any grid size, with no cooperative launch and no
// persistent-grid sizing.  Were a block to straddle pulses p - 1 and p, it
// could wait for a destination into which it has not yet stored its own
// words of p - 1, and the card would hang: hence the padding.  The kernel
// writes the buffer it reads, so `out` is not __restrict__ and the
// forwarded words are read with __ldcg (L2, coherent across SMs), never
// through the non-coherent read-only path.  The release is put_signal's,
// per (destination, pulse): the caller's words hold the arrival words
// [n_dom x P], then the counters [n_dom x P], then the ticket, all reset by
// the launch's one cudaMemsetAsync; after a launch every arrival word
// equals M, every counter M x V and the ticket the launch's block count.
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
// fused_pulses moves the same words on the same grid (above).  The bit
// copies are keyed on element width (b4 serves f32 and int32, b8 f64);
// put_signal's converting form is keyed on (source, wire) element type
// (convert_lanes and Lanes in flat_grid.cuh, shared with halo_pack.cu's
// converting pack): it rounds each
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

// the release of the words [g0, g1) of one launch (or one pulse), each
// destination d's arrival word and counter at arrival[d * stride] and
// stored[d * stride]; after a barrier over the block's stores
__device__ __forceinline__ void release_range(int* arrival, int* stored,
                                              int stride, int g0, int g1,
                                              int M, int MV, Ring nb) {
  const int b0 = g0 / MV;
  const int n = (g1 - 1) / MV - b0 + 1;  // <= kThreads source domains
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int b = b0 + k;
    const int words = min(g1, (b + 1) * MV) - max(g0, b * MV);
    const int d = nb(b) * stride;
    if (add_acq_rel(stored + d, words) + words == MV)
      add_release(arrival + d, M);
  }
}

__device__ __forceinline__ void release_span(int* arrival, int* stored,
                                             int total, int M, int MV,
                                             Ring nb) {
  __syncthreads();  // every thread's stores of the span are done
  const int g0 = static_cast<int>(blockIdx.x) * kThreads;
  release_range(arrival, stored, 1, g0, min(g0 + kThreads, total), M, MV,
                nb);
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

__device__ __forceinline__ int load_acquire(const int* word) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(word)
               : "memory");
  return v;
}

// out[nb(b), p, m, :] = entry < 0 ? 0 : entry < n_local ? src[b, entry, :]
//                       : out[b, p - 1, entry - n_local, :]
// (entry = idx[p, m]) for every pulse p, nb the -1 neighbour; W the word
template <typename W>
__global__ void __launch_bounds__(kThreads)
    fused_pulses_kernel(const W* __restrict__ src,
                        const int32_t* __restrict__ idx, W* out,
                        int* arrival, int* stored, int* ticket, int R,
                        int n_local, int P, int M, int V, int per_pulse,
                        int total, Ring nb) {
  __shared__ int s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  const int p = s_ticket / per_pulse;  // blocks of one pulse, pulse-major
  const int g0 = (s_ticket - p * per_pulse) * kThreads;
  const int g = g0 + threadIdx.x;
  const int MV = M * V;
  int b = 0, m = 0, v = 0;
  int32_t i = -1;
  if (g < total) {
    const int row = g / V;  // b * M + m
    v = g - row * V;
    b = row / M;
    m = row - b * M;
    i = __ldg(idx + p * M + m);
    if (i >= n_local + M || (p == 0 && i >= n_local)) __trap();
  }
  const bool dep = i >= n_local;
  const int g1 = min(g0 + kThreads, total);
  if (__syncthreads_or(dep)) {
    // acquire: the previous pulse's receive buffer of each source domain
    // of the span is full
    const int b0 = g0 / MV;
    const int n = (g1 - 1) / MV - b0 + 1;
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const int* flag = arrival + (b0 + k) * P + (p - 1);
      unsigned ns = 32;
      while (load_acquire(flag) < M) {
        __nanosleep(ns);
        if (ns < 256) ns *= 2;
      }
    }
    __syncthreads();
  }
  if (g < total) {
    W w{};
    if (dep)
      w = __ldcg(out + ((b * P + (p - 1)) * M + (i - n_local)) * V + v);
    else if (i >= 0)
      w = src[(b * R + i) * V + v];
    out[((nb(b) * P + p) * M + m) * V + v] = w;
  }
  __syncthreads();  // every thread's stores of the span are done
  release_range(arrival + p, stored + p, P, g0, g1, M, MV, nb);
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
void fused_words(const void* src, const int32_t* idx, void* out, int* words,
                 int64_t n_dom, int64_t R, int64_t n_local, int64_t P,
                 int64_t M, int64_t V, Ring nb, cudaStream_t s) {
  const int64_t total = n_dom * M * V;  // words of one pulse
  const unsigned per_pulse = flat_blocks(total);
  fused_pulses_kernel<W><<<per_pulse * static_cast<unsigned>(P), kThreads,
                           0, s>>>(
      static_cast<const W*>(src), idx, static_cast<W*>(out), words,
      words + n_dom * P, words + 2 * n_dom * P, static_cast<int>(R),
      static_cast<int>(n_local), static_cast<int>(P), static_cast<int>(M),
      static_cast<int>(V), static_cast<int>(per_pulse),
      static_cast<int>(total), nb);
}

int launch_fused_pulses(int elem, const void* src, const void* idx,
                        void* out, void* words, int64_t n_dom, int64_t R,
                        int64_t n_local, int64_t P, int64_t M, int64_t F,
                        int64_t ring, int64_t inner, void* stream) {
  if (!mesh_ok(n_dom, ring, inner) || M < 1 || F < 1 || P < 1 ||
      n_local < 1 || n_local > R)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t row_bytes = F * elem;
  const int w = word_bytes(row_bytes, elem, {src, out});
  const int64_t V = row_bytes / w;
  const int64_t padded = P * flat_blocks(n_dom * M * V) * kThreads;
  if (!fits_32(n_dom * R * V) || !fits_32(padded))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the arrival words, the counters, then the ticket
  cudaError_t e =
      cudaMemsetAsync(words, 0, (2 * n_dom * P + 1) * sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  int* wd = static_cast<int*>(words);
  const Ring nb = ring_of(ring, inner, -1);
  if (w == 16)
    fused_words<uint4>(src, ix, out, wd, n_dom, R, n_local, P, M, V, nb, s);
  else if (w == 8)
    fused_words<uint2>(src, ix, out, wd, n_dom, R, n_local, P, M, V, nb, s);
  else
    fused_words<uint32_t>(src, ix, out, wd, n_dom, R, n_local, P, M, V, nb,
                          s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// by element width in bytes: both kernels are bit copies, each picking its
// word from the width and the bases
#define REPRO_SIGNAL_ENTRIES(BYTES)                                          \
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
    return launch_fused_pulses(BYTES, src, idx, out, words, n_dom, R,        \
                               n_local, P, M, F, ring, inner, stream);       \
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

REPRO_SIGNAL_ENTRIES(4)
REPRO_SIGNAL_ENTRIES(8)
REPRO_PUT_SIGNAL_CONVERT_ENTRY(f64_to_f32, double, float)
REPRO_PUT_SIGNAL_CONVERT_ENTRY(f64_to_bf16, double, __nv_bfloat16)
REPRO_PUT_SIGNAL_CONVERT_ENTRY(f64_to_f16, double, __half)
REPRO_PUT_SIGNAL_CONVERT_ENTRY(f32_to_bf16, float, __nv_bfloat16)
REPRO_PUT_SIGNAL_CONVERT_ENTRY(f32_to_f16, float, __half)
