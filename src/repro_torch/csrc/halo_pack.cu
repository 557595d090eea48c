// Halo pack and unpack-add kernels for Hopper (sm_90a), batched over the
// virtual domain mesh.
//
// Replaces the TPU kernels of the JAX package:
//   halo_pack_b*       <- src/repro/kernels/halo_pack.py:pack (_pack_kernel)
//   halo_pack_<s>_to_<w>  <- the same with wire_dtype= (the gathered rows
//                         rounded to the wire dtype before the store)
//   halo_unpack_add_*  <- src/repro/kernels/halo_pack.py:unpack_add
//                         (_unpack_add_kernel)
//
// What bounds them on an H100.  Both are gathers: pack reads each gathered
// byte once and writes it once, unpack-add reads the destination and the
// received rows once and writes the destination once.  No byte is used
// twice, so staging through shared memory or a TMA bulk copy
// (cp.async.bulk) would add a hop without cutting a byte.  The bound is
// device memory at 3.35 TB/s, and at the MD path's halo sizes (0.03 to
// 2.3 MB a launch) it is a microsecond or less: what is left is the
// launch latency and how fast the card fills with loads.
//
// The design (flat_grid.cuh, shared with halo_signal.cu):
//   * a flat grid: one thread per word of the output, 256-thread blocks,
//     over all n_dom x rows x words of a launch, so one launch serves every
//     domain of the virtual mesh and a pulse of one wide row (the forward
//     z pulse: M = 1 row of 31 KB per domain) still spreads over ~60
//     blocks;
//   * a word is 16 bytes where the row's byte width and every base pointer
//     allow it, else 8, else the element (4 or 8 bytes), on the same grid;
//     the converting pack moves N source elements a thread, N x the wire's
//     width being a 16- or 8-byte output word (f64 -> f32: 4, from two
//     16-byte loads into one 16-byte store), else one element;
//   * each thread finds (domain, row, word) from its index in 32-bit
//     arithmetic, and reads its map entry through the read-only path; a
//     launch whose arrays hold 2^31 words or more is refused
//     (cudaErrorInvalidValue; the MD path's halos are a few MB);
//   * unpack-add is one pass over the destination, through the map's
//     inverse (inv[r] = the received row added into row r, or -1): a
//     mapped word is dst + rows, an unmapped one is copied as it is (never
//     + 0: -0.0 + 0.0 is +0.0).  Each element gets at most one add, with
//     no atomics and no copy of dst before the kernel: the result is
//     bitwise the plain indexed add.
// A pack index >= R, and an inverse entry outside [-1, M), is a fault of
// the caller's map (the halo plan checks its maps when it builds them):
// the kernel traps rather than read outside the block, as the plain form
// raises.  Kernels run on the caller's stream, allocate nothing and do
// not synchronise.  Each C entry point returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "flat_grid.cuh"
#include "wire_conv.cuh"

#include <cstdint>

namespace {

// ---- pack: out[b, m, :] = idx[m] >= 0 ? src[b, idx[m], :] : 0 ------------
//
// Pack is a copy of bits, so it moves words of W (uint4, uint2, uint32_t)
// whatever the element type; all-zero bits are +0 for every element type.
// A negative index is padding and writes a zero word.

template <typename W>
__global__ void __launch_bounds__(kThreads)
    pack_kernel(const W* __restrict__ src, const int32_t* __restrict__ idx,
                W* __restrict__ out, int R, int M, int V, int total) {
  const int g = static_cast<int>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= total) return;
  const int row = g / V;             // b * M + m
  const int v = g - row * V;
  const int b = row / M;
  const int m = row - b * M;
  const int32_t i = __ldg(idx + m);
  if (i >= R) __trap();
  W w{};
  if (i >= 0) w = src[(b * R + i) * V + v];
  out[g] = w;
}

// ---- converting pack: out[b, m, :] = wire(src[b, idx[m], :]) --------------
//
// The wire form (compressed halo payloads): the gathered row is rounded to
// the wire dtype in registers and only the narrow row is stored, so the
// source rows are read once and the wire rows written once.  A thread
// converts the N source elements of one output word; each cast rounds as
// XLA's convert does (WireConv, wire_conv.cuh).  A padding row is the wire
// dtype's +0.

template <typename S, typename D, int N>
__global__ void __launch_bounds__(kThreads)
    pack_convert_kernel(const Lanes<S, N>* __restrict__ src,
                        const int32_t* __restrict__ idx,
                        Lanes<D, N>* __restrict__ out, int R, int M, int V,
                        int total) {
  const int g = static_cast<int>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= total) return;
  const int row = g / V;             // b * M + m
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
  out[g] = w;
}

// ---- unpack-add: out[b, r, :] = dst[b, r, :] (+ rows[b, inv[r], :]) ------

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    unpack_add_kernel(const Lanes<T, N>* __restrict__ dst,
                      const int32_t* __restrict__ inv,
                      const Lanes<T, N>* __restrict__ rows,
                      Lanes<T, N>* __restrict__ out, int R, int M, int V,
                      int total) {
  const int g = static_cast<int>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= total) return;
  const int row = g / V;             // b * R + r
  const int v = g - row * V;
  const int b = row / R;
  const int r = row - b * R;
  const int32_t j = __ldg(inv + r);
  if (j < -1 || j >= M) __trap();
  Lanes<T, N> a = dst[g];
  if (j >= 0) {
    const Lanes<T, N> add = rows[(b * M + j) * V + v];
#pragma unroll
    for (int k = 0; k < N; ++k) a.v[k] = a.v[k] + add.v[k];
  }
  out[g] = a;
}

template <typename W>
void pack_words(const void* src, const int32_t* idx, void* out, int64_t R,
                int64_t M, int64_t V, int64_t total, cudaStream_t s) {
  pack_kernel<W><<<flat_blocks(total), kThreads, 0, s>>>(
      static_cast<const W*>(src), idx, static_cast<W*>(out),
      static_cast<int>(R), static_cast<int>(M), static_cast<int>(V),
      static_cast<int>(total));
}

int launch_pack(int elem, const void* src, const void* idx, void* out,
                int64_t n_dom, int64_t R, int64_t M, int64_t F,
                void* stream) {
  if (n_dom < 1 || R < 1 || M < 1 || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t row_bytes = F * elem;
  const int w = word_bytes(row_bytes, elem, {src, out});
  const int64_t V = row_bytes / w;
  if (!fits_32(n_dom * (R > M ? R : M) * V))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = n_dom * M * V;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  if (w == 16)
    pack_words<uint4>(src, ix, out, R, M, V, total, s);
  else if (w == 8)
    pack_words<uint2>(src, ix, out, R, M, V, total, s);
  else
    pack_words<uint32_t>(src, ix, out, R, M, V, total, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, typename D, int N>
void pack_convert_words(const void* src, const int32_t* idx, void* out,
                        int64_t R, int64_t M, int64_t V, int64_t total,
                        cudaStream_t s) {
  pack_convert_kernel<S, D, N><<<flat_blocks(total), kThreads, 0, s>>>(
      static_cast<const Lanes<S, N>*>(src), idx,
      static_cast<Lanes<D, N>*>(out), static_cast<int>(R),
      static_cast<int>(M), static_cast<int>(V), static_cast<int>(total));
}

template <typename S, typename D>
int launch_pack_convert(const void* src, const void* idx, void* out,
                        int64_t n_dom, int64_t R, int64_t M, int64_t F,
                        void* stream) {
  if (n_dom < 1 || R < 1 || M < 1 || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = convert_lanes<S, D>(F, src, out);
  const int64_t V = F / n;
  if (!fits_32(n_dom * (R > M ? R : M) * V))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = n_dom * M * V;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  constexpr int N16 = 16 / sizeof(D);  // elements of a 16-byte wire word
  if (n == N16)
    pack_convert_words<S, D, N16>(src, ix, out, R, M, V, total, s);
  else if (n == N16 / 2)
    pack_convert_words<S, D, N16 / 2>(src, ix, out, R, M, V, total, s);
  else
    pack_convert_words<S, D, 1>(src, ix, out, R, M, V, total, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N>
void unpack_add_words(const void* dst, const int32_t* inv, const void* rows,
                      void* out, int64_t R, int64_t M, int64_t V,
                      int64_t total, cudaStream_t s) {
  using L = Lanes<T, N>;
  unpack_add_kernel<T, N><<<flat_blocks(total), kThreads, 0, s>>>(
      static_cast<const L*>(dst), inv, static_cast<const L*>(rows),
      static_cast<L*>(out), static_cast<int>(R), static_cast<int>(M),
      static_cast<int>(V), static_cast<int>(total));
}

template <typename T>
int launch_unpack_add(const void* dst, const void* inv, const void* rows,
                      void* out, int64_t n_dom, int64_t R, int64_t M,
                      int64_t F, void* stream) {
  if (n_dom < 1 || R < 1 || M < 1 || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int E = sizeof(T);
  const int64_t row_bytes = F * E;
  const int w = word_bytes(row_bytes, E, {dst, rows, out});
  const int64_t V = row_bytes / w;
  if (!fits_32(n_dom * (R > M ? R : M) * V))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = n_dom * R * V;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* iv = static_cast<const int32_t*>(inv);
  if (w == 16)
    unpack_add_words<T, 16 / E>(dst, iv, rows, out, R, M, V, total, s);
  else if (w == 8 && E == 4)
    unpack_add_words<T, 2>(dst, iv, rows, out, R, M, V, total, s);
  else
    unpack_add_words<T, 1>(dst, iv, rows, out, R, M, V, total, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pack by element width in bytes; unpack-add by element type
#define REPRO_PACK_ENTRY(BYTES)                                             \
  extern "C" int halo_pack_b##BYTES(const void* src, const void* idx,       \
                                    void* out, int64_t n_dom, int64_t R,    \
                                    int64_t M, int64_t F, void* stream) {   \
    return launch_pack(BYTES, src, idx, out, n_dom, R, M, F, stream);       \
  }

#define REPRO_UNPACK_ADD_ENTRY(SUFFIX, T)                                   \
  extern "C" int halo_unpack_add_##SUFFIX(                                  \
      const void* dst, const void* inv, const void* rows, void* out,        \
      int64_t n_dom, int64_t R, int64_t M, int64_t F, void* stream) {       \
    return launch_unpack_add<T>(dst, inv, rows, out, n_dom, R, M, F,        \
                                stream);                                    \
  }

// the converting pack by (source, wire) element type
#define REPRO_PACK_CONVERT_ENTRY(NAME, S, D)                                \
  extern "C" int halo_pack_##NAME(const void* src, const void* idx,         \
                                  void* out, int64_t n_dom, int64_t R,      \
                                  int64_t M, int64_t F, void* stream) {     \
    return launch_pack_convert<S, D>(src, idx, out, n_dom, R, M, F,         \
                                     stream);                               \
  }

REPRO_PACK_ENTRY(4)
REPRO_PACK_ENTRY(8)
REPRO_PACK_CONVERT_ENTRY(f64_to_f32, double, float)
REPRO_PACK_CONVERT_ENTRY(f64_to_bf16, double, __nv_bfloat16)
REPRO_PACK_CONVERT_ENTRY(f64_to_f16, double, __half)
REPRO_PACK_CONVERT_ENTRY(f32_to_bf16, float, __nv_bfloat16)
REPRO_PACK_CONVERT_ENTRY(f32_to_f16, float, __half)
REPRO_UNPACK_ADD_ENTRY(f32, float)
REPRO_UNPACK_ADD_ENTRY(f64, double)
REPRO_UNPACK_ADD_ENTRY(i32, int32_t)
