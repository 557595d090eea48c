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
// Both are pure data movement: every element is read once and written once
// (unpack-add also reads the destination row it adds into).  On an H100 the
// bound is device-memory bytes at 3.35 TB/s; at the halo sizes of the MD
// main path (a few hundred rows of a few hundred bytes per pulse) one
// launch moves well under a megabyte, so what bounds it in practice is the
// launch latency, not the bytes.  The design keeps each launch to one pass:
//   * one block per (output row, domain), so one launch serves all domains
//     of the virtual mesh with a shared index map (the grid's y dimension);
//   * threads stride over the row; rows whose byte width is a multiple of
//     16 and whose bases are 16-byte aligned move as 16-byte words;
//   * unpack-add indices are unique by construction (the halo plan's maps
//     are collision-free), so each element gets exactly one add with no
//     atomics: the result is deterministic and bitwise equal to the plain
//     indexed add.
// Kernels run on the caller's stream, allocate nothing and do not
// synchronise.  Each C entry point returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "wire_conv.cuh"

#include <cstdint>

namespace {

struct alignas(16) Word16 {
  uint32_t w[4];
};

template <typename T>
struct alignas(16) Lanes {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int threads_for(int64_t width) {
  // one warp per 32 elements of the row, between one warp and 256 threads
  int64_t t = ((width + 31) / 32) * 32;
  if (t < 32) t = 32;
  if (t > 256) t = 256;
  return static_cast<int>(t);
}

// ---- pack: out[b, m, :] = idx[m] >= 0 ? src[b, idx[m], :] : 0 ------------
//
// Pack is a copy of bits, so it is templated on the element width only
// (uint32_t serves f32 and int32, uint64_t serves f64, Word16 any type whose
// row allows 16-byte words); all-zero bits are +0 for every element type.
// A negative index is padding and writes a zero row.  An index >= R is a
// fault of the caller's map (the halo plan checks its maps when it builds
// them): the kernel traps rather than read outside the block, as the plain
// form raises.

template <typename W>
__global__ void pack_kernel(const W* __restrict__ src,
                            const int32_t* __restrict__ idx,
                            W* __restrict__ out, int64_t R, int64_t M,
                            int64_t F) {
  const int64_t m = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int32_t i = idx[m];
  W* dst = out + (b * M + m) * F;
  if (i >= R) __trap();
  if (i < 0) {
    const W zero{};
    for (int64_t f = threadIdx.x; f < F; f += blockDim.x) dst[f] = zero;
    return;
  }
  const W* row = src + (b * R + i) * F;
  for (int64_t f = threadIdx.x; f < F; f += blockDim.x) dst[f] = row[f];
}

// ---- converting pack: out[b, m, :] = wire(src[b, idx[m], :]) --------------
//
// The wire form (compressed halo payloads): the gathered row is rounded to
// the wire dtype in registers and only the narrow row is stored, so the
// source rows are read once and the wire rows written once.  Each cast
// rounds as XLA's convert does (WireConv, wire_conv.cuh).  A padding row
// is the wire dtype's +0.

template <typename S, typename D>
__global__ void pack_convert_kernel(const S* __restrict__ src,
                                    const int32_t* __restrict__ idx,
                                    D* __restrict__ out, int64_t R,
                                    int64_t M, int64_t F) {
  const int64_t m = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int32_t i = idx[m];
  D* dst = out + (b * M + m) * F;
  if (i >= R) __trap();
  if (i < 0) {
    const D zero = WireConv<S, D>::apply(S(0));
    for (int64_t f = threadIdx.x; f < F; f += blockDim.x) dst[f] = zero;
    return;
  }
  const S* row = src + (b * R + i) * F;
  for (int64_t f = threadIdx.x; f < F; f += blockDim.x)
    dst[f] = WireConv<S, D>::apply(row[f]);
}

// ---- unpack-add: out[b, idx[m], :] += rows[b, m, :] (out holds dst) -------

template <typename T>
__global__ void unpack_add_kernel(T* __restrict__ out,
                                  const int32_t* __restrict__ idx,
                                  const T* __restrict__ rows, int64_t R,
                                  int64_t M, int64_t F) {
  const int64_t m = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int32_t i = idx[m];
  if (i < 0 || i >= R) __trap();  // the maps hold unique rows in [0, R)
  T* dst = out + (b * R + i) * F;
  const T* add = rows + (b * M + m) * F;
  for (int64_t f = threadIdx.x; f < F; f += blockDim.x)
    dst[f] = dst[f] + add[f];
}

template <typename T>
__global__ void unpack_add_kernel_w16(Lanes<T>* __restrict__ out,
                                      const int32_t* __restrict__ idx,
                                      const Lanes<T>* __restrict__ rows,
                                      int64_t R, int64_t M, int64_t W) {
  const int64_t m = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int32_t i = idx[m];
  if (i < 0 || i >= R) __trap();
  Lanes<T>* dst = out + (b * R + i) * W;
  const Lanes<T>* add = rows + (b * M + m) * W;
  for (int64_t w = threadIdx.x; w < W; w += blockDim.x) {
    Lanes<T> a = dst[w];
    const Lanes<T> r = add[w];
#pragma unroll
    for (int k = 0; k < Lanes<T>::kN; ++k) a.v[k] = a.v[k] + r.v[k];
    dst[w] = a;
  }
}

bool grid_ok(int64_t n_dom, int64_t M) {
  return n_dom >= 1 && n_dom <= 65535 && M >= 1 && M <= 2147483647;
}

template <typename W>
int launch_pack(const void* src, const void* idx, void* out, int64_t n_dom,
                int64_t R, int64_t M, int64_t F, void* stream) {
  if (!grid_ok(n_dom, M) || F < 1 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(M), static_cast<unsigned>(n_dom));
  const int64_t row_bytes = F * static_cast<int64_t>(sizeof(W));
  const int32_t* ix = static_cast<const int32_t*>(idx);
  if (row_bytes % 16 == 0 && aligned16(src) && aligned16(out)) {
    const int64_t V = row_bytes / 16;
    pack_kernel<Word16><<<grid, threads_for(V), 0, s>>>(
        static_cast<const Word16*>(src), ix, static_cast<Word16*>(out), R, M,
        V);
  } else {
    pack_kernel<W><<<grid, threads_for(F), 0, s>>>(
        static_cast<const W*>(src), ix, static_cast<W*>(out), R, M, F);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename S, typename D>
int launch_pack_convert(const void* src, const void* idx, void* out,
                        int64_t n_dom, int64_t R, int64_t M, int64_t F,
                        void* stream) {
  if (!grid_ok(n_dom, M) || F < 1 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(M), static_cast<unsigned>(n_dom));
  pack_convert_kernel<S, D><<<grid, threads_for(F), 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(src), static_cast<const int32_t*>(idx),
      static_cast<D*>(out), R, M, F);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_unpack_add(const void* dst, const void* idx, const void* rows,
                      void* out, int64_t n_dom, int64_t R, int64_t M,
                      int64_t F, void* stream) {
  if (!grid_ok(n_dom, M) || F < 1 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t row_bytes = F * static_cast<int64_t>(sizeof(T));
  if (out != dst) {
    cudaError_t e = cudaMemcpyAsync(out, dst, n_dom * R * row_bytes,
                                    cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(M), static_cast<unsigned>(n_dom));
  if (row_bytes % 16 == 0 && aligned16(out) && aligned16(rows)) {
    const int64_t W = row_bytes / 16;
    unpack_add_kernel_w16<T><<<grid, threads_for(W), 0, s>>>(
        static_cast<Lanes<T>*>(out), static_cast<const int32_t*>(idx),
        static_cast<const Lanes<T>*>(rows), R, M, W);
  } else {
    unpack_add_kernel<T><<<grid, threads_for(F), 0, s>>>(
        static_cast<T*>(out), static_cast<const int32_t*>(idx),
        static_cast<const T*>(rows), R, M, F);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pack by element width in bytes; unpack-add by element type
#define REPRO_PACK_ENTRY(BYTES, W)                                          \
  extern "C" int halo_pack_b##BYTES(const void* src, const void* idx,       \
                                    void* out, int64_t n_dom, int64_t R,    \
                                    int64_t M, int64_t F, void* stream) {   \
    return launch_pack<W>(src, idx, out, n_dom, R, M, F, stream);           \
  }

#define REPRO_UNPACK_ADD_ENTRY(SUFFIX, T)                                   \
  extern "C" int halo_unpack_add_##SUFFIX(                                  \
      const void* dst, const void* idx, const void* rows, void* out,        \
      int64_t n_dom, int64_t R, int64_t M, int64_t F, void* stream) {       \
    return launch_unpack_add<T>(dst, idx, rows, out, n_dom, R, M, F,        \
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

REPRO_PACK_ENTRY(4, uint32_t)
REPRO_PACK_ENTRY(8, uint64_t)
REPRO_PACK_CONVERT_ENTRY(f64_to_f32, double, float)
REPRO_PACK_CONVERT_ENTRY(f64_to_bf16, double, __nv_bfloat16)
REPRO_PACK_CONVERT_ENTRY(f64_to_f16, double, __half)
REPRO_PACK_CONVERT_ENTRY(f32_to_bf16, float, __nv_bfloat16)
REPRO_PACK_CONVERT_ENTRY(f32_to_f16, float, __half)
REPRO_UNPACK_ADD_ENTRY(f32, float)
REPRO_UNPACK_ADD_ENTRY(f64, double)
REPRO_UNPACK_ADD_ENTRY(i32, int32_t)
