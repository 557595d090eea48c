// Cell-pair LJ + reaction-field forces and their scatter-accumulate
// epilogue for Hopper (sm_90a), f32 and f64.
//
// Replaces the TPU kernels of the JAX package:
//   nb_pair_forces_*    <- src/repro/kernels/nonbonded.py:pair_forces
//                          (_pair_kernel)
//   nb_scatter_accum_*  <- src/repro/kernels/nonbonded.py:scatter_accum
//                          (_scatter_accum_kernel)
//
// pair_forces.  One thread block per cell pair; thread i owns slot i of
// cell A (threads stride over the slots when K exceeds the block) and walks
// the K slots of cell B, which the block first stages in shared memory with
// their types.  A valid slot pair costs ~9 float operations (r2 and the
// cutoff test), an interacting one ~43 more; the inputs are gathered per
// pair (~16 bytes a slot a side in f32, plus 12 out).  At the grappa-45k
// tiers (K = 8..28) that is ~53 MB against ~0.14 G operations a step, so
// the bound is device-memory bytes, ~16 us a step on an H100; a block of
// one or two warps with a serial j loop is latency-bound well above it.
// What the design does:
//   * the four masks of the reference are kept exactly: a slot is valid
//     when slot < count (counts given) or type >= 0 (no counts); a self
//     pair keeps only j > i; types are clipped into the T x T tables; a
//     masked lane never divides (it branches around the pair terms);
//   * fb is a column sum of the K x K tile.  Thread i writes its row of
//     fac * dx into shared memory (zeros where masked), and after a barrier
//     thread j sums column j over i in a fixed order: no atomics, the same
//     bits on every run.  The tile holds a chunk of J columns at a time,
//     J as wide as 48 KB allows: all K columns at the main path's depths
//     (K <= 40 in f32), fewer for the deep cells of small f64 systems;
//     fa sums over j in order across the chunks in shared memory;
//   * the pair's energy is summed per thread over j, then over threads in
//     order by thread 0;
//   * r2 is formed with the round-to-nearest intrinsics (no fused
//     multiply-add) as three products and two adds in order, so the cutoff
//     test sees the same bits as the plain PyTorch form.  The rest of the
//     arithmetic may contract into fused multiply-adds (the build has no
//     --use_fast_math: divisions and square roots stay IEEE).
//
// scatter_accum.  The reference adds fa[row] into cell_a[row], then
// fb[row] into cell_b[row], row by row; cell ids repeat.  The caller
// builds an ordered index (a stable sort of the 2N cell ids of entries
// 2*row + side, and each cell's segment start).  One thread per (cell,
// slot, component) walks its cell's segment in order and writes the sum
// once: no atomics, deterministic, and bitwise equal to adding each cell's
// j-th entries in a loop over j.  It moves each input once and writes each
// output once, so it is bound by device-memory bytes (3.35 TB/s).
//
// Kernels run on the caller's stream, allocate nothing and do not
// synchronise.  Each C entry point returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSmemLimit = 232448;   // shared memory one block can use

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

int pair_threads(int64_t K) {
  int64_t t = ((K + 31) / 32) * 32;
  if (t < 32) t = 32;
  if (t > 256) t = 256;
  return static_cast<int>(t);
}

// Shared memory of one block: the (K, J, 3) tile of a chunk of J columns,
// cell B's (K, 4) slots, the (K, 3) fa sums, one energy part per thread and
// B's K types.  J is the widest chunk that keeps the block within 48 KB
// (all K columns at the main path's depths; fewer for deep f64 cells).
template <typename T>
int64_t pair_fixed_smem(int64_t K, int threads) {
  return (7 * K + threads) * static_cast<int64_t>(sizeof(T)) + 4 * K;
}

template <typename T>
int64_t pair_chunk(int64_t K, int threads) {
  const int64_t room = 48 * 1024 - pair_fixed_smem<T>(K, threads);
  int64_t J = room / (3 * K * static_cast<int64_t>(sizeof(T)));
  if (J > K) J = K;
  if (J < 1) J = 1;
  return J;
}

template <typename T>
__global__ void pair_forces_kernel(
    const T* __restrict__ a, const T* __restrict__ b,
    const int32_t* __restrict__ ta, const int32_t* __restrict__ tb,
    const int32_t* __restrict__ same, const int32_t* __restrict__ cnt_a,
    const int32_t* __restrict__ cnt_b, const T* __restrict__ eps_t,
    const T* __restrict__ sig_t, int n_types, T r_cut2, T k_rf, T c_rf,
    int K, int J, T* __restrict__ fa, T* __restrict__ fb,
    T* __restrict__ pe) {
  extern __shared__ unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);   // (K, J, 3): fac * dx
  T* sb = tile + 3 * K * J;                   // (K, 4): cell B's slots
  T* sfa = sb + 4 * K;                        // (K, 3): fa, summed over j
  T* spe = sfa + 3 * K;                       // (blockDim,): energy parts
  int32_t* stb = reinterpret_cast<int32_t*>(spe + blockDim.x);  // (K,)

  const int64_t n = blockIdx.x;
  const T* an = a + n * K * 4;
  const T zero = T(0);
  for (int s = threadIdx.x; s < 4 * K; s += blockDim.x) sb[s] = b[n * K * 4 + s];
  for (int s = threadIdx.x; s < 3 * K; s += blockDim.x) sfa[s] = zero;
  for (int s = threadIdx.x; s < K; s += blockDim.x) stb[s] = tb[n * K + s];
  __syncthreads();

  const bool self_pair = same[n] > 0;
  const int na = cnt_a ? cnt_a[n] : K;
  const int nb = cnt_b ? cnt_b[n] : K;
  T pe_acc = zero;
  for (int c0 = 0; c0 < K; c0 += J) {
    const int c1 = min(c0 + J, K);
    for (int i = threadIdx.x; i < K; i += blockDim.x) {
      const int32_t type_i = ta[n * K + i];
      const bool valid_i = cnt_a ? (i < na) : (type_i >= 0);
      const T xi = an[i * 4 + 0], yi = an[i * 4 + 1], zi = an[i * 4 + 2];
      const T qi = an[i * 4 + 3];
      const int ti = min(max(type_i, 0), n_types - 1);
      T fx = sfa[3 * i + 0], fy = sfa[3 * i + 1], fz = sfa[3 * i + 2];
      T* row = tile + 3 * J * i;
      for (int j = c0; j < c1; ++j) {
        const int32_t type_j = stb[j];
        const bool valid_j = cnt_b ? (j < nb) : (type_j >= 0);
        const T dx = xi - sb[j * 4 + 0];
        const T dy = yi - sb[j * 4 + 1];
        const T dz = zi - sb[j * 4 + 2];
        const T r2 = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)),
                            mul_rn(dz, dz));
        T gx = zero, gy = zero, gz = zero;
        if (valid_i && valid_j && r2 < r_cut2 && (!self_pair || j > i)) {
          const int tj = min(max(type_j, 0), n_types - 1);
          const T eps = eps_t[ti * n_types + tj];
          const T sig = sig_t[ti * n_types + tj];
          const T inv_r2 = T(1) / r2;
          const T sr2 = (sig * sig) * inv_r2;
          const T sr6 = sr2 * sr2 * sr2;
          const T sr12 = sr6 * sr6;
          const T fac_lj = T(24) * eps * (T(2) * sr12 - sr6) * inv_r2;
          const T src2 = (sig * sig) / r_cut2;
          const T src6 = src2 * src2 * src2;
          const T e_lj = T(4) * eps * ((sr12 - sr6) - (src6 * src6 - src6));
          const T inv_r = sqrt(inv_r2);
          const T qq = qi * sb[j * 4 + 3];
          const T fac_c = qq * (inv_r * inv_r2 - T(2) * k_rf);
          const T e_c = qq * (inv_r + k_rf * r2 - c_rf);
          const T fac = fac_lj + fac_c;
          gx = fac * dx;
          gy = fac * dy;
          gz = fac * dz;
          fx += gx;
          fy += gy;
          fz += gz;
          pe_acc += e_lj + e_c;
        }
        T* t = row + 3 * (j - c0);
        t[0] = gx;
        t[1] = gy;
        t[2] = gz;
      }
      sfa[3 * i + 0] = fx;
      sfa[3 * i + 1] = fy;
      sfa[3 * i + 2] = fz;
    }
    __syncthreads();
    // Newton's third law: fb[j] = -sum_i tile[i][j], summed over i in order
    for (int j = c0 + threadIdx.x; j < c1; j += blockDim.x) {
      T sx = zero, sy = zero, sz = zero;
      for (int i = 0; i < K; ++i) {
        const T* t = tile + 3 * (J * i + (j - c0));
        sx += t[0];
        sy += t[1];
        sz += t[2];
      }
      T* out = fb + (n * K + j) * 3;
      out[0] = -sx;
      out[1] = -sy;
      out[2] = -sz;
    }
    __syncthreads();   // the next chunk overwrites the tile
  }
  for (int s = threadIdx.x; s < 3 * K; s += blockDim.x)
    fa[n * K * 3 + s] = sfa[s];
  spe[threadIdx.x] = pe_acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T p = zero;
    for (int t = 0; t < static_cast<int>(blockDim.x); ++t) p += spe[t];
    pe[n] = p;
  }
}

template <typename T>
int launch_pair_forces(const void* a, const void* b, const void* ta,
                       const void* tb, const void* same, const void* cnt_a,
                       const void* cnt_b, const void* eps_t,
                       const void* sig_t, int n_types, double r_cut2,
                       double k_rf, double c_rf, int64_t N, int64_t K,
                       void* fa, void* fb, void* pe, void* stream) {
  if (N < 1 || N > 2147483647 || K < 1 || n_types < 1 ||
      (cnt_a == nullptr) != (cnt_b == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = pair_threads(K);
  const int64_t J = pair_chunk<T>(K, threads);
  const int64_t smem = 3 * K * J * static_cast<int64_t>(sizeof(T)) +
                       pair_fixed_smem<T>(K, threads);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {      // only a cell too deep for one column
    cudaError_t e = cudaFuncSetAttribute(
        pair_forces_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pair_forces_kernel<T><<<static_cast<unsigned>(N), threads,
                          static_cast<size_t>(smem),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const int32_t*>(ta), static_cast<const int32_t*>(tb),
      static_cast<const int32_t*>(same), static_cast<const int32_t*>(cnt_a),
      static_cast<const int32_t*>(cnt_b), static_cast<const T*>(eps_t),
      static_cast<const T*>(sig_t), n_types, static_cast<T>(r_cut2),
      static_cast<T>(k_rf), static_cast<T>(c_rf), static_cast<int>(K),
      static_cast<int>(J), static_cast<T*>(fa), static_cast<T*>(fb),
      static_cast<T*>(pe));
  return static_cast<int>(cudaGetLastError());
}

// ---- scatter_accum: out[c] = sum of c's entries, in worklist order ----------

template <typename T>
__global__ void scatter_accum_kernel(const int32_t* __restrict__ order,
                                     const int32_t* __restrict__ start,
                                     const T* __restrict__ fa,
                                     const T* __restrict__ fb,
                                     int64_t n_cells, int64_t row_len,
                                     int64_t n_entries, T* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  // an index whose segments do not cover all 2N entries came from a cell
  // id outside [0, n_cells): a fault of the caller (the plain form raises)
  if (t == 0 && (start[0] != 0 || start[n_cells] != n_entries)) __trap();
  if (t >= n_cells * row_len) return;
  const int64_t cell = t / row_len;
  const int64_t r = t - cell * row_len;     // slot * 3 + component
  T acc = T(0);
  const int32_t end = start[cell + 1];
  for (int32_t p = start[cell]; p < end; ++p) {
    const int32_t e = order[p];
    const T* src = (e & 1) ? fb : fa;
    acc = acc + src[static_cast<int64_t>(e >> 1) * row_len + r];
  }
  out[t] = acc;
}

template <typename T>
int launch_scatter_accum(const void* order, const void* start,
                         const void* fa, const void* fb, int64_t n_cells,
                         int64_t K, int64_t n_entries, void* out,
                         void* stream) {
  if (n_cells < 1 || K < 1 || n_entries < 2 || n_entries > 2147483647)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = n_cells * K * 3;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 2147483647) return static_cast<int>(cudaErrorInvalidValue);
  scatter_accum_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(start),
      static_cast<const T*>(fa), static_cast<const T*>(fb), n_cells, K * 3,
      n_entries, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define REPRO_NB_ENTRY(SUFFIX, T)                                           \
  extern "C" int nb_pair_forces_##SUFFIX(                                   \
      const void* a, const void* b, const void* ta, const void* tb,         \
      const void* same, const void* cnt_a, const void* cnt_b,               \
      const void* eps_t, const void* sig_t, int n_types, double r_cut2,     \
      double k_rf, double c_rf, int64_t N, int64_t K, void* fa, void* fb,   \
      void* pe, void* stream) {                                             \
    return launch_pair_forces<T>(a, b, ta, tb, same, cnt_a, cnt_b, eps_t,   \
                                 sig_t, n_types, r_cut2, k_rf, c_rf, N, K,  \
                                 fa, fb, pe, stream);                       \
  }                                                                         \
  extern "C" int nb_scatter_accum_##SUFFIX(                                 \
      const void* order, const void* start, const void* fa, const void* fb, \
      int64_t n_cells, int64_t K, int64_t n_entries, void* out,             \
      void* stream) {                                                       \
    return launch_scatter_accum<T>(order, start, fa, fb, n_cells, K,        \
                                   n_entries, out, stream);                 \
  }

REPRO_NB_ENTRY(f32, float)
REPRO_NB_ENTRY(f64, double)
