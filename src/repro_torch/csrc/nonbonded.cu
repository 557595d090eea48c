// Cell-pair LJ + reaction-field forces and their scatter-accumulate
// epilogue for Hopper (sm_90a), f32 and f64.
//
// Replaces the TPU kernels of the JAX package:
//   nb_pair_forces_*    <- src/repro/kernels/nonbonded.py:pair_forces
//                          (_pair_kernel)
//   nb_scatter_accum_*  <- src/repro/kernels/nonbonded.py:scatter_accum
//                          (_scatter_accum_kernel)
//
// pair_forces.  What bounds it: counted once, a grappa-45k step's six tier
// launches move ~53 MB (a byte bound of ~16 us on an H100) and do ~0.14 G
// float operations (~2 us at 67 TFLOP/s), so the bound is bytes.  The
// instruction stream is what a kernel meets first: an interacting slot
// pair costs an IEEE division, a square root and ~30 more operations, and
// every valid one forms r2 and tests the cutoff.  So the design keeps every
// lane on a slot pair, keeps no lane waiting on a barrier or a shared tile,
// and does the work that depends only on the type pair once a block:
//   * full warps.  A block of 4 warps serves 4 to 16 cell pairs: a group
//     of W lanes per pair, W = 32 at K > 16, 16 at 8 < K <= 16 and 8 at
//     K <= 8.  Lane j of a group owns slot j of cell B (lanes loop over
//     column chunks of W slots when K > W); the group walks cell A's slots
//     in order, to the largest count in the warp (all K without counts);
//   * no shared tile and no barrier for the sums.  fb[j] is the lane's own
//     register sum over i, in order.  fa[i] is a sum over the group's lanes
//     in a fixed tree: four A slots at a time, reduce-scattered (the two
//     halving steps at offsets W/2 and W/4 send half the values each, then
//     a butterfly), so a batch of four slots costs 15 shuffles at W = 32,
//     not 4 x 15; a batch in which no lane of the warp interacts skips
//     it (its sums are +0 either way).  Chunks add into fa in order.  The
//     energy is a butterfly over the group.  Every order is fixed: the same
//     inputs give the same bits on every run;
//   * the type-pair terms (sig^2, 24 eps, 4 eps and the cutoff shift
//     src6^2 - src6) are made by each block into shared memory, with the
//     round-to-nearest intrinsics in the order of forces.pair_terms, so the
//     per-pair values are those the kernel formed per pair before;
//   * loads.  Cell B's slots are one coalesced 16-byte load a lane (two in
//     f64); a batch issues its four A slots' loads (16 bytes each, the
//     group's lanes read one address) before any arithmetic, so they are in
//     flight together.  fa, fb and pe are written once, zeros for masked
//     slots (fa adds across column chunks only when K > W);
//   * the four masks of the reference are kept exactly: a slot is valid
//     when slot < count (counts given) or type >= 0 (no counts); a self
//     pair keeps only j > i; types are clipped into the T x T tables; a
//     masked lane never divides (it branches around the pair terms);
//   * r2 is formed with the round-to-nearest intrinsics (no fused
//     multiply-add) as three products and two adds in order, so the cutoff
//     test sees the same bits as the plain PyTorch form.  The rest of the
//     arithmetic may contract into fused multiply-adds (the build has no
//     --use_fast_math: divisions and square roots stay IEEE);
//   * non-finite inputs poison what the reference's do.  The reference
//     forms every slot pair's force as fac * d with fac = 0 on a masked
//     pair, so a NaN or Inf coordinate of either cell, or a difference
//     a - b that overflows, gives NaN wherever 0 * d reaches: fa[i][c] for
//     every i when cell B holds a non-finite component c, fb[j][c] for
//     every j when cell A does, and the slot's own rows.  The masked pairs
//     stay off the divergent loop.  A lane flags a slot ("odd") when a
//     coordinate is NaN, Inf or at least half the largest finite value:
//     two slots that are not odd take part in no non-finite difference.
//     After the loop the lanes flag both cells' K slots; one vote.  Only
//     a warp that saw an odd slot forms, one component at a time, each
//     cell's range over its finite values and a non-finite flag by
//     shuffles over the group (fl(a - b) is monotone in b, so the range's
//     ends decide which differences overflow) and writes NaN into the fa
//     and fb entries they reach.
//     Finite inputs of sane size take none of this, and the loop carries
//     nothing of it (a flag inside the loop cost the f64 kernel 10
//     registers a lane): their bits are unchanged.  The f32 kernel keeps
//     its time; the f64 one pays ~10 % (kPairMinBlocks).  The energy
//     keeps the reference's where(mask, e, 0).
// Why not the tile: a block per pair with lanes over A and a shared K x K
// tile for fb runs one warp a block (half an SM's warps at most), pays a
// barrier and a second serial pass per pair, and its row stride of 3K words
// hits 4- to 16-way bank conflicts at the grappa-45k depths.
//
// scatter_accum.  The reference adds fa[row] into cell_a[row], then
// fb[row] into cell_b[row], row by row; cell ids repeat.  The caller
// builds an ordered index (a stable sort of the 2N cell ids of entries
// 2*row + side, and each cell's segment start).  It moves each input once
// and writes each output once, so it is bound by device-memory bytes
// (3.35 TB/s); the latency of its dependent loads is what a kernel meets
// first.  One warp per cell and 32 words of its row (every grappa-45k row
// in f32, two warps a row in f64 at K > 21): the lanes run over the row in
// 16-byte words (float4 / double2 when the row is whole words and the
// arrays are 16-byte aligned; else one element a lane, the same code on a
// scalar word).  The warp reads up to 32 of its segment's entry ids in one
// coalesced load and hands them out by shuffle, issues the loads of four
// entries' rows before it adds them in order (eight or two measured
// slower: eight costs the registers of a one-wave grid), and stores its
// row once
// (an untouched cell its zeros).  Each sum starts from +0.0 and adds the
// entries in segment order, so the result is bitwise the plain form's.
//
// Kernels run on the caller's stream, allocate nothing and do not
// synchronise.  Each C entry point returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kSmemLimit = 232448;   // shared memory one block can use
constexpr unsigned kFull = 0xffffffffu;

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
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// ---- pair_forces ------------------------------------------------------------

constexpr int kPairWarps = 4;   // warps a block
constexpr int kBatch = 4;       // A slots whose fa sums are reduced together

// The LJ terms of one type pair (pair_terms' operations, in its order).
template <typename T>
struct alignas(4 * sizeof(T)) TypePair {
  T sig2;    // sig * sig
  T eps24;   // 24 * eps
  T eps4;    // 4 * eps
  T shift;   // src6 * src6 - src6, src6 = ((sig * sig) / r_cut2)^3
};

// One slot [x, y, z, q]: a 16-byte load in f32, two in f64.
__device__ __forceinline__ void load_slot(const float* p, float (&s)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  s[0] = v.x;
  s[1] = v.y;
  s[2] = v.z;
  s[3] = v.w;
}
__device__ __forceinline__ void load_slot(const double* p, double (&s)[4]) {
  const double2 u = __ldg(reinterpret_cast<const double2*>(p));
  const double2 v = __ldg(reinterpret_cast<const double2*>(p) + 1);
  s[0] = u.x;
  s[1] = u.y;
  s[2] = v.x;
  s[3] = v.y;
}

// The range of component c over the finite values of a cell's K slots
// (p), and whether one of them is non-finite, over the W lanes of a group,
// in every lane of the group.  One component at a time keeps the rare
// path's live registers few: it must not raise the kernel's count.
template <typename T, int W>
__device__ __forceinline__ void group_range(const T* p, int K, int lg,
                                            bool live, int c, T& lo, T& hi,
                                            int& bad) {
  lo = T(INFINITY);
  hi = -T(INFINITY);
  bad = 0;
  if (live) {
    for (int i = lg; i < K; i += W) {
      const T x = p[4 * i + c];
      if (isfinite(x)) {
        lo = x < lo ? x : lo;
        hi = x > hi ? x : hi;
      } else {
        bad = 1;
      }
    }
  }
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
    const T l = __shfl_xor_sync(kFull, lo, off);
    const T h = __shfl_xor_sync(kFull, hi, off);
    lo = l < lo ? l : lo;
    hi = h > hi ? h : hi;
    bad |= __shfl_xor_sync(kFull, bad, off);
  }
}

// Half the largest finite value (2^127, 2^1023): |x - y| of two values
// below it is at most the largest finite value.
__device__ __forceinline__ float half_max(float) {
  return __int_as_float(0x7f000000);
}
__device__ __forceinline__ double half_max(double) {
  return __longlong_as_double(0x7fe0000000000000LL);
}

// A slot whose coordinates may take part in a non-finite difference: one
// of them NaN, Inf or at least half the largest finite value.
template <typename T>
__device__ __forceinline__ bool odd_slot(const T (&s)[4]) {
  const T h = half_max(s[0]);
  return !(fabs(s[0]) < h && fabs(s[1]) < h && fabs(s[2]) < h);
}

// Does 0 * (x - y) reach x's entry for some y of the other cell, whose
// values of this component span [lo, hi] (bad: one is non-finite): x or a
// y non-finite, or x - y overflowing at an end of the range (fl(x - y) is
// monotone in y).
template <typename T>
__device__ __forceinline__ bool poisoned(T x, T lo, T hi, int bad) {
  return bad || !isfinite(x) || !isfinite(x - lo) || !isfinite(x - hi);
}

__device__ __forceinline__ float quiet_nan(float) {
  return __int_as_float(0x7fc00000);
}
__device__ __forceinline__ double quiet_nan(double) {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// The non-finite pass of a group's cell pair, after its sums are stored:
// flag the odd slots of both cells; a warp that flagged one forms both
// cells' ranges, component by component, and writes NaN into the fa and
// fb entries they reach.  Called by every lane of the warp.  Not inlined:
// held to 96 registers (kPairMinBlocks), the f64 kernel spilled twice as
// much with the pass inlined and ran 2 % slower (H100, k = 28).
template <typename T, int W>
__device__ __noinline__ void nonfinite_pass(const T* an, const T* bn,
                                            T* fan, T* fbn, int K, int lg,
                                            bool live) {
  bool odd = false;
  if (live) {
    for (int i = lg; i < K; i += W) {
      T s[4];
      load_slot(an + 4 * i, s);
      odd |= odd_slot(s);
      load_slot(bn + 4 * i, s);
      odd |= odd_slot(s);
    }
  }
  if (!__any_sync(kFull, live && odd)) return;
  __syncwarp();   // the kernel's stores, by other lanes of the group
  const T nan = quiet_nan(T(0));
#pragma unroll 1
  for (int c = 0; c < 3; ++c) {
    T alo, ahi, blo, bhi;
    int abad, bbad;
    group_range<T, W>(an, K, lg, live, c, alo, ahi, abad);
    group_range<T, W>(bn, K, lg, live, c, blo, bhi, bbad);
    if (live) {
      for (int i = lg; i < K; i += W)
        if (poisoned(an[4 * i + c], blo, bhi, bbad)) fan[3 * i + c] = nan;
      for (int j = lg; j < K; j += W)
        if (poisoned(bn[4 * j + c], alo, ahi, abad)) fbn[3 * j + c] = nan;
    }
  }
}

// fa of a batch's kBatch = 4 slots, summed over the W lanes of a group:
// g holds (x, y, z) of slots 0..3.  Two halving steps leave each quarter
// of the group one slot's three partial sums, a butterfly finishes them;
// quarter q (lanes q*W/4 .. q*W/4 + W/4 - 1) ends holding slot q's sums,
// the same bits in each of its lanes.
template <typename T, int W>
__device__ __forceinline__ void reduce_batch(const T (&g)[3 * kBatch], int lg,
                                             T (&s)[3]) {
  const bool hi1 = lg & (W / 2);
  T h[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const T keep = hi1 ? g[k + 6] : g[k];
    const T send = hi1 ? g[k] : g[k + 6];
    h[k] = keep + __shfl_xor_sync(kFull, send, W / 2);
  }
  const bool hi2 = lg & (W / 4);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T keep = hi2 ? h[k + 3] : h[k];
    const T send = hi2 ? h[k] : h[k + 3];
    s[k] = keep + __shfl_xor_sync(kFull, send, W / 4);
  }
#pragma unroll
  for (int off = W / 8; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) s[k] += __shfl_xor_sync(kFull, s[k], off);
  }
}

// Blocks an SM must hold: f64 at five, the occupancy the kernel had before
// its non-finite pass (96 registers a lane).  Unbounded, the pass takes it
// to 98 registers, which round up to 104: a fifth of the warps, 23 % of its
// time at k = 28 on an H100; bounded, it spills 8 bytes and pays 10 %.
template <typename T>
constexpr int kPairMinBlocks = sizeof(T) == 8 ? 5 : 1;

template <typename T, int W>
__global__ void __launch_bounds__(32 * kPairWarps, kPairMinBlocks<T>)
    pair_forces_kernel(
    const T* __restrict__ a, const T* __restrict__ b,
    const int32_t* __restrict__ ta, const int32_t* __restrict__ tb,
    const int32_t* __restrict__ same, const int32_t* __restrict__ cnt_a,
    const int32_t* __restrict__ cnt_b, const T* __restrict__ eps_t,
    const T* __restrict__ sig_t, int n_types, T r_cut2, T k_rf, T c_rf,
    int64_t N, int K, T* __restrict__ fa, T* __restrict__ fb,
    T* __restrict__ pe) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  TypePair<T>* tp = reinterpret_cast<TypePair<T>*>(smem_raw);
  for (int s = threadIdx.x; s < n_types * n_types; s += blockDim.x) {
    const T sig2 = mul_rn(sig_t[s], sig_t[s]);
    const T src2 = div_rn(sig2, r_cut2);
    const T src6 = mul_rn(mul_rn(src2, src2), src2);
    tp[s] = TypePair<T>{sig2, mul_rn(T(24), eps_t[s]),
                        mul_rn(T(4), eps_t[s]),
                        sub_rn(mul_rn(src6, src6), src6)};
  }
  __syncthreads();

  constexpr int Q = W / 4;   // lanes of a quarter group
  const int lane = threadIdx.x & 31;
  const int lg = lane % W;
  const int64_t n =
      (static_cast<int64_t>(blockIdx.x) * kPairWarps + threadIdx.x / 32) *
          (32 / W) + lane / W;
  const bool live = n < N;
  const int64_t nr = live ? n : N - 1;   // a dead group reads, never writes
  const int na = !live ? 0 : cnt_a ? min(max(cnt_a[n], 0), K) : K;
  const int nb = cnt_b ? min(max(cnt_b[nr], 0), K) : K;
  const bool self_pair = same[nr] > 0;
  const int i_end = __reduce_max_sync(kFull, na);   // the warp's A loop
  const T* an = a + nr * K * 4;
  const T* bn = b + nr * K * 4;
  const int32_t* tan = ta + nr * K;
  const int32_t* tbn = tb + nr * K;
  T* fan = fa + nr * K * 3;
  T* fbn = fb + nr * K * 3;
  const T zero = T(0);
  const T k_rf2 = T(2) * k_rf;
  T pe_acc = zero;
  bool first = true;   // no column chunk has written fa yet (warp-uniform)
  for (int c0 = 0; c0 < K; c0 += W) {
    const int j = c0 + lg;
    const bool in_j = live && j < K;
    T sj[4] = {zero, zero, zero, zero};
    int tj = 0;
    bool valid_j = false;
    if (in_j) {
      const int32_t type_j = tbn[j];
      valid_j = cnt_b ? (j < nb) : (type_j >= 0);
      tj = min(max(type_j, 0), n_types - 1);
      load_slot(bn + 4 * j, sj);
    }
    T bx = zero, by = zero, bz = zero;   // fb[j], summed over i in order
    if (__any_sync(kFull, valid_j)) {
      for (int i0 = 0; i0 < i_end; i0 += kBatch) {
        T si[kBatch][4];
        int32_t type_i[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = min(i0 + u, K - 1);
          type_i[u] = tan[i];
          load_slot(an + 4 * i, si[u]);
        }
        T g[3 * kBatch];
        bool hit = false;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u;
          const T dx = si[u][0] - sj[0];
          const T dy = si[u][1] - sj[1];
          const T dz = si[u][2] - sj[2];
          const T r2 = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)),
                              mul_rn(dz, dz));
          g[3 * u + 0] = zero;
          g[3 * u + 1] = zero;
          g[3 * u + 2] = zero;
          const bool valid_i = i < na && (cnt_a != nullptr || type_i[u] >= 0);
          if (valid_i && valid_j && r2 < r_cut2 && (!self_pair || j > i)) {
            const int ti = min(max(type_i[u], 0), n_types - 1);
            const TypePair<T> c = tp[ti * n_types + tj];
            const T inv_r2 = T(1) / r2;
            const T sr2 = c.sig2 * inv_r2;
            const T sr6 = sr2 * sr2 * sr2;
            const T sr12 = sr6 * sr6;
            const T fac_lj = c.eps24 * (T(2) * sr12 - sr6) * inv_r2;
            const T e_lj = c.eps4 * ((sr12 - sr6) - c.shift);
            const T inv_r = sqrt(inv_r2);
            const T qq = si[u][3] * sj[3];
            const T fac_c = qq * (inv_r * inv_r2 - k_rf2);
            const T e_c = qq * (inv_r + k_rf * r2 - c_rf);
            const T fac = fac_lj + fac_c;
            g[3 * u + 0] = fac * dx;
            g[3 * u + 1] = fac * dy;
            g[3 * u + 2] = fac * dz;
            bx = add_rn(bx, g[3 * u + 0]);   // fb sums exactly fa's terms
            by = add_rn(by, g[3 * u + 1]);
            bz = add_rn(bz, g[3 * u + 2]);
            pe_acc += e_lj + e_c;
            hit = true;
          }
        }
        T s[3] = {zero, zero, zero};
        if (__any_sync(kFull, hit)) reduce_batch<T, W>(g, lg, s);
        const int i = i0 + lg / Q;
        if (live && lg % Q == 0 && i < K) {
          T* f = fan + 3 * i;
          if (first) {
            f[0] = s[0];
            f[1] = s[1];
            f[2] = s[2];
          } else {   // a later column chunk (K > W): the same lane wrote f
            f[0] += s[0];
            f[1] += s[1];
            f[2] += s[2];
          }
        }
      }
      first = false;
    }
    if (in_j) {
      fbn[3 * j + 0] = -bx;
      fbn[3 * j + 1] = -by;
      fbn[3 * j + 2] = -bz;
    }
  }
  // fa rows no batch wrote: zeros
  const int i_cov =
      first ? 0 : min((i_end + kBatch - 1) / kBatch * kBatch, K);
  if (live) {
    for (int s = 3 * i_cov + lg; s < 3 * K; s += W) fan[s] = zero;
  }
  // non-finite inputs (see the header)
  nonfinite_pass<T, W>(an, bn, fan, fbn, K, lg, live);
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
    pe_acc += __shfl_xor_sync(kFull, pe_acc, off);
  if (live && lg == 0) pe[n] = pe_acc;
}

template <typename T, int W>
cudaError_t launch_pairs(const void* a, const void* b, const void* ta,
                         const void* tb, const void* same, const void* cnt_a,
                         const void* cnt_b, const void* eps_t,
                         const void* sig_t, int n_types, double r_cut2,
                         double k_rf, double c_rf, int64_t N, int64_t K,
                         void* fa, void* fb, void* pe, int64_t smem,
                         cudaStream_t stream) {
  constexpr int64_t per_block = kPairWarps * (32 / W);
  const int64_t blocks = (N + per_block - 1) / per_block;
  if (smem > 48 * 1024) {      // only a force field of many types
    cudaError_t e = cudaFuncSetAttribute(
        pair_forces_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  pair_forces_kernel<T, W><<<static_cast<unsigned>(blocks), 32 * kPairWarps,
                             static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const int32_t*>(ta), static_cast<const int32_t*>(tb),
      static_cast<const int32_t*>(same), static_cast<const int32_t*>(cnt_a),
      static_cast<const int32_t*>(cnt_b), static_cast<const T*>(eps_t),
      static_cast<const T*>(sig_t), n_types, static_cast<T>(r_cut2),
      static_cast<T>(k_rf), static_cast<T>(c_rf), N, static_cast<int>(K),
      static_cast<T*>(fa), static_cast<T*>(fb), static_cast<T*>(pe));
  return cudaGetLastError();
}

template <typename T>
int launch_pair_forces(const void* a, const void* b, const void* ta,
                       const void* tb, const void* same, const void* cnt_a,
                       const void* cnt_b, const void* eps_t,
                       const void* sig_t, int n_types, double r_cut2,
                       double k_rf, double c_rf, int64_t N, int64_t K,
                       void* fa, void* fb, void* pe, void* stream) {
  if (N < 1 || N > 2147483647 || K < 1 || K > 2147483647 || n_types < 1 ||
      (cnt_a == nullptr) != (cnt_b == nullptr) || !aligned16(a) ||
      !aligned16(b))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem = static_cast<int64_t>(n_types) * n_types *
                       static_cast<int64_t>(sizeof(TypePair<T>));
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = K > 16  ? &launch_pairs<T, 32>
                : K > 8 ? &launch_pairs<T, 16>
                        : &launch_pairs<T, 8>;
  return static_cast<int>(launch(a, b, ta, tb, same, cnt_a, cnt_b, eps_t,
                                 sig_t, n_types, r_cut2, k_rf, c_rf, N, K,
                                 fa, fb, pe, smem, s));
}

// ---- scatter_accum: out[c] = sum of c's entries, in worklist order ----------

constexpr int kScatterWarps = 8;   // cells a block
constexpr int kAhead = 4;          // entries whose loads are in flight at once

__device__ __forceinline__ float vadd(float x, float y) { return x + y; }
__device__ __forceinline__ double vadd(double x, double y) { return x + y; }
__device__ __forceinline__ float4 vadd(float4 x, float4 y) {
  return make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
}
__device__ __forceinline__ double2 vadd(double2 x, double2 y) {
  return make_double2(x.x + y.x, x.y + y.y);
}

// V is the word a lane moves: float4 / double2, or the element itself.
template <typename V>
__global__ void __launch_bounds__(32 * kScatterWarps) scatter_accum_kernel(
    const int32_t* __restrict__ order, const int32_t* __restrict__ start,
    const V* __restrict__ fa, const V* __restrict__ fb, int64_t n_cells,
    int row_words, int64_t n_entries, V* __restrict__ out) {
  // an index whose segments do not cover all 2N entries came from a cell
  // id outside [0, n_cells): a fault of the caller (the plain form raises)
  if (blockIdx.x == 0 && threadIdx.x == 0 &&
      (start[0] != 0 || start[n_cells] != n_entries))
    __trap();
  const int64_t cell =
      static_cast<int64_t>(blockIdx.x) * kScatterWarps + threadIdx.x / 32;
  if (cell >= n_cells) return;   // the whole warp
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.y * 32 + lane;   // a row of many words: more warps
  const bool in_w = w < row_words;
  const int32_t p0 = start[cell], p1 = start[cell + 1];
  V acc = V();   // +0.0
  for (int32_t q0 = p0; q0 < p1; q0 += 32) {
    const int m = min(32, p1 - q0);
    const int32_t mine = lane < m ? order[q0 + lane] : 0;
    for (int k0 = 0; k0 < m; k0 += kAhead) {
      V v[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int32_t e = __shfl_sync(kFull, mine, k0 + u);
        v[u] = V();
        if (k0 + u < m && in_w)
          v[u] = __ldg((e & 1 ? fb : fa) +
                       static_cast<int64_t>(e >> 1) * row_words + w);
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        if (k0 + u < m) acc = vadd(acc, v[u]);
    }
  }
  if (in_w) out[cell * row_words + w] = acc;
}

template <typename V>
cudaError_t launch_scatter(const void* order, const void* start,
                           const void* fa, const void* fb, int64_t n_cells,
                           int64_t row_words, int64_t n_entries, void* out,
                           cudaStream_t stream) {
  const int64_t blocks = (n_cells + kScatterWarps - 1) / kScatterWarps;
  const int64_t chunks = (row_words + 31) / 32;   // 32 words a warp
  if (blocks > 2147483647 || chunks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(chunks));
  scatter_accum_kernel<V><<<grid, 32 * kScatterWarps, 0, stream>>>(
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(start),
      static_cast<const V*>(fa), static_cast<const V*>(fb), n_cells,
      static_cast<int>(row_words), n_entries, static_cast<V*>(out));
  return cudaGetLastError();
}

template <typename T, typename V>
int launch_scatter_accum(const void* order, const void* start,
                         const void* fa, const void* fb, int64_t n_cells,
                         int64_t K, int64_t n_entries, void* out,
                         void* stream) {
  if (n_cells < 1 || K < 1 || n_entries < 2 || n_entries > 2147483647)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t row_bytes = 3 * K * static_cast<int64_t>(sizeof(T));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte words when every row is whole words on a 16-byte boundary
  if (row_bytes % 16 == 0 && aligned16(fa) && aligned16(fb) &&
      aligned16(out))
    return static_cast<int>(launch_scatter<V>(
        order, start, fa, fb, n_cells, row_bytes / 16, n_entries, out, s));
  return static_cast<int>(launch_scatter<T>(order, start, fa, fb, n_cells,
                                            3 * K, n_entries, out, s));
}

}  // namespace

#define REPRO_NB_ENTRY(SUFFIX, T, V)                                        \
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
    return launch_scatter_accum<T, V>(order, start, fa, fb, n_cells, K,     \
                                      n_entries, out, stream);              \
  }

REPRO_NB_ENTRY(f32, float, float4)
REPRO_NB_ENTRY(f64, double, double2)
