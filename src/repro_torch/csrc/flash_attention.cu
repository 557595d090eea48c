// Flash attention (causal or full, grouped-query) for Hopper (sm_90a),
// bfloat16 on the tensor cores and float32 on the CUDA cores, head_dim 16,
// 32, 64 or 128.
//
// Replaces the TPU kernel of the JAX package:
//   flash_attention_*  <- src/repro/kernels/flash_attention.py:76
//                         flash_attention (_flash_kernel, l.25)
// The flash_attention_lse_* entries run the same kernels and also write
// each row's float32 log-sum-exp, for training.  flash_attention_bwd_*
// (B7b, the backward, at the end of the file) replaces no TPU kernel: the
// reference trains through autodiff of its pure-JAX blocked_attention
// (src/repro/models/attention.py:89), and its Pallas kernel has no
// backward.
//
// Layout as the reference: q (BH, L, G, hd), k and v (BH, S, hd), output
// (BH, L, G, hd) in q's dtype; BH = batch * kv heads, G = q heads per kv
// head.  Per bh the query is an (L*G, hd) matrix whose row r is position
// r / G, so a block takes consecutive rows whatever G is, and GQA needs no
// change of layout.
//
// What both kernels compute is _flash_kernel's contraction, not its TPU
// grid: one block per (bh, tile of query rows); a loop over kv tiles in
// order from key 0; the running max, denominator and accumulator of every
// row in registers, in float32.  The rounding points are the reference's:
// q is scaled in float32 and rounded to the input dtype before the q.k
// dot (the scale is not folded into the exponent); logits accumulate in
// float32; m_new, corr and l = l * corr + sum(p) are float32, p unrounded
// in the sum; p = exp(logit - m_new) is rounded to v's dtype before the
// p.v dot, whose float32 sum pv is added as acc = acc * corr + pv; the
// output is acc / max(l, 1e-30) by true division, rounded once.  A masked
// logit is the reference's NEG_INF = -1e30, never -inf (a row whose tile
// is all masked would give -inf - -inf = NaN); keys past S (a ragged last
// tile) are -inf, so p = 0 exactly and they never enter the max.  Tiles
// wholly above the diagonal are not loaded.  A loaded tile whose first
// key lies past all of a row group's positions changes nothing for it
// (m_new = m, corr = 1, every p = 0): the f32 kernel's warps skip it, the
// bf16 kernel's consumers run it.  Blocks are issued from the last row
// tile down, so the causal blocks with the most keys start first and the
// tail is short.
//
// What bounds it.  At the serve shape of qwen3-1.7b (batch 4 x 8 kv heads
// = BH 32, L = S = 1024, G = 2, hd = 128, bf16, causal) one launch does
// 4 * BH * G * hd * L(L+1)/2 = 1.72e10 operations and moves q, k, v and o
// once, 50.3 MB: 17.4 us at the tensor cores' 989 TFLOP/s (bf16) against
// 15.0 us at 3.35 TB/s, so it is bound by operations, on the tensor cores.
//
// bfloat16: flash_kernel_bf16, products on the tensor cores.
//   * Three warpgroups of 128 threads: a producer (warpgroup 0, one
//     thread issues every copy) and two consumers, each owning 64
//     consecutive rows of the block's 128.  setmaxnreg moves registers
//     from the producer (24 a thread) to the consumers (240).
//   * TMA (cp.async.bulk.tensor) loads q once per block and the k and v
//     tiles of kBN = 128 keys into a ring of kStages = 2 stages in shared
//     memory, in bf16, through 3-D tensor maps (hd, rows, BH): a ragged
//     last tile reads zeros, never the next bh's rows.  Each stage has
//     full barriers for k and for v (mbarrier complete_tx), so q.k starts
//     before v lands, and empty barriers for k and for v on which every
//     consumer warp arrives once it is done with the tile; the producer
//     refills a stage's k as soon as both consumers' q.k are done with it.
//   * A row of hd bf16 values is 32, 64, 128 or 256 bytes: hd 16 / 32 / 64
//     use the 32B / 64B / 128B swizzle in one panel, hd 128 two 64-column
//     panels of 128B swizzle.  The TMA maps and the wgmma descriptors use
//     the same mode.
//   * q is scaled and rounded in place in shared memory by its consumer
//     (elementwise, so the swizzle does not matter), then
//     fence.proxy.async before the tensor cores read it.
//   * S = q.k^T: wgmma.mma_async m64n128k16, q (A) and k (B) from shared
//     memory, K-major, f32 accumulators in registers.  The online softmax
//     works on the accumulator fragments (a thread holds two rows; row max
//     and sum go through a quad of lanes); the element mask runs only on
//     tiles that cross the diagonal or run past S.
//   * pv = p.v: wgmma m64n{hd}k16 with p as the A operand in registers
//     (the f32 S fragments, rounded to bf16 pairs, map one to one onto
//     the A fragments of a k16 step) and v (B) from shared memory in the
//     transposed (MN-major) mode; then acc = acc * corr + pv in f32.
//     wgmma.fence / commit_group / wait_group bracket every product.
//   * Ping-pong: the two consumers take turns (named barriers) to issue
//     their products, so one's softmax overlaps the other's products.
//     Every consumer runs every tile of its block and never branches
//     around a product (ptxas serializes wgmmas split by a branch).
//   * The output is written from the accumulator fragments, rows past
//     L*G dropped.  No atomics: every run gives the same bits.
//   Measured by chip_smoke.py phase 13 on an NVIDIA H100 80GB HBM3 at a
//   700.00 W power limit: 0.0739 ms a launch at the serve shape (233
//   TFLOP/s, 24 % of the bound) against SDPA's 0.0488 ms in the same run;
//   the f32-FMA kernel it replaces took 0.9466 ms.  What still bounds it
//   is each consumer's chain per tile: q.k, then the softmax (expf, the
//   reference's exp, a few instructions a value on top of the MUFU), then
//   p.v.  acc and pv are held apart to keep the reference's rounding
//   point acc * corr + pv; at hd 128 those 128 registers a thread leave
//   no room to issue the next tile's q.k before the softmax (tried: it
//   spills and ptxas serializes the wgmmas).
//
// float32: flash_kernel_f32, the port's first kernel, on the CUDA cores.
// TF32 on the tensor cores keeps about 3 decimal digits and would break
// the 2e-5 float32 bar, so float32 (which serves the tests and the float32
// card-against-CPU check, not the bf16 serving path) keeps f32 FMAs: 8 rows
// a warp, 64-key tiles staged in shared memory as float32, hd / 32 output
// columns a lane, row max and sum by warp shuffles.  Choosing the entry
// point by dtype is a dispatch, not a fallback.
//
// Kernels run on the caller's stream, allocate nothing and do not
// synchronise.  Each C entry point returns the launch's cudaError_t
// (cudaErrorInvalidValue for a head_dim it was not built for or a tensor
// map the driver refuses).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;              // the reference's NEG_INF

// ---- float32: CUDA-core kernel ---------------------------------------------

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;   // query rows per block
constexpr int kBK = 64;                        // keys per staged tile
constexpr int kKeysPerLane = kBK / 32;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory of one block, in floats: the scaled q tile (kRows, hd),
// the k tile (kBK, hd + 4), the v tile (kBK, hd) and each warp's p rows
// (kRows, kBK).
template <int HD>
constexpr size_t smem_bytes_f32() {
  return sizeof(float) * (static_cast<size_t>(kRows) * HD +
                          static_cast<size_t>(kBK) * (HD + 4) +
                          static_cast<size_t>(kBK) * HD +
                          static_cast<size_t>(kRows) * kBK);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int64_t L, int64_t G, int64_t S,
                     int causal, float scale) {
  constexpr int KS = HD + 4;                    // padded k row
  constexpr int DPL = HD >= 32 ? HD / 32 : 1;   // output columns per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kRows * HD;
  float* vs = ks + kBK * KS;
  float* ps = vs + kBK * HD;

  const int64_t LG = L * G;
  const int64_t bh = blockIdx.y;
  const int64_t r0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  q += bh * LG * HD;
  o += bh * LG * HD;
  k += bh * S * HD;
  v += bh * S * HD;

  // q tile: scaled in float32 (l.44-46; the rounding to float32 is exact)
  for (int e = tid; e < kRows * HD; e += kThreads)
    qs[e] = r0 * HD + e < LG * HD ? __fmul_rn(q[r0 * HD + e], scale) : 0.f;

  const int64_t last_row = (r0 + kRows < LG ? r0 + kRows : LG) - 1;
  int64_t n_keys = S;
  if (causal && last_row / G + 1 < n_keys) n_keys = last_row / G + 1;
  const int64_t n_tiles = (n_keys + kBK - 1) / kBK;

  const int64_t w0 = r0 + warp * kRowsPerWarp;   // this warp's first row
  const bool live = w0 < LG;
  const int64_t w_last = (w0 + kRowsPerWarp < LG ? w0 + kRowsPerWarp : LG) - 1;
  const int64_t w_pos_max = w_last / G;
  int64_t pos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    pos[r] = (w0 + r) / G;
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  const float* qw = qs + warp * kRowsPerWarp * HD;
  float* pw = ps + warp * kRowsPerWarp * kBK;
  const bool dlive = lane < HD;   // hd 16: half the lanes own no column

  for (int64_t t = 0; t < n_tiles; ++t) {
    const int64_t j0 = t * kBK;
    __syncthreads();   // every warp is done with the previous tile
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int j = e / HD;
      const bool in = j0 + j < S;
      ks[j * KS + e % HD] = in ? k[j0 * HD + e] : 0.f;
      vs[e] = in ? v[j0 * HD + e] : 0.f;
    }
    __syncthreads();
    if (!live || (causal && j0 > w_pos_max)) continue;

    // logits of the warp's rows against the lane's two keys
    float s[kRowsPerWarp][kKeysPerLane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 kk[kKeysPerLane];
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c)
        kk[c] = *reinterpret_cast<const float4*>(ks + (lane + 32 * c) * KS + d);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(qw + r * HD + d);
#pragma unroll
        for (int c = 0; c < kKeysPerLane; ++c) {
          s[r][c] = fmaf(qq.x, kk[c].x, s[r][c]);
          s[r][c] = fmaf(qq.y, kk[c].y, s[r][c]);
          s[r][c] = fmaf(qq.z, kk[c].z, s[r][c]);
          s[r][c] = fmaf(qq.w, kk[c].w, s[r][c]);
        }
      }
    }

    // online softmax: mask, tile max, p, l and corr
    float corr[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        const int64_t key = j0 + lane + 32 * c;
        if (key >= S)
          s[r][c] = -CUDART_INF_F;
        else if (causal && key > pos[r])
          s[r][c] = kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      corr[r] = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        const float p = expf(s[r][c] - m_new);
        psum += p;
        pw[r * kBK + lane + 32 * c] = p;
      }
      l[r] = l[r] * corr[r] + warp_sum(psum);
      m[r] = m_new;
    }
    __syncwarp();

    // p.v over the keys that can carry weight for this warp (the others
    // have p = 0 exactly and finite v, so leaving them out is exact)
    int64_t j_end = S - j0 < kBK ? S - j0 : kBK;
    if (causal && w_pos_max - j0 + 1 < j_end) j_end = w_pos_max - j0 + 1;
    const int jn = static_cast<int>(j_end);
    float pv[kRowsPerWarp][DPL];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int i = 0; i < DPL; ++i) pv[r][i] = 0.f;
    int j = 0;
    for (; j + 4 <= jn; j += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          vv[jj][i] = dlive ? vs[(j + jj) * HD + lane + 32 * i] : 0.f;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 pp = *reinterpret_cast<const float4*>(pw + r * kBK + j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          pv[r][i] = fmaf(pp.x, vv[0][i], pv[r][i]);
          pv[r][i] = fmaf(pp.y, vv[1][i], pv[r][i]);
          pv[r][i] = fmaf(pp.z, vv[2][i], pv[r][i]);
          pv[r][i] = fmaf(pp.w, vv[3][i], pv[r][i]);
        }
      }
    }
    for (; j < jn; ++j) {
      float vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        vv[i] = dlive ? vs[j * HD + lane + 32 * i] : 0.f;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = pw[r * kBK + j];
#pragma unroll
        for (int i = 0; i < DPL; ++i) pv[r][i] = fmaf(p, vv[i], pv[r][i]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] = acc[r][i] * corr[r] + pv[r][i];
  }

  if (!live || !dlive) return;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int64_t row = w0 + r;
    if (row >= LG) break;
    const float den = fmaxf(l[r], 1e-30f);
    if (lse != nullptr && lane == 0) lse[bh * LG + row] = m[r] + logf(den);
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[row * HD + lane + 32 * i] = acc[r][i] / den;
  }
}

// ---- bfloat16: tensor-core kernel ------------------------------------------

constexpr int kWG = 128;                  // threads in a warpgroup
constexpr int kBM = 64;                   // query rows per consumer warpgroup
constexpr int kConsumers = 2;
constexpr int kBlockRows = kConsumers * kBM;
constexpr int kBN = 128;                  // keys per kv tile
constexpr int kStages = 2;                // depth of the k / v ring
constexpr int kThreadsBf16 = (1 + kConsumers) * kWG;

// ---- PTX wrappers: mbarrier, TMA, wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed (try_wait
// suspends the thread in hardware between polls).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Named barriers among the consumer threads.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// One TMA box of a 3-D map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pins accumulator registers at this point of the program, so that the
// compiler neither reads them before wgmma_wait_all nor writes them after
// the wgmma that reads them has been issued.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of wgmma: start address, leading and
// stride byte offsets (16-byte units) and the swizzle mode (1 = 128B,
// 2 = 64B, 3 = 32B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(mode) << 62;
}

#define D8(c, i)                                                 \
  c(d[(i)]), c(d[(i) + 1]), c(d[(i) + 2]), c(d[(i) + 3]), c(d[(i) + 4]), \
      c(d[(i) + 5]), c(d[(i) + 6]), c(d[(i) + 7])

// wgmma_ss: D (64 x N, f32) = or += A (64 x 16, shared, K-major) *
// B (16 x N, shared, K-major).  wgmma_rs: the same with A in registers
// (four bf16 pairs a thread) and B MN-major (the transposed mode, which
// 16-bit types allow).  kAcc = false overwrites D (its registers are
// outputs only, so they need not stay live across the loop).
#define FA_SS128                                                  \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                   \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14," \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27," \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40," \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53," \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
  "%64, %65, p, 1, 1, 0, 0;\n}\n"

template <bool kAcc>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  if constexpr (kAcc)
    asm volatile(FA_SS128
        : D8("+f", 0), D8("+f", 8), D8("+f", 16), D8("+f", 24),
          D8("+f", 32), D8("+f", 40), D8("+f", 48), D8("+f", 56)
        : "l"(da), "l"(db), "r"(1));
  else
    asm volatile(FA_SS128
        : D8("=f", 0), D8("=f", 8), D8("=f", 16), D8("=f", 24),
          D8("=f", 32), D8("=f", 40), D8("=f", 48), D8("=f", 56)
        : "l"(da), "l"(db), "r"(0));
}
#undef FA_SS128

#define FA_SS64                                                   \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                   \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14," \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27," \
  "%28, %29, %30, %31}, " \
  "%32, %33, p, 1, 1, 0, 0;\n}\n"

template <bool kAcc>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  if constexpr (kAcc)
    asm volatile(FA_SS64
        : D8("+f", 0), D8("+f", 8), D8("+f", 16), D8("+f", 24)
        : "l"(da), "l"(db), "r"(1));
  else
    asm volatile(FA_SS64
        : D8("=f", 0), D8("=f", 8), D8("=f", 16), D8("=f", 24)
        : "l"(da), "l"(db), "r"(0));
}
#undef FA_SS64

#define FA_RS16                                                   \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                   \
  "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "          \
  "{%0, %1, %2, %3, %4, %5, %6, %7}, " \
  "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"

template <bool kAcc>
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kAcc)
    asm volatile(FA_RS16
        : D8("+f", 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else
    asm volatile(FA_RS16
        : D8("=f", 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}
#undef FA_RS16

#define FA_RS32                                                   \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                   \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14," \
  "%15}, " \
  "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"

template <bool kAcc>
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kAcc)
    asm volatile(FA_RS32
        : D8("+f", 0), D8("+f", 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else
    asm volatile(FA_RS32
        : D8("=f", 0), D8("=f", 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}
#undef FA_RS32

#define FA_RS64                                                   \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                   \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14," \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27," \
  "%28, %29, %30, %31}, " \
  "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"

template <bool kAcc>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kAcc)
    asm volatile(FA_RS64
        : D8("+f", 0), D8("+f", 8), D8("+f", 16), D8("+f", 24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else
    asm volatile(FA_RS64
        : D8("=f", 0), D8("=f", 8), D8("=f", 16), D8("=f", 24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}
#undef FA_RS64

#define FA_RS128                                                   \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                   \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14," \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27," \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40," \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53," \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
  "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"

template <bool kAcc>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kAcc)
    asm volatile(FA_RS128
        : D8("+f", 0), D8("+f", 8), D8("+f", 16), D8("+f", 24),
          D8("+f", 32), D8("+f", 40), D8("+f", 48), D8("+f", 56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else
    asm volatile(FA_RS128
        : D8("=f", 0), D8("=f", 8), D8("=f", 16), D8("=f", 24),
          D8("=f", 32), D8("=f", 40), D8("=f", 48), D8("=f", 56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}
#undef FA_RS128

#undef D8


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Shared-memory plan of the bf16 kernel at head dim HD.  A tile of R rows
// is NP panels of (R, PW) bf16, each row of a panel ROWB bytes under the
// ROWB-byte swizzle; every region starts on a 1024-byte boundary.
template <int HD>
struct Plan {
  static constexpr int PW = HD < 64 ? HD : 64;   // panel width, elements
  static constexpr int NP = HD / PW;
  static constexpr int ROWB = PW * 2;
  static constexpr uint32_t MODE = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : ROWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                   : CU_TENSOR_MAP_SWIZZLE_32B;
  static constexpr uint32_t Q_BYTES = kBM * HD * 2;   // one warpgroup's q
  static constexpr uint32_t KV_BYTES = kBN * HD * 2;  // one k or v tile
  static constexpr uint32_t K_OFF = kConsumers * Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + kStages * KV_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + kStages * KV_BYTES;
  // mbarriers: q full, then per stage k full, v full, k empty, v empty
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 4 * kStages) + 1024;
};

// The online softmax of one tile on the S fragments of a thread (rows
// row0 = 16w + g and row1 = row0 + 8 of its warpgroup, keys j0 + 8 * (i / 4)
// + 2 * qd + (i & 1) of fragment i): mask, m_new, corr, p, l; p rounded to
// bf16 into the A fragments of p.v (keys 16kk..16kk+15 are the kk-th k16
// step).
template <int NS>
__device__ __forceinline__ void softmax_tile(
    float (&sacc)[NS], uint32_t (&pa)[NS / 8][4], float& m0, float& m1,
    float& l0, float& l1, float& corr0, float& corr1, int j0, int S,
    int causal, int pos0, int pos1, int pos_min, int qd) {
  constexpr int kBNt = 2 * NS;
  // mask (only where the tile crosses the diagonal or runs past S): keys
  // from j0 on, the first past S and the last each row sees
  if (j0 + kBNt > S || (causal && j0 + kBNt - 1 > pos_min)) {
    const int end = min(S - j0, kBNt);
    const int see0 = causal ? max(min(pos0 - j0, kBNt), -1) : kBNt;
    const int see1 = causal ? max(min(pos1 - j0, kBNt), -1) : kBNt;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int key = 8 * (i / 4) + 2 * qd + (i & 1);
      sacc[i] = key >= end                       ? -CUDART_INF_F
                : key > ((i & 2) ? see1 : see0) ? kNegInf
                                                  : sacc[i];
    }
  }
  // row max (four partial maxima a row, then the quad), m_new, corr
  float x0[4], x1[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) x0[j] = x1[j] = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < NS; i += 4) {
    x0[i / 4 % 4] = fmaxf(x0[i / 4 % 4], fmaxf(sacc[i], sacc[i + 1]));
    x1[i / 4 % 4] = fmaxf(x1[i / 4 % 4], fmaxf(sacc[i + 2], sacc[i + 3]));
  }
  const float mn0 =
      fmaxf(m0, quad_max(fmaxf(fmaxf(x0[0], x0[1]), fmaxf(x0[2], x0[3]))));
  const float mn1 =
      fmaxf(m1, quad_max(fmaxf(fmaxf(x1[0], x1[1]), fmaxf(x1[2], x1[3]))));
  // corr = exp(m - m_new) and p = exp(x - m_new) as the reference writes
  // them: the difference in float32, then expf (the accurate float32 exp,
  // as torch.exp on the card); four partial sums a row
  corr0 = expf(m0 - mn0);
  corr1 = expf(m1 - mn1);
#pragma unroll
  for (int j = 0; j < 4; ++j) x0[j] = x1[j] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; i += 4) {
    sacc[i] = expf(sacc[i] - mn0);
    sacc[i + 1] = expf(sacc[i + 1] - mn0);
    sacc[i + 2] = expf(sacc[i + 2] - mn1);
    sacc[i + 3] = expf(sacc[i + 3] - mn1);
    x0[i / 4 % 4] += sacc[i] + sacc[i + 1];
    x1[i / 4 % 4] += sacc[i + 2] + sacc[i + 3];
  }
  // l = l * corr + sum(p) with the tile's row sum, the product and the
  // sum rounded as the reference rounds them (no FMA)
  l0 = __fadd_rn(__fmul_rn(l0, corr0),
                 quad_sum((x0[0] + x0[1]) + (x0[2] + x0[3])));
  l1 = __fadd_rn(__fmul_rn(l1, corr1),
                 quad_sum((x1[0] + x1[1]) + (x1[2] + x1[3])));
  m0 = mn0;
  m1 = mn1;
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);
}

template <int HD>
__global__ void __launch_bounds__(kThreadsBf16, 1)
    flash_kernel_bf16(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int LG, int G, int S, int causal, float scale) {
  using P = Plan<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t q_full = base + P::BAR_OFF;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 3 * kStages + s); };

  // blocks of the last row tile (most keys under the causal mask) first
  const int bh = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;
  const int last_row = min(r0 + kBlockRows, LG) - 1;
  const int n_keys = causal ? min(S, last_row / G + 1) : S;
  const int n_tiles = (n_keys + kBN - 1) / kBN;
  const int wg = threadIdx.x / kWG;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumers * 4);   // one arrival a warp
      mbar_init(v_empty(s), kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: q once (rows past L*G read as zeros), then the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kConsumers * P::Q_BYTES);
      for (int c = 0; c < kConsumers; ++c)
        for (int p = 0; p < P::NP; ++p)
          tma_load(base + c * P::Q_BYTES + p * kBM * P::ROWB, &tq, q_full,
                   p * P::PW, r0 + c * kBM, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t parity = ((t / kStages) & 1) ^ 1;
        const uint32_t koff = base + P::K_OFF + s * P::KV_BYTES;
        const uint32_t voff = base + P::V_OFF + s * P::KV_BYTES;
        if (t >= kStages) mbar_wait(k_empty(s), parity);
        mbar_expect_tx(k_full(s), P::KV_BYTES);
        for (int p = 0; p < P::NP; ++p)
          tma_load(koff + p * kBN * P::ROWB, &tk, k_full(s), p * P::PW,
                   t * kBN, bh);
        if (t >= kStages) mbar_wait(v_empty(s), parity);
        mbar_expect_tx(v_full(s), P::KV_BYTES);
        for (int p = 0; p < P::NP; ++p)
          tma_load(voff + p * kBN * P::ROWB, &tv, v_full(s), p * P::PW,
                   t * kBN, bh);
      }
    }
  } else {
    // ---- consumers: 64 rows each, every tile of the block.  A tile
    // whose keys all lie past a row's position changes nothing for it
    // (m_new = m, corr = 1, every p = 0), so no warpgroup branches around
    // a product, which would make ptxas serialize the wgmmas.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    constexpr int NS = kBN / 2;   // S fragment floats a thread
    constexpr int NO = HD / 2;    // output fragment floats a thread
    const int c = wg - 1;
    const int tid = threadIdx.x - wg * kWG;
    const int w = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
    const int rw = r0 + c * kBM;                          // first row
    const int row0 = rw + 16 * w + g, row1 = row0 + 8;    // this thread's
    const int pos0 = row0 / G, pos1 = row1 / G;
    const int pos_min = rw / G;
    const uint32_t q_base = base + c * P::Q_BYTES;

    // q scaled in float32 and rounded to bf16, in place (l.44-46)
    mbar_wait(q_full, 0);
    uint4* qv = reinterpret_cast<uint4*>(smem + c * P::Q_BYTES);
    for (int i = tid; i < static_cast<int>(P::Q_BYTES / 16); i += kWG) {
      uint4 x = qv[i];
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        h[j] = __floats2bfloat162_rn(__fmul_rn(f.x, scale),
                                     __fmul_rn(f.y, scale));
      }
      qv[i] = x;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bar_sync(1 + c, kWG);

    float sacc[NS], pv[NO], acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    // Ping-pong: the two consumers take turns to issue their products
    // (a turn ends right after the commit), so the tensor cores run one
    // warpgroup's products while the other computes its softmax, and the
    // two softmaxes do not contend for the exponential units.  Consumer 0
    // goes first; each takes 2 * n_tiles turns.
    constexpr int kTurn = 1 + kConsumers;   // named barriers kTurn + c
    if (c == 1) bar_arrive(kTurn, 2 * kWG);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t parity = (t / kStages) & 1;
      const int j0 = t * kBN;

      // S = q.k^T over hd in k16 steps
      bar_sync(kTurn + c, 2 * kWG);
      mbar_wait(k_full(s), parity);
      const uint32_t k_base = base + P::K_OFF + s * P::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t panel = kk * 16 / P::PW;
        const uint32_t off = (kk * 16 % P::PW) * 2;   // bytes into a row
        const uint64_t da = smem_desc(q_base + panel * kBM * P::ROWB + off,
                                      16, 8 * P::ROWB, P::MODE);
        const uint64_t db = smem_desc(k_base + panel * kBN * P::ROWB + off,
                                      16, 8 * P::ROWB, P::MODE);
        if (kk == 0)
          wgmma_ss<false>(sacc, da, db);
        else
          wgmma_ss<true>(sacc, da, db);
      }
      wgmma_commit();
      bar_arrive(kTurn + 1 - c, 2 * kWG);
      wgmma_wait_all();
      fence_regs(sacc);
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty(s));   // one arrival a warp

      float corr0, corr1;
      uint32_t pa[kBN / 16][4];
      softmax_tile(sacc, pa, m0, m1, l0, l1, corr0, corr1, j0, S, causal,
                   pos0, pos1, pos_min, qd);

      // pv = p.v over the tile's keys in k16 steps
      bar_sync(kTurn + c, 2 * kWG);
      mbar_wait(v_full(s), parity);
      const uint32_t v_base = base + P::V_OFF + s * P::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint64_t db = smem_desc(v_base + kk * 16 * P::ROWB,
                                      kBN * P::ROWB, 8 * P::ROWB, P::MODE);
        if (kk == 0)
          wgmma_rs<false>(pv, pa[kk], db);
        else
          wgmma_rs<true>(pv, pa[kk], db);
      }
      wgmma_commit();
      if (!(c == 1 && t == n_tiles - 1))
        bar_arrive(kTurn + 1 - c, 2 * kWG);
      wgmma_wait_all();
      fence_regs(pv);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty(s));
#pragma unroll
      for (int i = 0; i < NO; ++i)
        acc[i] =
            __fadd_rn(__fmul_rn(acc[i], (i & 2) ? corr1 : corr0), pv[i]);
    }

    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
    if (lse != nullptr && qd == 0) {
      float* lb = lse + static_cast<int64_t>(bh) * LG;
      if (row0 < LG) lb[row0] = m0 + logf(den0);
      if (row1 < LG) lb[row1] = m1 + logf(den1);
    }
    __nv_bfloat16* ob = o + static_cast<int64_t>(bh) * LG * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * qd;
      if (row0 < LG)
        *reinterpret_cast<__nv_bfloat162*>(ob + int64_t{row0} * HD + col) =
            __floats2bfloat162_rn(acc[4 * j] / den0, acc[4 * j + 1] / den0);
      if (row1 < LG)
        *reinterpret_cast<__nv_bfloat162*>(ob + int64_t{row1} * HD + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] / den1,
                                  acc[4 * j + 3] / den1);
    }
  }
}

// ---- backward (B7b) ---------------------------------------------------------
//
// dq, dk, dv of out = attention(q, k, v) given dout, the forward's out and
// its float32 log-sum-exp.  Both dtypes compute the same function at the
// forward's rounding points: qs = q * scale rounded to the input type;
// s = qs . k^T with float32 sums; P = exp(s - lse); dP = dO . v^T;
// dS = P * (dP - D) with D = rowsum(dO * O); dV = P^T dO, dK = dS^T qs,
// dQ = scale * (dS k).  Masked keys (causal: key > row / G; past S) have
// P = 0 exactly.  Every dK / dV / dQ element has one writer that sums its
// terms in row (key) order: no atomics, so two launches give the same bits
// (the reference's bit-exact resume, runtime/train_loop.py).
//
// What bounds it.  At the training shape of qwen3-1.7b (BH 32, L = S =
// 1024, G = 2, hd = 128, bf16, causal) the five products (q.k, dO.v,
// P^T dO, dS^T q, dS k) are 4.30e10 operations and the tensors 100.9 MB:
// 43.5 us at the tensor cores' 989 TFLOP/s against 30.1 us at 3.35 TB/s
// (NVIDIA H100 SXM, 700 W), so bound by operations.
//
// bfloat16: three kernels on the tensor cores' layout of the forward.
//   * flash_bwd_prep_bf16: D and qs, a 16-byte word (8 values) a thread,
//     HD / 8 threads a row; D sums each word's fmaf chain, then the row's
//     words by a butterfly (a fixed order).  qs goes into dq's buffer,
//     which both product kernels read by TMA and the dQ kernel overwrites,
//     each block only the rows it has read.  (The two consumers of the
//     dK / dV kernel share every streamed q tile, so scaling it in shared
//     memory as the forward does would need a barrier between them per
//     tile; this pass also reads dO and O for D anyway.)
//   * flash_bwd_dkdv_bf16: a block per (bh, tile of 128 keys), key tile 0
//     (the most rows under the causal mask) first.  A producer warpgroup
//     loads k and v once by TMA and streams the (qs, dO) tiles of 64 rows
//     that can see the keys through a ring of kBwdStages stages; its warp 1
//     stages their lse and D.  Two consumer warpgroups own 64 keys each
//     and, per row tile: S^T = k . qs^T and dP^T = v . dO^T (wgmma SS,
//     m64n64k16, K-major); P^T and dS^T on the accumulator fragments, each
//     rounded to bf16 pairs that map one to one onto the A fragments of a
//     k16 step (as the forward's p); dV += P^T dO and dK += dS^T qs (wgmma
//     RS, m64n{hd}k16, qs and dO MN-major, as the forward's v).  dK and dV
//     stay in f32 registers across the row tiles: 2 x hd / 2 a thread.
//   * flash_bwd_dq_bf16: a block per (bh, tile of 128 rows), the last row
//     tile first.  The producer loads qs and dO once and streams k / v
//     tiles of 64 keys through the ring; each consumer owns 64 rows: S =
//     qs . k^T and dP = dO . v^T (SS), dS on the fragments, dQ += dS k
//     (RS, k MN-major), times the scale (__fmul_rn) at the end.
//   Seven products for the necessary five: the dQ kernel recomputes S and
//   dP rather than adding into a global dQ from the dK / dV kernel, which
//   would need atomics (or an ordering semaphore per tile).  Every tile is
//   64 rows: m64 is wgmma's one height, and at hd 128 a dK / dV consumer
//   holds 128 + 64 f32 accumulators a thread of its 240 registers; 64-key
//   dQ tiles keep its S and dP at 32 registers each.  Tiles wholly above
//   the diagonal are not loaded; the element mask runs only on tiles that
//   cross the diagonal or run past L*G or S.  A consumer runs every tile
//   of its block (a tile it cannot see gives P = 0) and never branches
//   around a product (ptxas serializes wgmmas split by a branch).
//   Measured by chip_smoke.py (phase 19, --kernels) on an NVIDIA H100
//   80GB HBM3 at a 700.00 W power limit: 0.220-0.228 ms a launch at the
//   training shape (19-20 % of the bound, 188-195 TFLOP/s over the five
//   products), where the CUDA-core kernels it replaces took 4.838-4.861
//   ms; SDPA's backward read 0.18-0.52 ms in the same calls.  Device time
//   (torch.profiler): 219 us a launch inside a training step; 165 us over
//   20 back-to-back launches (prep 16, dK / dV 78, dQ 71), the dK / dV
//   and dQ kernels running 38.6 and 27.4 GFLOP (diagonal tiles whole).
//   What bounds them is each consumer's chain per tile (products, wait,
//   exp and mask, products, wait), which the other consumer's products
//   overlap only in part: at hd 128 the 192 f32 accumulators a thread
//   leave no registers to issue the next tile's products before this
//   tile's dV / dK.  A third ring stage was tried and gained nothing.
//
// float32: flash_bwd_delta_f32 (a warp a row), flash_bwd_dkdv_f32 (a block
// per (bh, tile of kBKb keys)) and flash_bwd_dq_f32 (a block per (bh, tile
// of kBR rows)) on the CUDA cores, every dot one float32 FMA chain in a
// fixed order, tiles staged in shared memory (rows padded by 4 floats: the
// 16-byte reads of eight neighbouring rows fall on distinct banks).  TF32
// would break the 2e-5 float32 bar (see the forward's note); the dtype
// picks the entry, a dispatch and not a fallback.

// ---- float32: CUDA cores

constexpr int kBR = 32;                  // query rows per tile
constexpr int kBKb = 32;                 // keys per tile
constexpr int kBwdThreads = 256;         // thread t: row / key t / 8
constexpr int kPS = kBKb + 8;            // padded row of the P and dS tiles

// VW consecutive floats of shared memory (16- or 8-byte aligned)
template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VW == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x, out[1] = x.y;
  }
}

template <int HD>
struct BwdPlan {
  static constexpr int KS = HD + 4;                 // padded tile row
  static constexpr int VW = HD >= 32 ? 4 : 2;       // floats a vector read
  static constexpr int NG = HD / (8 * VW);          // vector groups a thread
  // floats: k, v tiles (kBKb rows), qs, dO tiles (kBR rows), P and dS,
  // lse and D of the row tile
  static constexpr size_t SMEM =
      sizeof(float) * (static_cast<size_t>(2 * kBKb + 2 * kBR) * KS +
                       2 * kBR * kPS + 2 * kBR);
};

// `n` rows of HD values from src[first..] into dst (stride KS), zeros past
// `limit`; `scale` > 0 scales them (the forward's qs).
template <int HD>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int64_t first, int64_t limit, int n,
                                      float scale) {
  for (int e = threadIdx.x; e < n * HD; e += kBwdThreads) {
    const int r = e / HD, c = e % HD;
    float x = 0.f;
    if (first + r < limit) {
      x = src[(first + r) * HD + c];
      if (scale > 0.f) x = __fmul_rn(x, scale);
    }
    dst[r * BwdPlan<HD>::KS + c] = x;
  }
}

// P and dS of the (kBR rows from r0) x (kBKb keys from j0) tile into shared
// memory: thread t takes row t / 8 and keys t % 8 + 8c.
template <int HD>
__device__ __forceinline__ void tile_scores(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* del_s, float* ps, float* dss, int64_t r0,
    int64_t j0, int64_t LG, int64_t G, int64_t S, int causal) {
  constexpr int KS = BwdPlan<HD>::KS;
  const int i = threadIdx.x >> 3, jl = threadIdx.x & 7;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float4 qq = *reinterpret_cast<const float4*>(qs + i * KS + d);
    const float4 oo = *reinterpret_cast<const float4*>(dos + i * KS + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = jl + 8 * c;
      const float4 kk = *reinterpret_cast<const float4*>(ks + j * KS + d);
      const float4 vv = *reinterpret_cast<const float4*>(vs + j * KS + d);
      s[c] = fmaf(qq.x, kk.x, s[c]);
      s[c] = fmaf(qq.y, kk.y, s[c]);
      s[c] = fmaf(qq.z, kk.z, s[c]);
      s[c] = fmaf(qq.w, kk.w, s[c]);
      dp[c] = fmaf(oo.x, vv.x, dp[c]);
      dp[c] = fmaf(oo.y, vv.y, dp[c]);
      dp[c] = fmaf(oo.z, vv.z, dp[c]);
      dp[c] = fmaf(oo.w, vv.w, dp[c]);
    }
  }
  const int64_t row = r0 + i;
  const int64_t pos = row / G;
  const float l = lse_s[i], dl = del_s[i];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = jl + 8 * c;
    const int64_t key = j0 + j;
    const bool seen = row < LG && key < S && (!causal || key <= pos);
    const float p = seen ? expf(s[c] - l) : 0.f;
    ps[i * kPS + j] = p;
    dss[i * kPS + j] = p * (dp[c] - dl);
  }
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_delta_f32(const float* __restrict__ o,
                        const float* __restrict__ dout,
                        float* __restrict__ delta, int64_t rows) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kBwdThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;   // whole warps
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32)
    acc = fmaf(o[row * HD + d], dout[row * HD + d], acc);
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ dk,
                       float* __restrict__ dv, int64_t L, int64_t G, int64_t S,
                       int causal, float scale) {
  using B = BwdPlan<HD>;
  constexpr int KS = B::KS, VW = B::VW, NG = B::NG;
  extern __shared__ float4 smem_b4[];
  float* ks = reinterpret_cast<float*>(smem_b4);
  float* vs = ks + kBKb * KS;
  float* qs = vs + kBKb * KS;
  float* dos = qs + kBR * KS;
  float* ps = dos + kBR * KS;
  float* dss = ps + kBR * kPS;
  float* lse_s = dss + kBR * kPS;
  float* del_s = lse_s + kBR;

  const int64_t LG = L * G;
  const int64_t bh = blockIdx.x;
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * kBKb;
  q += bh * LG * HD;
  dout += bh * LG * HD;
  k += bh * S * HD;
  v += bh * S * HD;
  dk += bh * S * HD;
  dv += bh * S * HD;
  lse += bh * LG;
  delta += bh * LG;

  stage<HD>(ks, k, j0, S, kBKb, 0.f);
  stage<HD>(vs, v, j0, S, kBKb, 0.f);

  // accumulators: key j = t / 8, columns (t % 8) * VW + 8 * VW * g + x
  const int j = threadIdx.x >> 3, cl = (threadIdx.x & 7) * VW;
  float akk[NG][VW], avv[NG][VW];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int x = 0; x < VW; ++x) akk[g][x] = avv[g][x] = 0.f;

  // the rows that can see a key of the tile: position >= j0 when causal
  const int64_t first = causal ? j0 * G : 0;
  for (int64_t r0 = first; r0 < LG; r0 += kBR) {
    __syncthreads();   // the previous row tile is done with
    stage<HD>(qs, q, r0, LG, kBR, scale);
    stage<HD>(dos, dout, r0, LG, kBR, 0.f);
    if (threadIdx.x < kBR) {
      const bool in = r0 + threadIdx.x < LG;
      lse_s[threadIdx.x] = in ? lse[r0 + threadIdx.x] : 0.f;
      del_s[threadIdx.x] = in ? delta[r0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    tile_scores<HD>(qs, dos, ks, vs, lse_s, del_s, ps, dss, r0, j0, LG, G, S,
                    causal);
    __syncthreads();
    for (int i = 0; i < kBR; ++i) {
      const float p = ps[i * kPS + j], ds = dss[i * kPS + j];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        float o4[VW], q4[VW];
        load_vec<VW>(dos + i * KS + cl + 8 * VW * g, o4);
        load_vec<VW>(qs + i * KS + cl + 8 * VW * g, q4);
#pragma unroll
        for (int x = 0; x < VW; ++x) {
          avv[g][x] = fmaf(p, o4[x], avv[g][x]);
          akk[g][x] = fmaf(ds, q4[x], akk[g][x]);
        }
      }
    }
  }

  if (j0 + j >= S) return;
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int x = 0; x < VW; ++x) {
      const int64_t e = (j0 + j) * HD + cl + 8 * VW * g + x;
      dk[e] = akk[g][x];
      dv[e] = avv[g][x];
    }
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int64_t L, int64_t G, int64_t S, int causal,
                     float scale) {
  using B = BwdPlan<HD>;
  constexpr int KS = B::KS, VW = B::VW, NG = B::NG;
  extern __shared__ float4 smem_b4[];
  float* ks = reinterpret_cast<float*>(smem_b4);
  float* vs = ks + kBKb * KS;
  float* qs = vs + kBKb * KS;
  float* dos = qs + kBR * KS;
  float* ps = dos + kBR * KS;
  float* dss = ps + kBR * kPS;
  float* lse_s = dss + kBR * kPS;
  float* del_s = lse_s + kBR;

  const int64_t LG = L * G;
  const int64_t bh = blockIdx.x;
  // the last row tile (most keys under the causal mask) first
  const int64_t r0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kBR;
  q += bh * LG * HD;
  dout += bh * LG * HD;
  dq += bh * LG * HD;
  k += bh * S * HD;
  v += bh * S * HD;
  lse += bh * LG;
  delta += bh * LG;

  stage<HD>(qs, q, r0, LG, kBR, scale);
  stage<HD>(dos, dout, r0, LG, kBR, 0.f);
  if (threadIdx.x < kBR) {
    const bool in = r0 + threadIdx.x < LG;
    lse_s[threadIdx.x] = in ? lse[r0 + threadIdx.x] : 0.f;
    del_s[threadIdx.x] = in ? delta[r0 + threadIdx.x] : 0.f;
  }
  const int64_t last_row = (r0 + kBR < LG ? r0 + kBR : LG) - 1;
  int64_t n_keys = S;
  if (causal && last_row / G + 1 < n_keys) n_keys = last_row / G + 1;

  // accumulators: row i = t / 8, columns (t % 8) * VW + 8 * VW * g + x
  const int i = threadIdx.x >> 3, cl = (threadIdx.x & 7) * VW;
  float acc[NG][VW];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int x = 0; x < VW; ++x) acc[g][x] = 0.f;

  for (int64_t j0 = 0; j0 < n_keys; j0 += kBKb) {
    __syncthreads();   // the previous kv tile is done with
    stage<HD>(ks, k, j0, S, kBKb, 0.f);
    stage<HD>(vs, v, j0, S, kBKb, 0.f);
    __syncthreads();
    tile_scores<HD>(qs, dos, ks, vs, lse_s, del_s, ps, dss, r0, j0, LG, G, S,
                    causal);
    __syncthreads();
    for (int j = 0; j < kBKb; ++j) {
      const float ds = dss[i * kPS + j];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        float k4[VW];
        load_vec<VW>(ks + j * KS + cl + 8 * VW * g, k4);
#pragma unroll
        for (int x = 0; x < VW; ++x) acc[g][x] = fmaf(ds, k4[x], acc[g][x]);
      }
    }
  }

  if (r0 + i >= LG) return;
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int x = 0; x < VW; ++x)
      dq[(r0 + i) * HD + cl + 8 * VW * g + x] = __fmul_rn(acc[g][x], scale);
}

// ---- bfloat16: tensor cores

constexpr int kBT = 64;          // rows of every bf16 backward tile: a
                                 // consumer's keys, a row tile, a key tile
constexpr int kBwdStages = 2;    // depth of the streamed rings

// Shared memory of the bf16 backward kernels at head dim HD (Plan<HD>'s
// panels and swizzle; every tile is kBT rows, T bytes, 1024-aligned).
template <int HD>
struct BwdTC {
  static constexpr uint32_t T = kBT * HD * 2;
  // dK / dV: k and v of both consumers, the ring of (qs, dO) stages, each
  // stage's lse and D (kBT floats each), then the mbarriers (k / v full,
  // per stage full, per stage empty)
  static constexpr uint32_t KV_K = 0;
  static constexpr uint32_t KV_V = 2 * T;
  static constexpr uint32_t KV_RING = 4 * T;
  static constexpr uint32_t KV_LD = KV_RING + kBwdStages * 2 * T;
  static constexpr uint32_t KV_BAR = KV_LD + kBwdStages * 2 * kBT * 4;
  static constexpr size_t KV_SMEM = KV_BAR + 8 * (1 + 2 * kBwdStages) + 1024;
  // dQ: qs and dO of both consumers, the ring of (k, v) stages, then the
  // mbarriers (qs / dO full, per stage full, per stage empty)
  static constexpr uint32_t Q_Q = 0;
  static constexpr uint32_t Q_DO = 2 * T;
  static constexpr uint32_t Q_RING = 4 * T;
  static constexpr uint32_t Q_BAR = Q_RING + kBwdStages * 2 * T;
  static constexpr size_t Q_SMEM = Q_BAR + 8 * (1 + 2 * kBwdStages) + 1024;
};

// Descriptor of the k16 step kk of a kBT-row tile at `tile` read K-major
// (contracting over its HD columns) ...
template <int HD>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  using P = Plan<HD>;
  return smem_desc(tile + (kk * 16 / P::PW) * kBT * P::ROWB +
                       (kk * 16 % P::PW) * 2,
                   16, 8 * P::ROWB, P::MODE);
}

// ... and read MN-major as B (contracting over its rows 16kk..16kk+15).
template <int HD>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  using P = Plan<HD>;
  return smem_desc(tile + kk * 16 * P::ROWB, kBT * P::ROWB, 8 * P::ROWB,
                   P::MODE);
}

// d (64 x 64, f32) = a . b^T over HD, a and b kBT-row tiles (SS).
template <int HD>
__device__ __forceinline__ void mma_tiles(float (&d)[32], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    if (kk == 0)
      wgmma_ss<false>(d, desc_kmajor<HD>(a, kk), desc_kmajor<HD>(b, kk));
    else
      wgmma_ss<true>(d, desc_kmajor<HD>(a, kk), desc_kmajor<HD>(b, kk));
  }
}

// d (64 x HD, f32) += a . b, a the bf16 A fragments of a 64 x 64 operand
// (four k16 steps), b a kBT-row tile (RS, b MN-major).
template <int HD>
__device__ __forceinline__ void mma_frags(float (&d)[HD / 2],
                                          const uint32_t (&a)[4][4],
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<true>(d, a[kk], desc_mnmajor<HD>(b, kk));
}

// Fragment i of a 64 x 64 accumulator lies at row 16w + g + 8 * (i >> 1 & 1)
// and column 8 * (i / 4) + 2 * qd + (i & 1) of the warpgroup's tile; the
// pair (8kk + 2r, 8kk + 2r + 1) is the A fragment r of k16 step kk.
__device__ __forceinline__ void pack_frags(const float (&x)[32], int kk,
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// dK / dV consumer: P^T and dS^T of a (64 keys x 64 rows) tile in place of
// the S^T and dP^T fragments, rounded into the A fragments of dV += P^T dO
// (pa) and dK += dS^T qs (dsa).  lse_s and d_s hold the tile's rows; the
// thread's keys are key0 and key0 + 8; r is the tile's first row.
__device__ __forceinline__ void scores_t(float (&st)[32], float (&dpt)[32],
                                         uint32_t (&pa)[4][4],
                                         uint32_t (&dsa)[4][4],
                                         const float* lse_s, const float* d_s,
                                         bool mask, int key0, int r, int LG,
                                         int G, int S, int causal, int qd) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * kk + h;
      const int col = 8 * j + 2 * qd;
      const float2 l = *reinterpret_cast<const float2*>(lse_s + col);
      const float2 dd = *reinterpret_cast<const float2*>(d_s + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        float p = expf(st[i] - ((e & 1) ? l.y : l.x));
        float ds = p * (dpt[i] - ((e & 1) ? dd.y : dd.x));
        if (mask) {
          const int row = r + col + (e & 1);
          const int key = key0 + ((e & 2) ? 8 : 0);
          if (!(row < LG && key < S &&
                (!causal || row >= static_cast<int64_t>(key) * G)))
            p = ds = 0.f;
        }
        st[i] = p;
        dpt[i] = ds;
      }
    }
    pack_frags(st, kk, pa);
    pack_frags(dpt, kk, dsa);
  }
}

// dQ consumer: dS of a (64 rows x 64 keys from j0) tile in place of the dP
// fragments, rounded into the A fragments of dQ += dS k (dsa).  The
// thread's rows have lse l0 / l1 and D d0 / d1.
__device__ __forceinline__ void scores(const float (&s)[32], float (&dp)[32],
                                       uint32_t (&dsa)[4][4], float l0,
                                       float l1, float d0, float d1,
                                       bool mask, int j0, int row0, int G,
                                       int S, int causal, int qd) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int e8 = 0; e8 < 8; ++e8) {
      const int i = 8 * kk + e8;
      const bool hi = i & 2;
      const float p = expf(s[i] - (hi ? l1 : l0));
      float ds = p * (dp[i] - (hi ? d1 : d0));
      if (mask) {
        const int key = j0 + 8 * (i / 4) + 2 * qd + (i & 1);
        const int row = row0 + (hi ? 8 : 0);
        if (!(key < S && (!causal || row >= static_cast<int64_t>(key) * G)))
          ds = 0.f;
      }
      dp[i] = ds;
    }
    pack_frags(dp, kk, dsa);
  }
}

// D = rowsum(dO * O) and qs = q * scale rounded to bf16 (into dq's buffer):
// thread t takes the 16-byte word t, HD / 8 threads a row.
template <int HD>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_prep_bf16(const uint4* __restrict__ q,
                        const uint4* __restrict__ o,
                        const uint4* __restrict__ dout,
                        uint4* __restrict__ qs, float* __restrict__ delta,
                        int64_t rows, float scale) {
  constexpr int kWords = HD / 8;   // words a row: 2..16, within a warp
  const int64_t wd = static_cast<int64_t>(blockIdx.x) * kBwdThreads +
                     threadIdx.x;
  const int64_t row = wd / kWords;
  const bool in = row < rows;      // a row's words are all in or all out
  float acc = 0.f;
  if (in) {
    const uint4 a = o[wd], b = dout[wd];
    uint4 x = q[wd];
    const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&b);
    __nv_bfloat162* hx = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 fa = __bfloat1622float2(ha[j]);
      const float2 fb = __bfloat1622float2(hb[j]);
      acc = fmaf(fa.x, fb.x, acc);
      acc = fmaf(fa.y, fb.y, acc);
      const float2 fx = __bfloat1622float2(hx[j]);
      hx[j] = __floats2bfloat162_rn(__fmul_rn(fx.x, scale),
                                    __fmul_rn(fx.y, scale));
    }
    qs[wd] = x;
  }
#pragma unroll
  for (int m = kWords / 2; m > 0; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (in && wd % kWords == 0) delta[row] = acc;
}

template <int HD>
__global__ void __launch_bounds__(kThreadsBf16, 1)
    flash_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int LG, int G, int S,
                        int causal) {
  using B = BwdTC<HD>;
  using P = Plan<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t kv_full = base + B::KV_BAR;
  auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8 * (1 + kBwdStages + s); };

  // key tile 0 (the most rows under the causal mask) first; the rows that
  // can see a key of the tile start at position j0
  const int bh = blockIdx.x;
  const int j0 = blockIdx.y * kConsumers * kBT;
  const int64_t first64 = causal ? static_cast<int64_t>(j0) * G : 0;
  const int first = first64 < LG ? static_cast<int>(first64) : LG;
  const int n_tiles = (LG - first + kBT - 1) / kBT;
  const int wg = threadIdx.x / kWG;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full(s), 1 + 32);   // the copies' thread, warp 1's lanes
      mbar_init(empty(s), kConsumers * 4);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: k and v once, then the (qs, dO) ring; warp 1 stages
    // each row tile's lse and D (zeros past L*G)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 4 * B::T);
      for (int c = 0; c < kConsumers; ++c)
        for (int p = 0; p < P::NP; ++p) {
          tma_load(base + B::KV_K + c * B::T + p * kBT * P::ROWB, &tk,
                   kv_full, p * P::PW, j0 + c * kBT, bh);
          tma_load(base + B::KV_V + c * B::T + p * kBT * P::ROWB, &tv,
                   kv_full, p * P::PW, j0 + c * kBT, bh);
        }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kBwdStages;
        if (t >= kBwdStages) mbar_wait(empty(s), ((t / kBwdStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * B::T);
        const uint32_t stage = base + B::KV_RING + s * 2 * B::T;
        for (int p = 0; p < P::NP; ++p) {
          tma_load(stage + p * kBT * P::ROWB, &tq, full(s), p * P::PW,
                   first + t * kBT, bh);
          tma_load(stage + B::T + p * kBT * P::ROWB, &tdo, full(s),
                   p * P::PW, first + t * kBT, bh);
        }
      }
    } else if (threadIdx.x / 32 == 1) {
      const int lane = threadIdx.x & 31;
      const float* lb = lse + static_cast<int64_t>(bh) * LG;
      const float* db = delta + static_cast<int64_t>(bh) * LG;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kBwdStages;
        if (t >= kBwdStages) mbar_wait(empty(s), ((t / kBwdStages) & 1) ^ 1);
        float* ld = reinterpret_cast<float*>(smem + B::KV_LD + s * 2 * kBT * 4);
        for (int h = 0; h < kBT; h += 32) {
          const int row = first + t * kBT + lane + h;
          ld[lane + h] = row < LG ? lb[row] : 0.f;
          ld[kBT + lane + h] = row < LG ? db[row] : 0.f;
        }
        mbar_arrive(full(s));
      }
    }
  } else {
    // ---- consumers: 64 keys each, every row tile of the block
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    constexpr int NO = HD / 2;    // dK or dV fragment floats a thread
    const int c = wg - 1;
    const int tid = threadIdx.x - wg * kWG;
    const int w = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
    const int key_first = j0 + c * kBT;
    const int key0 = key_first + 16 * w + g, key1 = key0 + 8;
    const uint32_t k_tile = base + B::KV_K + c * B::T;
    const uint32_t v_tile = base + B::KV_V + c * B::T;

    float dk_acc[NO], dv_acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(kv_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kBwdStages;
      const int r = first + t * kBT;
      const uint32_t q_tile = base + B::KV_RING + s * 2 * B::T;
      const uint32_t do_tile = q_tile + B::T;
      const float* ld =
          reinterpret_cast<const float*>(smem + B::KV_LD + s * 2 * kBT * 4);
      mbar_wait(full(s), (t / kBwdStages) & 1);

      // S^T = k . qs^T and dP^T = v . dO^T
      float st[32], dpt[32];
      wgmma_fence();
      mma_tiles<HD>(st, k_tile, q_tile);
      mma_tiles<HD>(dpt, v_tile, do_tile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T; the mask only where the tile crosses the diagonal
      // or runs past L*G or S
      const bool mask =
          r + kBT > LG || key_first + kBT > S ||
          (causal && static_cast<int64_t>(key_first + kBT - 1) * G > r);
      uint32_t pa[4][4], dsa[4][4];
      scores_t(st, dpt, pa, dsa, ld, ld + kBT, mask, key0, r, LG, G, S,
               causal, qd);

      // dV += P^T dO and dK += dS^T qs
      wgmma_fence();
      mma_frags<HD>(dv_acc, pa, do_tile);
      mma_frags<HD>(dk_acc, dsa, q_tile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));   // one arrival a warp
    }

    __nv_bfloat16* dkb = dk + static_cast<int64_t>(bh) * S * HD;
    __nv_bfloat16* dvb = dv + static_cast<int64_t>(bh) * S * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * qd;
      if (key0 < S) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + int64_t{key0} * HD + col) =
            __floats2bfloat162_rn(dk_acc[4 * j], dk_acc[4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dvb + int64_t{key0} * HD + col) =
            __floats2bfloat162_rn(dv_acc[4 * j], dv_acc[4 * j + 1]);
      }
      if (key1 < S) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + int64_t{key1} * HD + col) =
            __floats2bfloat162_rn(dk_acc[4 * j + 2], dk_acc[4 * j + 3]);
        *reinterpret_cast<__nv_bfloat162*>(dvb + int64_t{key1} * HD + col) =
            __floats2bfloat162_rn(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreadsBf16, 1)
    flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int LG, int G, int S,
                      int causal, float scale) {
  using B = BwdTC<HD>;
  using P = Plan<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_full = base + B::Q_BAR;
  auto full = [&](int s) { return q_full + 8 * (1 + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + kBwdStages + s); };

  // the last row tile (most keys under the causal mask) first
  const int bh = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kConsumers * kBT;
  const int last_row = min(r0 + kConsumers * kBT, LG) - 1;
  const int n_keys = causal ? min(S, last_row / G + 1) : S;
  const int n_tiles = (n_keys + kBT - 1) / kBT;
  const int wg = threadIdx.x / kWG;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * 4);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: qs and dO once (rows past L*G read as zeros), then
    // the (k, v) ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 4 * B::T);
      for (int c = 0; c < kConsumers; ++c)
        for (int p = 0; p < P::NP; ++p) {
          tma_load(base + B::Q_Q + c * B::T + p * kBT * P::ROWB, &tq, q_full,
                   p * P::PW, r0 + c * kBT, bh);
          tma_load(base + B::Q_DO + c * B::T + p * kBT * P::ROWB, &tdo,
                   q_full, p * P::PW, r0 + c * kBT, bh);
        }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kBwdStages;
        if (t >= kBwdStages) mbar_wait(empty(s), ((t / kBwdStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * B::T);
        const uint32_t stage = base + B::Q_RING + s * 2 * B::T;
        for (int p = 0; p < P::NP; ++p) {
          tma_load(stage + p * kBT * P::ROWB, &tk, full(s), p * P::PW,
                   t * kBT, bh);
          tma_load(stage + B::T + p * kBT * P::ROWB, &tv, full(s), p * P::PW,
                   t * kBT, bh);
        }
      }
    }
  } else {
    // ---- consumers: 64 rows each, every key tile of the block
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    constexpr int NO = HD / 2;    // dQ fragment floats a thread
    const int c = wg - 1;
    const int tid = threadIdx.x - wg * kWG;
    const int w = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
    const int rw = r0 + c * kBT;                          // first row
    const int row0 = rw + 16 * w + g, row1 = row0 + 8;    // this thread's
    const uint32_t q_tile = base + B::Q_Q + c * B::T;
    const uint32_t do_tile = base + B::Q_DO + c * B::T;
    const float* lb = lse + static_cast<int64_t>(bh) * LG;
    const float* db = delta + static_cast<int64_t>(bh) * LG;
    const float l0 = row0 < LG ? lb[row0] : 0.f;
    const float l1 = row1 < LG ? lb[row1] : 0.f;
    const float d0 = row0 < LG ? db[row0] : 0.f;
    const float d1 = row1 < LG ? db[row1] : 0.f;

    float dq_acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) dq_acc[i] = 0.f;
    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kBwdStages;
      const int j0 = t * kBT;
      const uint32_t k_tile = base + B::Q_RING + s * 2 * B::T;
      const uint32_t v_tile = k_tile + B::T;
      mbar_wait(full(s), (t / kBwdStages) & 1);

      // S = qs . k^T and dP = dO . v^T
      float sacc[32], dp[32];
      wgmma_fence();
      mma_tiles<HD>(sacc, q_tile, k_tile);
      mma_tiles<HD>(dp, do_tile, v_tile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sacc);
      fence_regs(dp);

      const bool mask = j0 + kBT > S ||
                        (causal && static_cast<int64_t>(j0 + kBT - 1) * G > rw);
      uint32_t dsa[4][4];
      scores(sacc, dp, dsa, l0, l1, d0, d1, mask, j0, row0, G, S, causal, qd);

      // dQ += dS k
      wgmma_fence();
      mma_frags<HD>(dq_acc, dsa, k_tile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));   // one arrival a warp
    }

    __nv_bfloat16* qb = dq + static_cast<int64_t>(bh) * LG * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * qd;
      if (row0 < LG)
        *reinterpret_cast<__nv_bfloat162*>(qb + int64_t{row0} * HD + col) =
            __floats2bfloat162_rn(__fmul_rn(dq_acc[4 * j], scale),
                                  __fmul_rn(dq_acc[4 * j + 1], scale));
      if (row1 < LG)
        *reinterpret_cast<__nv_bfloat162*>(qb + int64_t{row1} * HD + col) =
            __floats2bfloat162_rn(__fmul_rn(dq_acc[4 * j + 2], scale),
                                  __fmul_rn(dq_acc[4 * j + 3], scale));
    }
  }
}

// ---- launchers --------------------------------------------------------------

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int64_t BH, int64_t L, int64_t G, int64_t S,
               int causal, float scale, void* stream) {
  constexpr size_t smem = smem_bytes_f32<HD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((L * G + kRows - 1) / kRows),
                  static_cast<unsigned>(BH));
  flash_kernel_f32<HD><<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), L, G, S, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map (hd, rows, BH) of a contiguous bf16 tensor, boxes of
// (PW, box_rows, 1); reads past `rows` fill with zeros.
template <int HD>
bool tensor_map(CUtensorMap* map, const void* ptr, int64_t rows, int64_t BH,
                uint32_t box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(HD) * 2,
                                 static_cast<cuuint64_t>(rows) * HD * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(Plan<HD>::PW), box_rows,
                             1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, Plan<HD>::SWIZZLE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int64_t BH, int64_t L, int64_t G, int64_t S,
                int causal, float scale, void* stream) {
  constexpr size_t smem = Plan<HD>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tq, tk, tv;
  if (!tensor_map<HD>(&tq, q, L * G, BH, kBM) ||
      !tensor_map<HD>(&tk, k, S, BH, kBN) ||
      !tensor_map<HD>(&tv, v, S, BH, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(BH),
                  static_cast<unsigned>((L * G + kBlockRows - 1) / kBlockRows));
  flash_kernel_bf16<HD><<<grid, kThreadsBf16, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      static_cast<int>(L * G),
      static_cast<int>(G), static_cast<int>(S), causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// float32 backward: D, then dK / dV, then dQ, on the caller's stream;
// `delta` is (BH, L*G) float32 scratch the wrapper allocates.
template <int HD>
int launch_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* delta, void* dq,
                   void* dk, void* dv, int64_t BH, int64_t L, int64_t G,
                   int64_t S, int causal, float scale, void* stream) {
  constexpr size_t smem = BwdPlan<HD>::SMEM;
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(flash_bwd_dq_f32<HD>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t LG = L * G;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  const float* fl = static_cast<const float*>(lse);
  float* fd = static_cast<float*>(delta);
  constexpr int kRowsPerBlock = kBwdThreads / 32;
  flash_bwd_delta_f32<HD><<<static_cast<unsigned>(
                                (BH * LG + kRowsPerBlock - 1) / kRowsPerBlock),
                            kBwdThreads, 0, st>>>(
      static_cast<const float*>(o), tdo, fd, BH * LG);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_f32<HD><<<dim3(static_cast<unsigned>(BH),
                                static_cast<unsigned>((S + kBKb - 1) / kBKb)),
                           kBwdThreads, smem, st>>>(
      tq, tk, tv, tdo, fl, fd, static_cast<float*>(dk),
      static_cast<float*>(dv), L, G, S, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_f32<HD><<<dim3(static_cast<unsigned>(BH),
                              static_cast<unsigned>((LG + kBR - 1) / kBR)),
                         kBwdThreads, smem, st>>>(
      tq, tk, tv, tdo, fl, fd, static_cast<float*>(dq), L, G, S, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16 backward: D and qs (into dq), then dK / dV, then dQ, on the
// caller's stream; the tensor maps are built before anything launches.
template <int HD>
int launch_bwd_bf16(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const void* lse,
                    void* delta, void* dq, void* dk, void* dv, int64_t BH,
                    int64_t L, int64_t G, int64_t S, int causal, float scale,
                    void* stream) {
  using B = BwdTC<HD>;
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(B::KV_SMEM));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(flash_bwd_dq_bf16<HD>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(B::Q_SMEM));
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int64_t LG = L * G;
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map<HD>(&tq, dq, LG, BH, kBT) ||
      !tensor_map<HD>(&tk, k, S, BH, kBT) ||
      !tensor_map<HD>(&tv, v, S, BH, kBT) ||
      !tensor_map<HD>(&tdo, dout, LG, BH, kBT))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fl = static_cast<const float*>(lse);
  float* fd = static_cast<float*>(delta);
  const int64_t words = BH * LG * (HD / 8);
  flash_bwd_prep_bf16<HD><<<static_cast<unsigned>(
                                (words + kBwdThreads - 1) / kBwdThreads),
                            kBwdThreads, 0, st>>>(
      static_cast<const uint4*>(q), static_cast<const uint4*>(o),
      static_cast<const uint4*>(dout), static_cast<uint4*>(dq), fd, BH * LG,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // a dK / dV block's keys, a dQ block's rows
  constexpr int kBlock = kConsumers * kBT;
  flash_bwd_dkdv_bf16<HD><<<dim3(static_cast<unsigned>(BH),
                                 static_cast<unsigned>((S + kBlock - 1) /
                                                       kBlock)),
                            kThreadsBf16, B::KV_SMEM, st>>>(
      tq, tk, tv, tdo, fl, fd, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), static_cast<int>(LG),
      static_cast<int>(G), static_cast<int>(S), causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_bf16<HD><<<dim3(static_cast<unsigned>(BH),
                               static_cast<unsigned>((LG + kBlock - 1) /
                                                     kBlock)),
                          kThreadsBf16, B::Q_SMEM, st>>>(
      tq, tk, tv, tdo, fl, fd, static_cast<__nv_bfloat16*>(dq),
      static_cast<int>(LG), static_cast<int>(G), static_cast<int>(S), causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// launch(std::integral_constant<int, hd>) for a head_dim the kernels are
// built for, else cudaErrorInvalidValue.
template <typename Launch>
int by_head_dim(int64_t hd, Launch&& launch) {
  switch (hd) {
    case 16:
      return launch(std::integral_constant<int, 16>{});
    case 32:
      return launch(std::integral_constant<int, 32>{});
    case 64:
      return launch(std::integral_constant<int, 64>{});
    case 128:
      return launch(std::integral_constant<int, 128>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace


// The serving entries write no log-sum-exp; the _lse entries also write
// each row's float32 lse (BH, L, G), with the same kernels, so `out` is the
// same bits.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int64_t BH,
                                   int64_t L, int64_t G, int64_t S,
                                   int64_t hd, int causal, float scale,
                                   void* stream) {
  return by_head_dim(hd, [&](auto HD) {
    return launch_f32<decltype(HD)::value>(q, k, v, o, nullptr, BH, L, G, S,
                                           causal, scale, stream);
  });
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int64_t BH,
                                    int64_t L, int64_t G, int64_t S,
                                    int64_t hd, int causal, float scale,
                                    void* stream) {
  return by_head_dim(hd, [&](auto HD) {
    return launch_bf16<decltype(HD)::value>(q, k, v, o, nullptr, BH, L, G, S,
                                            causal, scale, stream);
  });
}

extern "C" int flash_attention_lse_f32(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int64_t BH, int64_t L, int64_t G,
                                       int64_t S, int64_t hd, int causal,
                                       float scale, void* stream) {
  return by_head_dim(hd, [&](auto HD) {
    return launch_f32<decltype(HD)::value>(q, k, v, o, lse, BH, L, G, S,
                                           causal, scale, stream);
  });
}

extern "C" int flash_attention_lse_bf16(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int64_t BH, int64_t L, int64_t G,
                                        int64_t S, int64_t hd, int causal,
                                        float scale, void* stream) {
  return by_head_dim(hd, [&](auto HD) {
    return launch_bf16<decltype(HD)::value>(q, k, v, o, lse, BH, L, G, S,
                                            causal, scale, stream);
  });
}

// B7b: dq, dk, dv (in the input type) of out = attention(q, k, v) given
// dout, the forward's out and lse; `delta` is (BH, L*G) float32 scratch.
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int64_t BH, int64_t L, int64_t G, int64_t S, int64_t hd,
    int causal, float scale, void* stream) {
  return by_head_dim(hd, [&](auto HD) {
    return launch_bwd_f32<decltype(HD)::value>(
        q, k, v, o, dout, lse, delta, dq, dk, dv, BH, L, G, S, causal, scale,
        stream);
  });
}

extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int64_t BH, int64_t L, int64_t G, int64_t S, int64_t hd,
    int causal, float scale, void* stream) {
  return by_head_dim(hd, [&](auto HD) {
    return launch_bwd_bf16<decltype(HD)::value>(
        q, k, v, o, dout, lse, delta, dq, dk, dv, BH, L, G, S, causal, scale,
        stream);
  });
}
