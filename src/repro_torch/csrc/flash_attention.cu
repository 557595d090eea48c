// Flash attention (causal or full, grouped-query) for Hopper (sm_90a),
// float32 and bfloat16, head_dim 16, 32, 64 or 128.
//
// Replaces the TPU kernel of the JAX package:
//   flash_attention_*  <- src/repro/kernels/flash_attention.py:76
//                         flash_attention (_flash_kernel, l.25)
//
// Layout as the reference: q (BH, L, G, hd), k and v (BH, S, hd), output
// (BH, L, G, hd) in q's dtype; BH = batch * kv heads, G = q heads per kv
// head.  Per bh the query is an (L*G, hd) matrix whose row r is position
// r / G, so one block takes kRows consecutive rows whatever G is.
//
// What it computes is _flash_kernel's contraction, not its TPU grid: one
// block per (bh, tile of kRows query rows); a loop over kv tiles of kBK
// keys in order from key 0, each staged in shared memory; the running max,
// denominator and accumulator of every row in registers, in float32.  The
// rounding points are the reference's: q is scaled in float32 and rounded
// to the input dtype before the q.k dot; logits accumulate in float32;
// p = exp(logit - m_new) is rounded to v's dtype before the p.v dot, whose
// sum (float32) is added to acc * corr; l = l * corr + sum(p) unrounded;
// the output is acc / max(l, 1e-30) by true division, written once.  A
// masked logit is the reference's NEG_INF = -1e30, never -inf (a row
// whose tile is all masked would give -inf - -inf = NaN).  Keys past S (a
// ragged last tile) are -inf, so p = 0 exactly; they never enter the max.
// Tiles wholly above the diagonal are not loaded (the block's key range
// ends at its last row's position), and a warp skips a loaded tile whose
// first key lies past all of its rows' positions, which changes nothing:
// there m_new = m, corr = 1 and every p = 0.  The kv blocking differs from
// the plain form's (kBK = 64 against bk = 256), so the per-tile maxima and
// hence the rounding of p differ: results agree to a tolerance, not bits.
//
// What bounds it.  At the serve shape of qwen3-1.7b (batch 4 x 8 kv heads
// = BH 32, L = S = 1024, G = 2, hd = 128, bf16) one launch does
// 4 * BH * G * hd * L(L+1)/2 = 1.72e10 operations and moves q, k, v and o
// once, 50.3 MB: 17.4 us at the tensor cores' 989 TFLOP/s (bf16) against
// 15.0 us at 3.35 TB/s, so it is bound by operations.  This first kernel
// does its products as float32 FMAs on the CUDA cores, whose 67 TFLOP/s
// alone put the floor at 257 us, ~15x above that bound: the tensor-core
// path (mma.sync / wgmma with TMA-fed tiles) is a later change.  What the
// design does within that choice:
//   * each warp owns kRowsPerWarp rows: for q.k each lane takes two keys
//     of the tile and walks hd in float4 steps (q rows are broadcast
//     reads, k rows are padded by 4 floats so a quarter-warp's 16-byte
//     loads hit distinct banks); for p.v each lane owns hd / 32 columns
//     and reads p four keys at a time, so the inner loops issue one
//     shared-memory load per ~5 FMAs;
//   * row max and row sum are warp shuffles; nothing but the staged tiles
//     goes through shared memory, and nothing round-trips device memory;
//   * blocks are issued from the last row tile down, so the causal
//     blocks with the most keys start first and the tail is short.
//
// Kernels run on the caller's stream, allocate nothing and do not
// synchronise.  Each C entry point returns the launch's cudaError_t
// (cudaErrorInvalidValue for a head_dim it was not built for).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;   // query rows per block
constexpr int kBK = 64;                        // keys per staged tile
constexpr int kKeysPerLane = kBK / 32;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;              // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T (round to nearest even) and read back as float
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

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
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kRows) * HD +
                          static_cast<size_t>(kBK) * (HD + 4) +
                          static_cast<size_t>(kBK) * HD +
                          static_cast<size_t>(kRows) * kBK);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int64_t L,
                 int64_t G, int64_t S, int causal, float scale) {
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

  // q tile: scaled in float32, rounded to the input dtype (l.44-46)
  for (int e = tid; e < kRows * HD; e += kThreads) {
    const float x = r0 * HD + e < LG * HD ? to_f32(q[r0 * HD + e]) : 0.f;
    qs[e] = round_to<T>(__fmul_rn(x, scale));
  }

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
      ks[j * KS + e % HD] = in ? to_f32(k[j0 * HD + e]) : 0.f;
      vs[e] = in ? to_f32(v[j0 * HD + e]) : 0.f;
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

    // online softmax: mask, tile max, p rounded to v's dtype, l and corr
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
        pw[r * kBK + lane + 32 * c] = round_to<T>(p);
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
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      o[row * HD + lane + 32 * i] = from_f32<T>(acc[r][i] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int64_t BH,
           int64_t L, int64_t G, int64_t S, int causal, float scale,
           void* stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((L * G + kRows - 1) / kRows),
                  static_cast<unsigned>(BH));
  flash_kernel<T, HD><<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), L, G, S, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             int64_t BH, int64_t L, int64_t G, int64_t S, int64_t hd,
             int causal, float scale, void* stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, BH, L, G, S, causal, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, BH, L, G, S, causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, BH, L, G, S, causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, BH, L, G, S, causal, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int64_t BH,
                                   int64_t L, int64_t G, int64_t S,
                                   int64_t hd, int causal, float scale,
                                   void* stream) {
  return dispatch<float>(q, k, v, o, BH, L, G, S, hd, causal, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int64_t BH,
                                    int64_t L, int64_t G, int64_t S,
                                    int64_t hd, int causal, float scale,
                                    void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, BH, L, G, S, hd, causal, scale,
                                 stream);
}
