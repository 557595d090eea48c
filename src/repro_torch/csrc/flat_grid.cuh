// The flat word grid shared by halo_pack.cu (pack, its converting form,
// unpack_add) and halo_signal.cu (put_signal, its converting form,
// fused_pulses): one thread per output word of the whole launch, in
// blocks of kThreads, with 32-bit index arithmetic.
#pragma once

#include <cstdint>
#include <initializer_list>

constexpr int kThreads = 256;

// the widest word (16, 8 or the element's bytes) that divides the row and
// every base pointer
inline int word_bytes(int64_t row_bytes, int elem,
                      std::initializer_list<const void*> bases) {
  for (int w = 16; w > elem; w /= 2) {
    bool ok = row_bytes % w == 0;
    for (const void* p : bases)
      ok = ok && (reinterpret_cast<uintptr_t>(p) % w) == 0;
    if (ok) return w;
  }
  return elem;
}

// 32-bit index arithmetic covers a launch whose largest array holds
// `words` words, with room for the last block's overhang
inline bool fits_32(int64_t words) { return words + kThreads < 2147483647; }

inline unsigned flat_blocks(int64_t words) {
  return static_cast<unsigned>((words + kThreads - 1) / kThreads);
}

// N elements of T moved as one word, aligned to its size up to 16 bytes (a
// longer word is read as 16-byte loads)
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Lanes {
  T v[N];
};

// a converting kernel's elements a thread (S source, D wire): N wire
// elements make a 16- or 8-byte output word where F and the output base
// allow it, and the source base allows its N elements' 16-byte loads; else
// one element (never a 4-byte word of two 16-bit elements: the launches
// have no kernel for it)
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
