// The flat word grid shared by halo_pack.cu (pack, unpack_add) and
// halo_signal.cu (put_signal): one thread per output word of the whole
// launch, in blocks of kThreads, with 32-bit index arithmetic.
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
