// The packed weight layout of core/quant/types.py, read on the card by
// every kernel that takes packed weights (dequant_matmul.cu,
// w8a8_matmul.cu).
//
// A (K, N) weight of BITS-bit codes is packed along K: packed group r of
// column n holds K rows r * VALUES .. r * VALUES + VALUES - 1, value i in
// bits [BITS * i, BITS * (i + 1)) of the group's little-endian word. A group
// is one byte for bits 2, 4 and 8 (4, 2 and 1 values) and three bytes for
// bits 3 (8 values, 0.375 bytes a value); its byte b of column n lies at
// row r * BYTES + b of the (packed_rows(K), N) uint8 array. A value v is
// stored offset-binary, as v + QMAX, so it is never negative.
#pragma once

#include <stdint.h>

namespace packing {

template <int BITS>
struct Layout {
  static_assert(BITS == 2 || BITS == 3 || BITS == 4 || BITS == 8,
                "packed widths are 2, 3, 4 and 8 bits");
  static constexpr int QMAX = (1 << (BITS - 1)) - 1;
  static constexpr unsigned VALUES = BITS == 3 ? 8 : 8 / BITS;
  static constexpr unsigned BYTES = BITS == 3 ? 3 : 1;
  static constexpr uint32_t MASK = (1u << BITS) - 1;
};

// packed group r of column n as one word
template <int BITS>
__device__ __forceinline__ uint32_t packed_word(const uint8_t* __restrict__ qw,
                                                unsigned r, int n, int N) {
  const size_t row = (size_t)r * Layout<BITS>::BYTES;
  uint32_t word = qw[row * N + n];
  if (BITS == 3)
    word |= ((uint32_t)qw[(row + 1) * N + n] << 8) |
            ((uint32_t)qw[(row + 2) * N + n] << 16);
  return word;
}

// value i (of Layout::VALUES) of a packed group's word, offset-binary
template <int BITS>
__device__ __forceinline__ int word_value(uint32_t word, unsigned i) {
  return (int)((word >> (BITS * i)) & Layout<BITS>::MASK);
}

// offset-binary value of K row k, column n
template <int BITS>
__device__ __forceinline__ int packed_value(const uint8_t* __restrict__ qw,
                                            int k, int n, int N) {
  using L = Layout<BITS>;
  return word_value<BITS>(packed_word<BITS>(qw, (unsigned)k / L::VALUES, n, N),
                          (unsigned)k % L::VALUES);
}

}  // namespace packing
