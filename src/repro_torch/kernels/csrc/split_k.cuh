// The second pass of split-K, shared by the matmul kernels
// (dequant_matmul.cuh, w8a8_matmul.cuh): when the output tiles alone
// cannot fill the card, K is cut across blocks, each writing an f32
// partial, and this sums them in split order, so the result does not
// depend on block timing.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace split_k {

// out[e, i] = sum over splits, in split order, of partial[e, z, i], for
// the (E, splits, mn) partials of E experts (E = 1: a dense linear);
// total = E * mn
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, size_t mn,
                                  int splits, size_t total) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float* p = partial + (i / mn) * splits * mn + i % mn;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += p[(size_t)z * mn];
  out[i] = s;
}

inline void sum_splits(const float* partial, float* out, size_t mn,
                       int splits, int experts, cudaStream_t st) {
  const size_t total = (size_t)experts * mn;
  sum_splits_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      partial, out, mn, splits, total);
}

}  // namespace split_k
