// The second pass of split-K, shared by the matmul kernels (prefill_tile.cuh
// and the streaming kernels of stream_dequant.cuh and stream_w8a8.cuh):
// when the output tiles alone cannot fill the card, K is cut across
// blocks, each writing a partial, and this sums them in split order, so
// the result does not depend on block timing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace split_k {

// out[e, i] = sum over splits, in split order, of partial[e, z, i], for
// the (E, splits, mn) partials of E experts (E = 1: a dense linear);
// total = E * mn. out is f32, or bf16 with out_bf16 (the f32 sum rounded
// once, to nearest even)
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  void* __restrict__ out, size_t mn,
                                  int splits, size_t total, int out_bf16) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float* p = partial + (i / mn) * splits * mn + i % mn;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += p[(size_t)z * mn];
  if (out_bf16)
    ((__nv_bfloat16*)out)[i] = __float2bfloat16_rn(s);
  else
    ((float*)out)[i] = s;
}

inline void sum_splits(const float* partial, void* out, size_t mn,
                       int splits, int experts, int out_bf16,
                       cudaStream_t st) {
  const size_t total = (size_t)experts * mn;
  sum_splits_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      partial, out, mn, splits, total, out_bf16);
}

// The second pass of a per-channel int8 launch split over K: out[e, c, n]
// = f32(sum over splits, in int32, of partial[e, z, c, n]) * scale[e, 0,
// n], for the (E, splits, C, N) partials holding exact int32 sums in
// their bits; total = E * C * N. The f32 conversion and one multiply are
// the plain version's, so the result is its bits however K was split.
__global__ void sum_int_splits_kernel(const int* __restrict__ partial,
                                      const float* __restrict__ scale,
                                      float* __restrict__ out, int C, int N,
                                      int splits, size_t total) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const size_t cn = (size_t)C * N, e = i / cn, r = i % cn;
  const int* p = partial + e * splits * cn + r;
  unsigned s = 0;  // wraps as the tensor cores' sums do
  for (int z = 0; z < splits; ++z) s += (unsigned)p[(size_t)z * cn];
  out[i] = (float)(int)s * scale[e * N + r % N];
}

inline void sum_int_splits(const float* partial, const float* scale,
                           float* out, int C, int N, int splits, int experts,
                           cudaStream_t st) {
  const size_t total = (size_t)experts * C * N;
  sum_int_splits_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      reinterpret_cast<const int*>(partial), scale, out, C, N, splits,
      total);
}

}  // namespace split_k
