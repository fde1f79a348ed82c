// The body of int8 activations times low-bit packed weights on the int8
// tensor cores of Hopper (sm_90a), the W8A8 / W4A8 matmul of the dense
// kernel (w8a8_matmul.cu). It computes
//
//   out[m, n] = sum_g scale[g, n] * (sum_{k in group g} xq[m, k] * q[k, n])
//
// before the per-token activation rescale (the caller, kernels/ops.py,
// multiplies by it). xq is int8 (per-token quantized activations); q comes
// from the K-packed offset-binary bytes of core/quant/types.py (read by
// packing.cuh), so every unpacked value fits int8 for bits 2, 3, 4 and 8.
// Each inner sum over a scale group is exact in int32; it is rescaled by
// scale[g, n] in f32 and summed over groups in f32.
//
// What bounds it on this card. Decode (M = n_slots <= 8) does almost no
// arithmetic per weight byte and is bound by reading the packed weights:
// at W4 a 2048x8192 weight is 8 MiB, 2.5 us at 3.35 TB/s. Prefill (M in
// the hundreds) does 2*M*K*N int8
// operations on K*N*bits/8 weight bytes and is bound by the int8
// tensor-core rate (1979 TOP/s dense).
//
// What this first design does about it: it is the simple, right kernel.
// One block of 4 warps per 64x64 output tile walks a range of K in 32-row
// steps. Each thread loads 16 int8 activations of one row and unpacks 16 K
// rows of one weight column into shared memory (the W3 words included),
// and the warps multiply 16-deep slices with the tensor cores through WMMA
// (16x16x16, int8 operands, int32 accumulation). The weight tile is stored
// column-major and each 16-deep slice apart, so every fragment pointer
// stays 32-byte aligned. At the end of each scale group (a group must be a
// multiple of 16 rows; per-channel scales make one group of all of K) the
// warps spill their exact int32 sums to shared memory, and each thread
// rescales its 32 outputs (one column, so one scale load) into f32
// registers. Rows of M and columns of N past the edge, and K rows past the
// end, are masked to zero, so any M, K and N run. When the output tiles
// alone cannot fill the card (decode), the wrapper splits K across blocks
// in whole scale groups; each split writes an f32 partial and a second
// kernel sums the partials in split order, so the result does not depend
// on block timing (per-channel scales then rescale one exact int32 partial
// per split). Still far from the decode bound: most of each 64-row tile is padding at M <= 8, the weight
// bytes are read a byte at a time, and nothing overlaps one step's loads
// with the previous step's math (later work: wgmma, TMA, a pipelined ring
// of tiles).
#pragma once

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "packing.cuh"
#include "split_k.cuh"

namespace w8a8_mm {

using namespace nvcuda;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;        // K rows per step
constexpr int KS = 16;        // K rows per slice: one WMMA depth
constexpr int THREADS = 128;  // 4 warps in a 2x2 grid of 32x32 warp tiles
constexpr int OUT_PER_THREAD = BM * BN / THREADS;
constexpr int MAX_GRID_Z = 65535;
static_assert(THREADS == 2 * BN && THREADS == 2 * BM,
              "a thread owns one (row or column, slice) pair");

// the 16 signed values of K rows k .. k+15 of column n; rows at or past
// k_end are 0 (k is a multiple of 16, so packed groups start at k). The
// weight's rows start k0 K rows (whole packed groups) into qw
template <int BITS>
__device__ __forceinline__ void unpack16(const uint8_t* __restrict__ qw,
                                         int k0, int k, int n, int N,
                                         int k_end, int8_t* w) {
  using L = packing::Layout<BITS>;
#pragma unroll
  for (int j = 0; j < KS / (int)L::VALUES; ++j) {
    const int kk = k + j * L::VALUES;
    const uint32_t word =
        kk < k_end ? packing::packed_word<BITS>(
                         qw, (unsigned)(k0 + kk) / L::VALUES, n, N)
                   : 0u;
#pragma unroll
    for (int i = 0; i < (int)L::VALUES; ++i)
      w[j * L::VALUES + i] =
          kk + i < k_end
              ? (int8_t)(packing::word_value<BITS>(word, i) - L::QMAX)
              : (int8_t)0;
  }
}

// the grid's z is the split
template <int BITS>
__global__ void __launch_bounds__(THREADS)
w8a8_matmul_kernel(const int8_t* __restrict__ xq,
                   const uint8_t* __restrict__ qw,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int M, int K, int N, int G, int splits, int k_per_split,
                   int vec_x) {
  // slice s of a step: xs[s] is (BM, KS) row-major, wt[s] is (KS, BN)
  // column-major (element (k, n) at n * KS + k)
  __shared__ __align__(32) int8_t xs[2][BM * KS];
  __shared__ __align__(32) int8_t wt[2][BN * KS];
  __shared__ __align__(32) int cs[BM * BN];

  // split z writes partial z of the (splits, M, N) workspace (with one
  // split: the (M, N) output)
  const int split = blockIdx.z;
  out += (size_t)blockIdx.z * M * N;

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;
  const int group = G > 1 ? K / G : K;  // K rows per scale group
  // this thread loads x row m0 + tl and weight column n0 + tl of slice ts,
  // and owns the f32 outputs (ts + 2j, tl) of the tile
  const int tl = threadIdx.x % BN;
  const int ts = threadIdx.x / BN;
  const int gm = m0 + tl;
  const int gn = n0 + tl;

  float acc[OUT_PER_THREAD];
#pragma unroll
  for (int j = 0; j < OUT_PER_THREAD; ++j) acc[j] = 0.0f;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> iacc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(iacc[i][j], 0);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    const int ks = k0 + KS * ts;
    __align__(16) int8_t xv[KS];
    if (gm < M && vec_x && ks + KS <= k_end) {
      *reinterpret_cast<int4*>(xv) =
          *reinterpret_cast<const int4*>(xq + (size_t)gm * K + ks);
    } else {
#pragma unroll
      for (int i = 0; i < KS; ++i)
        xv[i] = (gm < M && ks + i < k_end)
                    ? xq[(size_t)gm * K + ks + i]
                    : (int8_t)0;
    }
    __align__(16) int8_t wv[KS];
    unpack16<BITS>(qw, 0, ks, gn, N, gn < N ? k_end : 0, wv);
    *reinterpret_cast<int4*>(&xs[ts][tl * KS]) =
        *reinterpret_cast<const int4*>(xv);
    *reinterpret_cast<int4*>(&wt[ts][tl * KS]) =
        *reinterpret_cast<const int4*>(wv);
    __syncthreads();
    for (int s = 0; s < 2; ++s) {
      const int kslice = k0 + KS * s;
      if (kslice >= k_end) break;  // the same for every thread
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                     wmma::col_major> b[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs[s] + (wm + 16 * i) * KS, KS);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], wt[s] + (wn + 16 * j) * KS, KS);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(iacc[i][j], a[i], b[j], iacc[i][j]);
      const int done = kslice + KS;
      if (done >= k_end || done % group == 0) {
        // end of a scale group (or of this split): rescale the exact
        // int32 sums into the f32 accumulators
        for (int i = 0; i < 2; ++i)
          for (int j = 0; j < 2; ++j) {
            wmma::store_matrix_sync(cs + (wm + 16 * i) * BN + wn + 16 * j,
                                    iacc[i][j], BN, wmma::mem_row_major);
            wmma::fill_fragment(iacc[i][j], 0);
          }
        __syncthreads();
        const float sc =
            gn < N ? scale[(size_t)(kslice / group) * N + gn]
                   : 0.0f;
#pragma unroll
        for (int j = 0; j < OUT_PER_THREAD; ++j)
          acc[j] += (float)cs[(ts + 2 * j) * BN + tl] * sc;
        __syncthreads();
      }
    }
    __syncthreads();
  }

  if (gn < N) {
#pragma unroll
    for (int j = 0; j < OUT_PER_THREAD; ++j) {
      const int r = m0 + ts + 2 * j;
      if (r < M) out[(size_t)r * N + gn] = acc[j];
    }
  }
}

// xq (M, K) int8, qw (packed_rows(K), N) uint8, scale (G, N) f32 -> out
// (M, N) f32, all contiguous on the current device. A scale group (K / G
// rows, or all of K when G == 1) must be a multiple of 16 rows. With
// splits > 1, K is cut into ranges of k_per_split rows (a multiple of 32,
// and of the group when G > 1) and workspace holds splits x M x N f32
// partials. vec_x: xq's rows may be read 16 bytes at a time (K % 16 == 0
// and xq 16-byte aligned). Returns the CUDA error code of the launches (0
// on success).
inline int launch(const void* xq, const void* qw, const void* scale,
                  void* out, void* workspace, int M, int K, int N, int G,
                  int bits, int splits, int k_per_split, int vec_x,
                  void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || splits <= 0 ||
      splits > MAX_GRID_Z || (long long)M + K + 8 + G > INT32_MAX ||
      K % G != 0 ||
      k_per_split % BK != 0 || (long long)splits * k_per_split < K ||
      (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  if (G > 1 && ((K / G) % KS != 0 || k_per_split % (K / G) != 0))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  const cudaStream_t st = (cudaStream_t)stream;
  const int8_t* xp = (const int8_t*)xq;
  const uint8_t* qp = (const uint8_t*)qw;
  const float* sp = (const float*)scale;
  float* dst = splits > 1 ? (float*)workspace : (float*)out;
  switch (bits) {
    case 2:
      w8a8_matmul_kernel<2><<<grid, THREADS, 0, st>>>(xp, qp, sp, dst, M, K, N, G, splits, k_per_split, vec_x);
      break;
    case 3:
      w8a8_matmul_kernel<3><<<grid, THREADS, 0, st>>>(xp, qp, sp, dst, M, K, N, G, splits, k_per_split, vec_x);
      break;
    case 4:
      w8a8_matmul_kernel<4><<<grid, THREADS, 0, st>>>(xp, qp, sp, dst, M, K, N, G, splits, k_per_split, vec_x);
      break;
    case 8:
      w8a8_matmul_kernel<8><<<grid, THREADS, 0, st>>>(xp, qp, sp, dst, M, K, N, G, splits, k_per_split, vec_x);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (splits > 1)
    split_k::sum_splits(dst, (float*)out, (size_t)M * N, splits, 1, st);
  return (int)cudaGetLastError();
}

}  // namespace w8a8_mm
