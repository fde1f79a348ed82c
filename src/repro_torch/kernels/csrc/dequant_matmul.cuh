// The body of the fused low-bit dequantize + matmul for Hopper (sm_90a),
// the dense kernel of dequant_matmul.cu. It computes
//
//   out[m, n] = sum_k bf16(x[m, k]) * bf16(q[k, n] * scale[g(k), n])
//
// accumulated in f32, where q comes from the K-packed offset-binary bytes
// of core/quant/types.py (read by packing.cuh), and g(k) = 0 per-channel
// (G == 1), else k / (K / G).
//
// What bounds it on this card. Prefill (M = B*S rows, in the hundreds)
// does 2*M*K*N operations on K*N*bits/8 weight bytes and is bound by the
// tensor cores' bf16 rate. Decode (M <= 8 slots) does almost no
// arithmetic per weight byte and is bound by reading the packed weight
// bytes: at W4 a 2048x8192 weight is 8 MiB, 2.5 us at 3.35 TB/s.
//
// What this first design does about it: it is the simple, right kernel.
// One block of 4 warps per 64x64 output tile walks a range of K in 32-row
// steps; each thread issues all its global loads for a step together (x
// values, packed bytes, scales), then rounds x to bf16 and unpacks and
// scales the weights into shared memory as bf16, and the warps multiply
// with the tensor cores through WMMA (16x16x16 bf16, f32 accumulation).
// Rows of M and columns of N past the edge, and K rows past the end, are
// masked to zero, so any M, K and N run. Each thread unpacks one column of the weight tile, so when a K
// step lies inside one scale group (per-channel scales, or a group size
// that is a multiple of 32) it loads one scale per step instead of one per
// element. That, and a launch bound of 4 resident blocks per SM (at most
// 128 registers a thread), keep 16 warps on each SM: with per-element
// scales and no bound the unpack's load arrays take 177-240 registers and
// leave 2 blocks per SM, which made prefill 4-5x slower. When the output
// tiles alone cannot fill the card (decode: M <= 8 gives N/64 blocks),
// the wrapper splits K across `splits` blocks per tile; each writes an f32
// partial and a second kernel sums the partials in split order, so the
// result does not depend on block timing. Still far from the decode
// bound: most of each 64-row tile is
// padding at M <= 8, and nothing overlaps one step's loads with the
// previous step's math (cp.async or TMA pipelining of the packed bytes is
// later work).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "packing.cuh"
#include "split_k.cuh"

namespace dequant_mm {

using namespace nvcuda;
using packing::packed_value;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;  // 4 warps in a 2x2 grid of 32x32 warp tiles
constexpr int MIN_BLOCKS = 4;  // resident blocks per SM the registers allow
static_assert(THREADS % BN == 0, "a thread's weight elements share a column");
constexpr int XS_LD = BK + 8;  // bf16 leading dims: multiples of 8, and
constexpr int WS_LD = BN + 8;  // row offsets stay 32-byte aligned for WMMA
constexpr int CS_LD = BN + 4;  // f32 leading dim: a multiple of 4
constexpr int MAX_GRID_Z = 65535;

// STEP_SCALE: every K step lies inside one scale group (G == 1, or K / G a
// multiple of BK), so a thread's scale is one load per step. The grid's z
// is the split.
template <int BITS, bool STEP_SCALE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
dequant_matmul_kernel(const float* __restrict__ x,
                      const uint8_t* __restrict__ qw,
                      const float* __restrict__ scale, float* __restrict__ out,
                      int M, int K, int N, int G, int splits,
                      int k_per_split) {
  using L = packing::Layout<BITS>;
  constexpr int QMAX = L::QMAX;
  constexpr int XPT = BM * BK / THREADS;  // x elements per thread per step
  constexpr int WPT = BK * BN / THREADS;  // weight elements per thread
  __shared__ __align__(32) __nv_bfloat16 xs[BM * XS_LD];
  __shared__ __align__(32) __nv_bfloat16 ws[BK * WS_LD];
  __shared__ __align__(32) float cs[BM * CS_LD];

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
  const int group = G > 1 ? K / G : K;
  // the one column of every weight element this thread unpacks
  const int gn_t = n0 + threadIdx.x % BN;
  const int kt = threadIdx.x / BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // issue every global load of this step before using any of them
    float xv[XPT];
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int gm = m0 + i / BK, gk = k0 + i % BK;
      xv[j] = (gm < M && gk < k_end) ? x[(size_t)gm * K + gk]
                                     : 0.0f;
    }
    int qv[WPT];
    float sv[STEP_SCALE ? 1 : WPT];
    if (STEP_SCALE)
      sv[0] = gn_t < N ? scale[(size_t)(k0 / group) * N + gn_t]
                       : 0.0f;
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int gk = k0 + kt + j * (THREADS / BN);
      const bool ok = gk < k_end && gn_t < N;
      qv[j] = ok ? packed_value<BITS>(qw, gk, gn_t, N)
                 : QMAX;  // QMAX -> 0
      if (!STEP_SCALE)
        sv[j] = ok ? scale[(size_t)(gk / group) * N + gn_t] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int i = threadIdx.x + j * THREADS;
      xs[(i / BK) * XS_LD + i % BK] = __float2bfloat16_rn(xv[j]);
    }
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int i = threadIdx.x + j * THREADS;
      ws[(i / BN) * WS_LD + i % BN] = __float2bfloat16_rn(
          (float)(qv[j] - QMAX) * sv[STEP_SCALE ? 0 : j]);
    }
    __syncthreads();
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs + (wm + 16 * i) * XS_LD + kk, XS_LD);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], ws + kk * WS_LD + wn + 16 * j, WS_LD);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm + 16 * i) * CS_LD + wn + 16 * j,
                              acc[i][j], CS_LD, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) out[(size_t)gm * N + gn] = cs[r * CS_LD + c];
  }
}

template <int BITS>
void launch_bits(bool step_scale, dim3 grid, cudaStream_t st, const float* x,
                 const uint8_t* qw, const float* scale, float* dst, int M,
                 int K, int N, int G, int splits, int k_per_split) {
  if (step_scale)
    dequant_matmul_kernel<BITS, true><<<grid, THREADS, 0, st>>>(
        x, qw, scale, dst, M, K, N, G, splits, k_per_split);
  else
    dequant_matmul_kernel<BITS, false><<<grid, THREADS, 0, st>>>(
        x, qw, scale, dst, M, K, N, G, splits, k_per_split);
}

// x (M, K) f32, qw (packed_rows(K), N) uint8, scale (G, N) f32 -> out
// (M, N) f32, all contiguous on the current device. With splits > 1, K is
// cut into ranges of k_per_split rows (a multiple of 32) and workspace
// holds splits x M x N f32 partials. Returns the CUDA error code of the
// launches (0 on success).
inline int launch(const void* x, const void* qw, const void* scale,
                  void* out, void* workspace, int M, int K, int N, int G,
                  int bits, int splits, int k_per_split, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || splits <= 0 ||
      splits > MAX_GRID_Z || (long long)M + K + 8 + G > INT32_MAX ||
      k_per_split % BK != 0 ||
      (long long)splits * k_per_split < K ||
      (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  const cudaStream_t st = (cudaStream_t)stream;
  const float* xp = (const float*)x;
  const uint8_t* qp = (const uint8_t*)qw;
  const float* sp = (const float*)scale;
  float* dst = splits > 1 ? (float*)workspace : (float*)out;
  const bool step_scale = G == 1 || (K / G) % BK == 0;
  switch (bits) {
    case 2:
      launch_bits<2>(step_scale, grid, st, xp, qp, sp, dst, M, K, N, G, splits, k_per_split);
      break;
    case 3:
      launch_bits<3>(step_scale, grid, st, xp, qp, sp, dst, M, K, N, G, splits, k_per_split);
      break;
    case 4:
      launch_bits<4>(step_scale, grid, st, xp, qp, sp, dst, M, K, N, G, splits, k_per_split);
      break;
    case 8:
      launch_bits<8>(step_scale, grid, st, xp, qp, sp, dst, M, K, N, G, splits, k_per_split);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (splits > 1)
    split_k::sum_splits(dst, (float*)out, (size_t)M * N, splits, 1, st);
  return (int)cudaGetLastError();
}

}  // namespace dequant_mm
