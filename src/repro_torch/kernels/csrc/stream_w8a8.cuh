// The weight-streaming int8 x packed-weight kernel (u8 x s8 products on
// the int8 tensor cores), built on expert_stream.cuh: kernel 5
// (expert_w8a8_matmul.cu) runs it over E experts, kernel 3
// (w8a8_matmul.cu) at decode over one dense linear as E = 1. Computes,
// for each e of E,
//
//   out[e, c, n] = sum_g scale[e, g, n] * (sum_{k in group g} xq[e, c, k] * (q[e, k, n] - QMAX))
//
// before the per-token activation rescale, each group's sum exact in
// int32 (a group is a whole number of 16-row K steps; per-channel scales
// make one group of all of K). The unpack is a byte transpose: the codes
// go to the tensor cores as they are stored, unsigned (u8 x s8
// products), so a lane only gathers its 4 K rows of a column into one
// word (four byte permutes for four columns), and the offset comes out
// afterwards: sum xq * (q - QMAX) = sum xq * q - QMAX * sum xq, where sum
// xq is one more mma of the x fragment against a tile of ones (its rows
// are the x sums of the lane's own capacity rows). Both sums are exact
// int32 (wrapping), so their difference is the exact group sum whenever
// that fits int32 (the wrapper's bound).
#pragma once

#include "expert_stream.cuh"

namespace expert_w8 {

using namespace expert_stream;

// take the offset out of a group's exact sums (acc_q: of xq * q, isum: of
// xq) and add them, rescaled by the lane's 8 column scales, to the f32
// accumulators; the sums restart at zero
template <int QMAX, int NT>
__device__ __forceinline__ void rescale(int acc_q[4][NT][4], int isum[NT][2],
                                        float acc[4][NT][4],
                                        const float sc[8]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // in unsigned arithmetic, which wraps as the tensor cores do
      const unsigned off = (unsigned)QMAX * (unsigned)isum[nt][h];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j][nt][h] +=
            (float)(int)((unsigned)acc_q[j][nt][h] - off) * sc[j];
        acc[j][nt][2 + h] +=
            (float)(int)((unsigned)acc_q[j][nt][2 + h] - off) * sc[4 + j];
        acc_q[j][nt][h] = acc_q[j][nt][2 + h] = 0;
      }
      isum[nt][h] = 0;
    }
  }
}

// GROUPED: G > 1, each group's exact sums rescaled where the group ends;
// per-channel scales (G == 1) rescale each split's one sum at its end
template <int BITS, int NT, bool GROUPED>
__global__ void __launch_bounds__(THREADS, min_blocks(NT))
expert_w8_kernel(const int8_t* __restrict__ xq,
                 const uint8_t* __restrict__ qw,
                 const float* __restrict__ scale, float* __restrict__ out,
                 int C, int K, int N, int G, int chunks, int splits,
                 int k_per_split, int srows, int aligned) {
  using L = packing::Layout<BITS>;
  using S = Stage<BITS>;
  constexpr int CC = 8 * NT;
  constexpr int XS = x_stride(1);
  extern __shared__ __align__(16) uint8_t smem[];

  const int chunk = blockIdx.x % chunks;
  const int n0 = blockIdx.x / chunks * BN;
  const int expert = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int c0 = chunk * CC;
  const int kb = split * k_per_split;
  const int ke = min(K, kb + k_per_split);
  const int n_stages = (ke - kb + KS - 1) / KS;
  const int group = K / G;
  const int packed_rows = (K + L::VALUES - 1) / L::VALUES * L::BYTES;
  const int stage = stage_bytes<BITS>(NT, 1, srows);
  const int live = min(NT, (C - c0 + 7) / 8);

  Tile tl;
  tl.qw = qw + (size_t)expert * packed_rows * N + n0;
  tl.x = reinterpret_cast<const uint8_t*>(xq + ((size_t)expert * C + c0) * K);
  tl.scale = reinterpret_cast<const uint8_t*>(scale + (size_t)expert * G * N
                                              + n0);
  tl.K = K; tl.N = N; tl.G = G; tl.C = C; tl.c0 = c0; tl.n0 = n0;
  tl.kb = kb; tl.x_bytes = 1; tl.cc = CC; tl.srows = srows;
  tl.packed_rows = packed_rows; tl.aligned = aligned != 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) fetch_stage<BITS>(tl, smem + s * stage, s);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int col = n0 + warp * WARP_COLS + 8 * g;
  // exact sums of the current group: of xq * q per tile, and of xq (the
  // same for both fragment rows: isum[nt][h] is capacity row 2t + h)
  int acc_q[4][NT][4];
  int isum[NT][2];
  float acc[4][NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    isum[nt][0] = isum[nt][1] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc_q[j][nt][i] = 0;
        acc[j][nt][i] = 0.0f;
      }
  }
  constexpr uint32_t ONES = 0x01010101u;
  // K steps a scale group spans (per-channel: never a second group)
  const int gsteps = G == 1 ? INT_MAX / 2 : group / 16;

  for (int it = 0; it < n_stages; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < n_stages)
      fetch_stage<BITS>(tl, smem + ((it + STAGES - 1) % STAGES) * stage,
                        it + STAGES - 1);
    cp_async_commit();

    const uint8_t* st = smem + (it % STAGES) * stage;
    const uint8_t* xs = st + S::BYTES;
    const float* ss = reinterpret_cast<const float*>(xs + CC * XS);
    const int k0 = kb + it * KS;
    // the stage's scale rows start at group k0 / group; a new group starts
    // every `gsteps` K steps, the first after `left` of this stage's
    int row = 0, left = gsteps - (k0 / 16) % gsteps;
    // every step runs, also past ke in the last stage (x is zero there),
    // so the compiler can run one step's loads under the last's math
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const int k = k0 + 16 * s;
      if (GROUPED && s > 0 && left == 0) {
        ++row;
        left = gsteps;
      }
      uint32_t P[2][4];
      load_planes<BITS>(st + s * S::ROWS16 * S::RS + warp * WARP_COLS + 8 * g,
                        t, P);
      // transpose the planes: u[h][j] holds K rows 4t .. 4t + 3 of column
      // 8g + 4h + j, the lane's A fragment word for fragment row g + 8h
      uint32_t u[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t t0 = __byte_perm(P[h][0], P[h][1], 0x5140);
        const uint32_t t1 = __byte_perm(P[h][0], P[h][1], 0x7362);
        const uint32_t t2 = __byte_perm(P[h][2], P[h][3], 0x5140);
        const uint32_t t3 = __byte_perm(P[h][2], P[h][3], 0x7362);
        u[h][0] = __byte_perm(t0, t2, 0x5410);
        u[h][1] = __byte_perm(t0, t2, 0x7632);
        u[h][2] = __byte_perm(t1, t3, 0x5410);
        u[h][3] = __byte_perm(t1, t3, 0x7632);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (NT <= 2 || nt < live) {
          const uint32_t b = *reinterpret_cast<const uint32_t*>(
              xs + (nt * 8 + g) * XS + 16 * s + 4 * t);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_u8s8(acc_q[j][nt], u[0][j], u[1][j], b);
          int ones[4] = {isum[nt][0], isum[nt][1], 0, 0};
          mma_u8s8(ones, ONES, ONES, b);
          isum[nt][0] = ones[0];
          isum[nt][1] = ones[1];
        }
      }
      if (GROUPED && k < ke && (left == 1 || k + 16 >= ke)) {
        // end of a scale group (or of this split)
        const float* sr = ss + row * BN + warp * WARP_COLS + 8 * g;
        const float4 lo = *reinterpret_cast<const float4*>(sr);
        const float4 hi = *reinterpret_cast<const float4*>(sr + 4);
        const float sc[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        rescale<L::QMAX, NT>(acc_q, isum, acc, sc);
      }
      --left;
    }
  }
  if (!GROUPED) {
    // per-channel scales: one exact sum, rescaled once as the plain version
    // does, so the result is its bits. With K split, the split's exact
    // int32 sum goes out as the bits of its f32 slot and the second pass
    // (sum_int_splits) adds the splits in int32 and rescales the total.
    if (splits > 1) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned off = (unsigned)L::QMAX * (unsigned)isum[nt][h];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[j][nt][h] =
                __int_as_float((int)((unsigned)acc_q[j][nt][h] - off));
            acc[j][nt][2 + h] =
                __int_as_float((int)((unsigned)acc_q[j][nt][2 + h] - off));
          }
        }
    } else {
      float sc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        sc[i] = col + i < N ? __ldg(scale + (size_t)expert * N + col + i)
                            : 0.f;
      rescale<L::QMAX, NT>(acc_q, isum, acc, sc);
    }
  }

  float* dst = splits > 1
                   ? out + ((size_t)expert * splits + split) * C * N
                   : out + (size_t)expert * C * N;
  const bool vec = N % 4 == 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + nt * 8 + 2 * t + h;
      if (c < C) {
        const float vals[8] = {acc[0][nt][h], acc[1][nt][h], acc[2][nt][h],
                               acc[3][nt][h], acc[0][nt][2 + h],
                               acc[1][nt][2 + h], acc[2][nt][2 + h],
                               acc[3][nt][2 + h]};
        store8(dst + (size_t)c * N, col, N, vals, vec);
      }
    }
}

template <int BITS>
int launch_bits(int nt, dim3 grid, int smem, cudaStream_t st,
                const int8_t* xq, const uint8_t* qw, const float* scale,
                float* dst, int C, int K, int N, int G, int chunks,
                int splits, int k_per_split, int srows, int aligned) {
  void (*kernel)(const int8_t*, const uint8_t*, const float*, float*, int,
                 int, int, int, int, int, int, int, int);
  const bool grouped = G > 1;
  switch (nt) {
    case 1:
      kernel = grouped ? expert_w8_kernel<BITS, 1, true>
                       : expert_w8_kernel<BITS, 1, false>;
      break;
    case 2:
      kernel = grouped ? expert_w8_kernel<BITS, 2, true>
                       : expert_w8_kernel<BITS, 2, false>;
      break;
    case 4:
      kernel = grouped ? expert_w8_kernel<BITS, 4, true>
                       : expert_w8_kernel<BITS, 4, false>;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, st>>>(xq, qw, scale, dst, C, K, N, G, chunks,
                                      splits, k_per_split, srows, aligned);
  return 0;
}

// xq (E, C, K) int8, qw (E, packed_rows(K), N) uint8, scale (E, G, N) f32
// -> out (E, C, N) f32, all contiguous on the current device. A scale
// group (K / G rows, or all of K when G == 1) must be a multiple of 16
// rows. nt: n8 tiles of capacity rows a block holds (1, 2 or 4; C takes
// ceil(C / 8nt) chunks). With splits > 1, each expert's K is cut into
// ranges of k_per_split rows (a multiple of 128, and of the group when
// G > 1; no range empty) and workspace holds E x splits x C x N f32
// partials. Returns the CUDA error code of the launches (0 on success).
inline int launch(const void* xq, const void* qw, const void* scale,
                  void* out, void* workspace, int E, int C, int K, int N,
                  int G, int bits, int nt, int splits, int k_per_split,
                  void* stream) {
  using namespace expert_stream;
  if (E <= 0 || C <= 0 || K <= 0 || N <= 0 || G <= 0 || K % G != 0 ||
      (G > 1 && (K / G) % 16 != 0) || splits <= 0 || k_per_split <= 0 ||
      k_per_split % KS != 0 || (G > 1 && k_per_split % (K / G) != 0) ||
      (long long)E * splits > MAX_GRID_Z ||
      (long long)splits * k_per_split < K ||
      (long long)(splits - 1) * k_per_split >= K ||
      (splits > 1 && workspace == nullptr) ||
      (bits != 2 && bits != 3 && bits != 4 && bits != 8) ||
      (nt != 1 && nt != 2 && nt != 4))
    return (int)cudaErrorInvalidValue;
  // per-channel scales are read once, at the end of a split
  const int srows = G == 1 ? 0 : scale_rows(K, G);
  const int smem = STAGES * stage_bytes_for(bits, nt, 1, srows);
  const int chunks = (C + 8 * nt - 1) / (8 * nt);
  const long long blocks_x = (long long)(N + BN - 1) / BN * chunks;
  if (smem > MAX_SMEM || blocks_x > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks_x, 1, E * splits);
  const cudaStream_t st = (cudaStream_t)stream;
  float* dst = splits > 1 ? (float*)workspace : (float*)out;
  const int aligned = aligned16(xq, qw, scale, N, K) ? 1 : 0;
  const int8_t* xp = (const int8_t*)xq;
  const uint8_t* qp = (const uint8_t*)qw;
  const float* sp = (const float*)scale;
  int code;
  switch (bits) {
    case 2:
      code = expert_w8::launch_bits<2>(nt, grid, smem, st, xp, qp, sp, dst, C, K, N, G, chunks, splits, k_per_split, srows, aligned);
      break;
    case 3:
      code = expert_w8::launch_bits<3>(nt, grid, smem, st, xp, qp, sp, dst, C, K, N, G, chunks, splits, k_per_split, srows, aligned);
      break;
    case 4:
      code = expert_w8::launch_bits<4>(nt, grid, smem, st, xp, qp, sp, dst, C, K, N, G, chunks, splits, k_per_split, srows, aligned);
      break;
    default:
      code = expert_w8::launch_bits<8>(nt, grid, smem, st, xp, qp, sp, dst, C, K, N, G, chunks, splits, k_per_split, srows, aligned);
      break;
  }
  if (code) return code;
  if (splits > 1 && G == 1) {
    split_k::sum_int_splits(dst, sp, (float*)out, C, N, splits, E, st);
  } else if (splits > 1) {
    split_k::sum_splits(dst, out, (size_t)C * N, splits, E, 0, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace expert_w8
