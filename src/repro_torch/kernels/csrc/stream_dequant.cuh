// The weight-streaming fused dequantize + matmul kernel (bf16 products),
// built on expert_stream.cuh: kernel 4 (expert_dequant_matmul.cu) runs it
// over E experts, kernel 1 (dequant_matmul.cu) at decode over one dense
// linear as E = 1. Computes, for each e of E,
//
//   out[e, c, n] = sum_k bf16(x[e, c, k]) * bf16(f32(q[e, k, n] - QMAX) * scale[e, g(k), n])
//
// accumulated in f32; what bounds it and the design are in the two
// sources' and expert_stream.cuh's headers. Here each lane turns its byte
// planes into bf16 pairs in registers: the exponent trick makes a float
// of each code (2^23 + q, one byte permute), one subtraction gives q -
// QMAX exactly, one multiply by the f32 scale, and one paired
// cvt.rn.bf16x2.f32 rounds two values. An f32 x goes through the ring as
// f32 and is rounded to bf16 as a lane reads its B fragment; a bf16 x
// (XBF) goes through as it is, half the bytes, and a lane reads its B
// fragment as two bf16 pairs. The output is f32, or bf16 (out_bf16,
// without K splits: split partials are f32 and the split sum rounds).
#pragma once

#include "expert_stream.cuh"

namespace expert_dq {

using namespace expert_stream;

// ELEM: the scale group is not a whole number of 16-row K steps (a group
// of 8, say), so each value reads its own scale from global memory (slow,
// right; no model path quantizes so). XBF: x is bf16, else f32.
template <int BITS, int NT, bool ELEM, bool XBF>
__global__ void __launch_bounds__(THREADS, min_blocks(NT))
expert_dq_kernel(const void* __restrict__ x, const uint8_t* __restrict__ qw,
                 const float* __restrict__ scale, void* __restrict__ out,
                 int C, int K, int N, int G, int chunks, int splits,
                 int k_per_split, int srows, int aligned, int out_bf16) {
  using L = packing::Layout<BITS>;
  using S = Stage<BITS>;
  constexpr int CC = 8 * NT;
  constexpr int XB = XBF ? 2 : 4;      // bytes an x value
  constexpr int XS = x_stride(XB) / XB;  // values a staged x row
  constexpr float BIAS = 8388608.0f + (float)L::QMAX;
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
  const int stage = stage_bytes<BITS>(NT, XB, srows);
  // n8 tiles of this chunk that hold capacity rows
  const int live = min(NT, (C - c0 + 7) / 8);

  Tile tl;
  tl.qw = qw + (size_t)expert * packed_rows * N + n0;
  tl.x = reinterpret_cast<const uint8_t*>(x) +
         ((size_t)expert * C + c0) * K * XB;
  tl.scale = reinterpret_cast<const uint8_t*>(scale + (size_t)expert * G * N
                                              + n0);
  tl.K = K; tl.N = N; tl.G = G; tl.C = C; tl.c0 = c0; tl.n0 = n0;
  tl.kb = kb; tl.x_bytes = XB; tl.cc = CC; tl.srows = srows;
  tl.packed_rows = packed_rows; tl.aligned = aligned != 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) fetch_stage<BITS>(tl, smem + s * stage, s);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int col = n0 + warp * WARP_COLS + 8 * g;  // the lane's 8 columns
  // the exponent trick's 0x4B000000, made from a kernel parameter (srows
  // < 2^30) so that the compiler holds it in a register: each byte permute
  // then takes its selector as the immediate (with the constant as the
  // immediate, ptxas moved every selector into a register first: one more
  // instruction a value)
  const uint32_t magic = 0x4B000000u | ((uint32_t)srows >> 30);
  float acc[4][NT][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][nt][i] = 0.0f;
  // K steps a scale group spans (per-channel: never a second group; with
  // per-value scales unused)
  const int gsteps = G == 1 || ELEM ? INT_MAX / 2 : group / 16;

  for (int it = 0; it < n_stages; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < n_stages)
      fetch_stage<BITS>(tl, smem + ((it + STAGES - 1) % STAGES) * stage,
                        it + STAGES - 1);
    cp_async_commit();

    const uint8_t* st = smem + (it % STAGES) * stage;
    const uint8_t* xs = st + S::BYTES;
    const float* ss = reinterpret_cast<const float*>(st + S::BYTES +
                                                     CC * XS * XB);
    const int k0 = kb + it * KS;
    // each step's scale row: the stage's rows start at group k0 / group, a
    // new group every `gsteps` steps; steps past K keep the last row
    int srow[STEPS];
    {
      int row = 0, left = gsteps - (k0 / 16) % gsteps;
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        if (left == 0) {
          ++row;
          left = gsteps;
        }
        srow[s] = min(row, srows - 1);
        --left;
      }
    }
    // every step runs, also past ke in the last stage (x is zero there),
    // and none branches (tiles past C multiply zeros when NT <= 2), so the
    // compiler can run one step's loads under the last's math
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const int k = k0 + 16 * s;
      // q - QMAX, exact, of K row 4t + i of the lane's column 8g + 4h + j
      uint32_t P[2][4];
      load_planes<BITS>(st + s * S::ROWS16 * S::RS + warp * WARP_COLS + 8 * g,
                        t, P);
      float q[2][4][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            q[h][j][i] =
                __uint_as_float(__byte_perm(P[h][i], magic, 0x7440 + j)) -
                BIAS;
      uint32_t b[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (NT <= 2 || nt < live) {
          const int at = ((nt * 8 + g) * XS + 16 * s + 4 * t) * XB;
          if (XBF) {
            const uint2 v = *reinterpret_cast<const uint2*>(xs + at);
            b[nt][0] = v.x;
            b[nt][1] = v.y;
          } else {
            const float4 v = *reinterpret_cast<const float4*>(xs + at);
            b[nt][0] = pack_bf16(v.x, v.y);
            b[nt][1] = pack_bf16(v.z, v.w);
          }
        }
      }
      float sc[8];  // the scales of the lane's columns at this step
      if (!ELEM) {
        const float* sr = ss + srow[s] * BN + warp * WARP_COLS + 8 * g;
        const float4 lo = *reinterpret_cast<const float4*>(sr);
        const float4 hi = *reinterpret_cast<const float4*>(sr + 4);
        sc[0] = lo.x; sc[1] = lo.y; sc[2] = lo.z; sc[3] = lo.w;
        sc[4] = hi.x; sc[5] = hi.y; sc[6] = hi.z; sc[7] = hi.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // values of K rows 4t + i for fragment rows g (h 0) and g + 8
        float v[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float s_v;
            if (ELEM) {
              const int kk = k + 4 * t + i, n = col + 4 * h + j;
              s_v = kk < K && n < N
                        ? __ldg(scale + ((size_t)expert * G + kk / group) * N
                                + n)
                        : 0.0f;
            } else {
              s_v = sc[4 * h + j];
            }
            v[h][i] = q[h][j][i] * s_v;
          }
        // K rows 4t, 4t+1 are the fragment's k slots 2t, 2t+1; 4t+2, 4t+3
        // its slots 2t+8, 2t+9 (x follows the same order)
        const uint32_t a[4] = {pack_bf16(v[0][0], v[0][1]),
                               pack_bf16(v[1][0], v[1][1]),
                               pack_bf16(v[0][2], v[0][3]),
                               pack_bf16(v[1][2], v[1][3])};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          if (NT <= 2 || nt < live)
            mma_bf16(acc[j][nt], a, b[nt][0], b[nt][1]);
      }
    }
  }

  // lane (g, t) holds capacity rows 2t and 2t + 1 of each n8 tile, for
  // columns col + j (fragment row g of tile j) and col + 4 + j (row g + 8)
  const bool bf = out_bf16 && splits == 1;
  const size_t base = splits > 1 ? ((size_t)expert * splits + split) * C * N
                                  : (size_t)expert * C * N;
  float* dst = (float*)out + base;
  __nv_bfloat16* dstb = (__nv_bfloat16*)out + base;
  const bool vec = N % (bf ? 8 : 4) == 0;
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
        if (bf)
          store8_bf16(dstb + (size_t)c * N, col, N, vals, vec);
        else
          store8(dst + (size_t)c * N, col, N, vals, vec);
      }
    }
}

// the kernel of (NT, elem, x_bf16): a bf16 x takes no per-value scales
// (scale groups of whole 16-row K steps), so its ELEM form is not built
template <int BITS, int NT>
int launch_nt(bool elem, bool x_bf16, dim3 grid, int smem, cudaStream_t st,
              const void* x, const uint8_t* qw, const float* scale,
              void* dst, int C, int K, int N, int G, int chunks, int splits,
              int k_per_split, int srows, int aligned, int out_bf16) {
  if (elem && x_bf16) return (int)cudaErrorInvalidValue;
  auto kernel = x_bf16 ? expert_dq_kernel<BITS, NT, false, true>
                : elem ? expert_dq_kernel<BITS, NT, true, false>
                       : expert_dq_kernel<BITS, NT, false, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, st>>>(x, qw, scale, dst, C, K, N, G, chunks,
                                      splits, k_per_split, srows, aligned,
                                      out_bf16);
  return 0;
}

template <int BITS>
int launch_bits(int nt, bool elem, bool x_bf16, dim3 grid, int smem,
                cudaStream_t st, const void* x, const uint8_t* qw,
                const float* scale, void* dst, int C, int K, int N, int G,
                int chunks, int splits, int k_per_split, int srows,
                int aligned, int out_bf16) {
  switch (nt) {
    case 1:
      return launch_nt<BITS, 1>(elem, x_bf16, grid, smem, st, x, qw, scale, dst, C, K, N, G, chunks, splits, k_per_split, srows, aligned, out_bf16);
    case 2:
      return launch_nt<BITS, 2>(elem, x_bf16, grid, smem, st, x, qw, scale, dst, C, K, N, G, chunks, splits, k_per_split, srows, aligned, out_bf16);
    case 4:
      return launch_nt<BITS, 4>(elem, x_bf16, grid, smem, st, x, qw, scale, dst, C, K, N, G, chunks, splits, k_per_split, srows, aligned, out_bf16);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// x (E, C, K) f32 (bf16 with x_bf16), qw (E, packed_rows(K), N) uint8,
// scale (E, G, N) f32 -> out (E, C, N) f32 (bf16 with out_bf16), all
// contiguous on the current device. nt: n8 tiles of capacity rows a block
// holds (1, 2 or 4; C takes ceil(C / 8nt) chunks). With splits > 1, each
// expert's K is cut into ranges of k_per_split rows (a multiple of 128; no
// range empty) and workspace holds E x splits x C x N f32 partials, summed
// in split order and rounded once to out's type. A bf16 x takes scale
// groups of whole 16-row K steps only. Returns the CUDA error code of the
// launches (0 on success).
inline int launch(const void* x, const void* qw, const void* scale, void* out,
                  void* workspace, int E, int C, int K, int N, int G,
                  int bits, int nt, int splits, int k_per_split, int x_bf16,
                  int out_bf16, void* stream) {
  using namespace expert_stream;
  if (E <= 0 || C <= 0 || K <= 0 || N <= 0 || G <= 0 || K % G != 0 ||
      splits <= 0 || k_per_split <= 0 || k_per_split % KS != 0 ||
      (long long)E * splits > MAX_GRID_Z ||
      (long long)splits * k_per_split < K ||
      (long long)(splits - 1) * k_per_split >= K ||
      (splits > 1 && workspace == nullptr) ||
      (bits != 2 && bits != 3 && bits != 4 && bits != 8) ||
      (nt != 1 && nt != 2 && nt != 4))
    return (int)cudaErrorInvalidValue;
  const int xb = x_bf16 ? 2 : 4;
  const int srows = scale_rows(K, G);
  const int smem = STAGES * stage_bytes_for(bits, nt, xb, srows);
  const int chunks = (C + 8 * nt - 1) / (8 * nt);
  const long long blocks_x = (long long)(N + BN - 1) / BN * chunks;
  if (smem > MAX_SMEM || blocks_x > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks_x, 1, E * splits);
  const cudaStream_t st = (cudaStream_t)stream;
  void* dst = splits > 1 ? workspace : out;
  const int aligned =
      aligned16(x, qw, scale, N, (long long)K * xb) ? 1 : 0;
  const bool elem = srows == 0;
  const uint8_t* qp = (const uint8_t*)qw;
  const float* sp = (const float*)scale;
  int code;
  switch (bits) {
    case 2:
      code = expert_dq::launch_bits<2>(nt, elem, x_bf16, grid, smem, st, x, qp, sp, dst, C, K, N, G, chunks, splits, k_per_split, srows, aligned, out_bf16);
      break;
    case 3:
      code = expert_dq::launch_bits<3>(nt, elem, x_bf16, grid, smem, st, x, qp, sp, dst, C, K, N, G, chunks, splits, k_per_split, srows, aligned, out_bf16);
      break;
    case 4:
      code = expert_dq::launch_bits<4>(nt, elem, x_bf16, grid, smem, st, x, qp, sp, dst, C, K, N, G, chunks, splits, k_per_split, srows, aligned, out_bf16);
      break;
    default:
      code = expert_dq::launch_bits<8>(nt, elem, x_bf16, grid, smem, st, x, qp, sp, dst, C, K, N, G, chunks, splits, k_per_split, srows, aligned, out_bf16);
      break;
  }
  if (code) return code;
  if (splits > 1)
    split_k::sum_splits((const float*)dst, out, (size_t)C * N, splits, E,
                        out_bf16, st);
  return (int)cudaGetLastError();
}

}  // namespace expert_dq
