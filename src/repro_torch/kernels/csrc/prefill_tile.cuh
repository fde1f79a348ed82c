// The prefill body of the dense packed-weight matmuls for Hopper
// (sm_90a): kernel 1 (dequant_matmul.cu, bf16 products) and kernel 3
// (w8a8_matmul.cu, int8 products) run it when a linear has more token
// rows than the weight-streaming body serves well (M above
// kernels/dequant_matmul.py's STREAM_MAX_M). Computes
//
//   kernel 1: out[m, n] = sum_k bf16(x[m, k]) * bf16(f32(q[k, n] - QMAX) * scale[g(k), n])
//   kernel 3: out[m, n] = sum_g scale[g, n] * (sum_{k in g} xq[m, k] * (q[k, n] - QMAX))
//
// kernel 1 accumulated in f32, kernel 3 exact in int32 per scale group
// and rescaled in f32 (before the caller's per-token rescale), with q from
// the K-packed offset-binary bytes of core/quant/types.py (packing.cuh).
//
// What bounds it. M token rows do 2*M*K*N operations on K*N*bits/8
// packed weight bytes and M*K*4 (kernel 1) or M*K (kernel 3) x bytes:
// from a few hundred rows on, the tensor cores (989 TFLOP/s bf16, 1979
// TOP/s int8, at 700 W). The weight must be unpacked before the tensor
// cores take it; done per fragment, as the streaming body does, the
// unpack is repeated for every 8-32 token rows.
//
// The design. A block of 8 warps owns a tile of BM = 128 token rows x BN
// weight columns (256; 128 for grouped kernel 3) and one range of K (a
// split); each warp computes 64 rows x BN / 4 columns with mma.sync:
// m16n8k16 bf16 (f32 sums) for kernel 1, m16n8k32 s8 (int32 sums) for
// kernel 3. The block walks its K range in stages of BK = 64 rows through
// a ring in dynamic shared memory, LOOK = 4 stages ahead (3 where four do
// not fit: kernel 1 at W8), filled by 16-byte cp.async.cg copies: the
// stage's packed weight rows, its 128 x rows and, where scales are
// grouped, its scale row. The x rows are multiplied straight from the
// ring: int8 for kernel 3, and for kernel 1 bf16, rounded once per launch
// by dequant_matmul.cu's to_bf16_kernel (the tile then streams half of
// f32 x's bytes, and every row tile's x is read by N / BN blocks). Each
// stage's weights are unpacked ONCE into an operand tile in shared memory
// that all 8 warps read, so each unpacked value feeds 128 token rows:
// kernel 1 dequantizes to bf16 (rounded after the f32 scale, as the plain
// version; the exponent trick makes each code a float), kernel 3 writes
// q - QMAX as int8. A thread unpacks units of 4 columns x 8 K rows; the
// 8 lanes that store together write one column's contiguous 128 bytes.
// Operand rows and ring rows keep K contiguous and are padded by 16
// bytes, so both operands load with ldmatrix (no transpose) on distinct
// banks. The
// operand tiles are double-buffered: while the warps multiply stage it
// from one, they unpack stage it + 1 into the other, a part after each
// 32-byte product step; one __syncthreads a stage. Kernel 3 rescales each
// scale group's exact int32 sums into f32 in registers where the group
// ends (per-channel: once, at the end); kernel 1 writes f32 straight from
// its accumulators.
//
// Where the time goes: builds of this kernel with one phase removed (the
// products, the unpack or the copies) showed the three phases' times
// adding up rather than overlapping, and an order that put half the
// warps in each phase did not change that. Not wgmma: the products run
// on mma.sync from padded tiles, below the card's full tensor-core rate
// (hopper-kernels guide §1); moving the operand tiles to wgmma's
// canonical shared-memory layout and the unpack to a producer warpgroup
// is later work (ROADMAP).
//
// Tile order: blockIdx.x walks the column tiles of one row tile before
// the next row tile, so the blocks resident together read the same x rows
// (a row tile's x is at most 2 MiB of bf16 at K = 8192) and, between them,
// every column of a llama-sized weight (at most 8 MiB at W4,
// L2-resident): at M = 16,384 each x byte comes from device memory about
// once.
//
// Copies: with 16-byte aligned rows and K a whole number of stages, only
// the x rows below M and the weight columns below N are copied (what the
// others hold feeds only outputs the store masks); otherwise every row is
// copied with zero fill past M, N and K (expert_stream.cuh's copy_rows,
// with a byte path for unaligned rows).
//
// Scales: the tile takes per-channel scales and groups of whole stages
// (64 rows or a multiple: one group a stage). Other groups (16-32 rows)
// take the streaming body at any M (slow, right; no model path quantizes
// so): the planner picks the body.
//
// K splits: when the tiles are fewer than the SMs, the planner splits K
// in whole stages (whole groups for kernel 3); each split writes a
// partial (kernel 3 per-channel: its exact int32 sum) and a second pass
// adds them in split order (split_k.cuh; per-channel kernel 3 adds in
// int32 and rescales the total once, the plain version's bits). No float
// atomics: the result does not depend on block timing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include "expert_stream.cuh"
#include "packing.cuh"
#include "split_k.cuh"

namespace prefill_tile {

constexpr int BM = 128;        // token rows of a block tile
constexpr int BK = 64;         // K rows of a ring stage
constexpr int THREADS = 256;   // 8 warps: 2 along M x 4 along N
constexpr int WM = 64;         // token rows of a warp's share
constexpr int MAX_SMEM = 232448;  // the H100's dynamic shared memory a block
constexpr int MAX_GRID_Z = 65535;

// The geometry of one kernel. The x rows are multiplied straight from the
// ring: bf16 for kernel 1 (converted once per launch by dequant_matmul.cu's
// to_bf16_kernel), int8 for kernel 3; an operand row (a weight column's K
// values, unpacked) has the same bytes. A warp owns WM x WN of the tile, NI
// n8 tiles: 8 (BN = 256) for kernel 1 and per-channel kernel 3; 4 (BN = 128)
// for grouped kernel 3, whose f32 sums over groups take a second set of
// accumulators.
template <int BITS, bool INT8, bool GROUPED>
struct Geo {
  using L = packing::Layout<BITS>;
  static constexpr int NI = INT8 && GROUPED ? 4 : 8;
  static constexpr int WN = 8 * NI;
  static constexpr int BN = 4 * WN;
  static constexpr int WRS = BN + 16;            // bytes of a staged packed row
  // packed rows holding 8 K rows (byte b of packed row r of a column holds
  // K rows in order, so the R8 bytes of a column read as packing.cuh's
  // group word), and a stage's
  static constexpr int R8 = 8 / (int)L::VALUES * (int)L::BYTES;
  static constexpr int ROWS = BK / 8 * R8;
  static constexpr int XB = INT8 ? 1 : 2;        // bytes of an x value
  static constexpr int XRS = BK * XB + 16;       // bytes of a staged x row
  static constexpr int OPR = XRS;                // of an operand row
  static constexpr int SROWS = INT8 && !GROUPED ? 0 : 1;  // scale rows
  static constexpr int STAGE = ROWS * WRS + BM * XRS + SROWS * BN * 4;
  static constexpr int OP_BYTES = BN * OPR;      // an operand buffer
  // stages fetched ahead: 4 where the ring fits, else 3 (kernel 1 at W8);
  // a slot stays busy one stage past its fetch
  static constexpr int LOOK =
      5 * STAGE + 2 * OP_BYTES <= MAX_SMEM ? 4 : 3;
  static constexpr int STAGES = LOOK + 1;
  static constexpr int SMEM = STAGES * STAGE + 2 * OP_BYTES;
  // a thread's unpack units (4 columns x 8 K rows each) a stage
  static constexpr int UNITS = BN / 4 * (BK / 8) / THREADS;
  static_assert(SMEM <= MAX_SMEM, "the ring fits shared memory");
  static_assert((BM / WM) * (BN / WN) * 32 == THREADS,
                "the warps cover the tile");
};

// ------------------------------------------------------------ the ring

// where a block's stages come from
struct Src {
  const uint8_t* x;      // x row m0 (bytes)
  const uint8_t* qw;     // packed weight column n0
  const uint8_t* scale;  // scale column n0 (bytes)
  int M, K, N, G, m0, n0, kb, packed_rows;
  bool aligned;  // every source row starts on 16 bytes
  bool whole;    // aligned, and K a whole number of stages
};

// The fast copy (Src::whole): only the rows below valid_rows and the
// 16-byte chunks below valid_bytes of each, by cp.async. What it skips
// keeps whatever the slot held: x rows past M and weight columns past N
// feed only outputs that the store masks, and no stage reaches past K.
template <int WIDTH>
__device__ __forceinline__ void copy_valid(uint8_t* dst, int dst_pitch,
                                           const uint8_t* src,
                                           size_t src_pitch, int rows,
                                           int valid_rows, int valid_bytes) {
  constexpr int CH = WIDTH / 16;
  const int n = min(rows, valid_rows) * CH;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 16;
    if (c < valid_bytes)
      expert_stream::cp_async16(dst + r * dst_pitch + c,
                                src + r * src_pitch + c, 16);
  }
}

template <class G>
__device__ __forceinline__ void fetch(const Src& s, uint8_t* st, int it) {
  using expert_stream::copy_rows;
  const int k0 = s.kb + it * BK;
  const int pr0 = k0 / 8 * G::R8;
  const uint8_t* w = s.qw + (size_t)pr0 * s.N;
  uint8_t* xs = st + G::ROWS * G::WRS;
  const uint8_t* x = s.x + (size_t)k0 * G::XB;
  const int g0 = s.G == 1 ? 0 : k0 / (s.K / s.G);
  const uint8_t* sc = s.scale + (size_t)g0 * s.N * 4;
  if (s.whole) {
    copy_valid<G::BN>(st, G::WRS, w, (size_t)s.N, G::ROWS, G::ROWS,
                      s.N - s.n0);
    copy_valid<BK * G::XB>(xs, G::XRS, x, (size_t)s.K * G::XB, BM,
                           s.M - s.m0, BK * G::XB);
    if (G::SROWS)
      copy_valid<G::BN * 4>(xs + BM * G::XRS, G::BN * 4, sc, 0, 1, 1,
                            (s.N - s.n0) * 4);
    return;
  }
  copy_rows<G::BN, THREADS>(st, G::WRS, w, (size_t)s.N, G::ROWS,
                            s.packed_rows - pr0, s.N - s.n0, s.aligned);
  copy_rows<BK * G::XB, THREADS>(xs, G::XRS, x, (size_t)s.K * G::XB, BM,
                                 s.M - s.m0, (long long)(s.K - k0) * G::XB,
                                 s.aligned);
  if (G::SROWS)
    copy_rows<G::BN * 4, THREADS>(xs + BM * G::XRS, G::BN * 4, sc,
                                  (size_t)s.N * 4, 1, s.G - g0,
                                  (long long)(s.N - s.n0) * 4, s.aligned);
}

// ----------------------------------------------------------- the unpack

// byte j of w[0..3] into word c[j] (a 4 x 4 byte transpose)
__device__ __forceinline__ void transpose4(const uint32_t w[4],
                                           uint32_t c[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// A thread's unpack unit u: K rows 8kg .. 8kg + 7 of the stage for the 4
// columns 4cq .. 4cq + 3, kg = u % 8 and cq = u / 8, so the 8 lanes that
// store together write one column's 128 contiguous bytes. lo[j] (and
// hi[j], W8 only: K rows 4-7) is column j's packed bytes of those rows in
// order, so code i sits in it where packing.cuh's group word has it.
template <class G>
__device__ __forceinline__ void gather(const uint8_t* ws, int u,
                                       uint32_t lo[4], uint32_t hi[4]) {
  const int kg = u % 8, cq = u / 8;
  uint32_t w[8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
    w[r] = r < G::R8 ? *reinterpret_cast<const uint32_t*>(
                           ws + (G::R8 * kg + r) * G::WRS + 4 * cq)
                     : 0u;
  transpose4(w, lo);
  if (G::R8 == 8) transpose4(w + 4, hi);
}

// code i (0..7, offset-binary) of a unit's column word
template <int BITS>
__device__ __forceinline__ uint32_t code(uint32_t lo, uint32_t hi, int i) {
  if (BITS == 8) return ((i < 4 ? lo : hi) >> (8 * (i & 3))) & 0xFFu;
  return (lo >> (BITS * i)) & ((1u << BITS) - 1u);
}

// the 8 codes of a column word as bytes, code i in byte i % 4 of b[i / 4]
template <int BITS>
__device__ __forceinline__ void code_bytes(uint32_t lo, uint32_t hi,
                                           uint32_t b[2]) {
  if (BITS == 8) {
    b[0] = lo;
    b[1] = hi;
  } else if (BITS == 4) {
    const uint32_t e = lo & 0x0F0F0F0Fu;         // codes 0, 2, 4, 6
    const uint32_t o = (lo >> 4) & 0x0F0F0F0Fu;  // codes 1, 3, 5, 7
    b[0] = __byte_perm(e, o, 0x5140);
    b[1] = __byte_perm(e, o, 0x7362);
  } else {
    b[0] = b[1] = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      b[i / 4] |= code<BITS>(lo, hi, i) << (8 * (i % 4));
  }
}

// Unpack column j of unit u into an operand buffer: kernel 1 dequantizes
// to f32 and rounds to bf16 (the plain version's operand); kernel 3
// writes q - QMAX as int8. Kernel 1 makes a float of each code byte with
// one byte permute against `magic` (0x4B000000: 2^23 + q, as the
// streaming body does), then q - QMAX exactly and the f32 product.
template <class G, int BITS, bool INT8>
__device__ __forceinline__ void unpack_column(const uint8_t* st, uint8_t* op,
                                              int u, int j,
                                              const uint32_t lo[4],
                                              const uint32_t hi[4],
                                              uint32_t magic) {
  using L = packing::Layout<BITS>;
  const int kg = u % 8, cq = u / 8;
  uint8_t* dst = op + (4 * cq + j) * G::OPR + kg * 8 * G::XB;
  uint32_t b[2];
  code_bytes<BITS>(lo[j], hi[j], b);
  if constexpr (INT8) {
    constexpr uint32_t OFF = (uint32_t)L::QMAX * 0x01010101u;
    *reinterpret_cast<uint2*>(dst) = make_uint2(__vsub4(b[0], OFF),
                                                __vsub4(b[1], OFF));
  } else {
    constexpr float BIAS = 8388608.0f + (float)L::QMAX;
    const float sc = reinterpret_cast<const float*>(
        st + G::ROWS * G::WRS + BM * G::XRS)[4 * cq + j];
    float f[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      f[i] = (__uint_as_float(__byte_perm(b[i / 4], magic, 0x7440 + i % 4)) -
              BIAS) * sc;
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(expert_stream::pack_bf16(f[0], f[1]),
                   expert_stream::pack_bf16(f[2], f[3]),
                   expert_stream::pack_bf16(f[4], f[5]),
                   expert_stream::pack_bf16(f[6], f[7]));
  }
}

// ---------------------------------------------------------- the products

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// D += A (16 x 32 s8, row-major) B (32 x 8 s8, column-major), exact
// int32 sums
__device__ __forceinline__ void mma_s8(int d[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The warp's A (4 m16 tiles of its 64 rows) and B (NI n8 tiles of its
// columns) fragments of one 32-byte K step (16 bf16 or 32 int8 values) at
// byte kb of the rows: x rows at xa (pitch xp), weight columns at wb
// (pitch wp), each K-contiguous. ldmatrix.x4's four 8x8 matrices are,
// for A, rows 0-7 / 8-15 at bytes 0 / 16 (the a0..a3 of both mma shapes)
// and for B, columns 0-7 at bytes 0 and 16, then columns 8-15 (b0, b1 of
// two n8 tiles).
template <int NI>
__device__ __forceinline__ void load_frags(const uint8_t* xa, int xp,
                                           const uint8_t* wb, int wp, int kb,
                                           int lane, uint32_t a[4][4],
                                           uint32_t b[NI / 2][4]) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
    ldsm_x4(a[mi], xa + (mi * 16 + (lane & 15)) * xp + kb + (lane >> 4) * 16);
#pragma unroll
  for (int nj = 0; nj < NI / 2; ++nj)
    ldsm_x4(b[nj], wb + (nj * 16 + (lane & 7) + (lane >> 4) * 8) * wp + kb +
                       ((lane >> 3) & 1) * 16);
}

// Write the warp's f32 values v[mi][ni][4] (the mma accumulator layout:
// rows g and g + 8 of m16 tile mi, columns 2t and 2t + 1 of n8 tile ni) to
// the (M, N) matrix dst, f32 or with bf16 each value rounded to nearest
// even, masking rows and columns past the edge
template <int NI>
__device__ __forceinline__ void store_tile(void* dst, float v[4][NI][4],
                                           int M, int N, int r0, int c0,
                                           int lane, bool bf16) {
  const int g = lane / 4, t = lane % 4;
  const bool vec = N % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + mi * 16 + g + 8 * h;
      if (r >= M) continue;
      float* row = (float*)dst + (size_t)r * N;
      __nv_bfloat16* rowb = (__nv_bfloat16*)dst + (size_t)r * N;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int c = c0 + ni * 8 + 2 * t;
        const float a = v[mi][ni][2 * h], b = v[mi][ni][2 * h + 1];
        if (bf16) {
          if (vec && c + 1 < N) {
            *reinterpret_cast<__nv_bfloat162*>(rowb + c) =
                __floats2bfloat162_rn(a, b);
          } else {
            if (c < N) rowb[c] = __float2bfloat16_rn(a);
            if (c + 1 < N) rowb[c + 1] = __float2bfloat16_rn(b);
          }
        } else if (vec && c + 1 < N) {
          *reinterpret_cast<float2*>(row + c) = make_float2(a, b);
        } else {
          if (c < N) row[c] = a;
          if (c + 1 < N) row[c + 1] = b;
        }
      }
    }
}

template <bool INT8> struct Acc { using T = float; };
template <> struct Acc<true> { using T = int; };

// ------------------------------------------------------------ the tile

// Kernel 1 (INT8 false): xb (M, K) bf16 . packed (K, N) -> out (M, N)
// f32, or bf16 with out_bf16 and no K split. Kernel 3 (INT8): xq (M, K) int8 . packed (K, N) -> out (M, N) f32
// before the per-token rescale; GROUPED: G > 1, each group's exact sums
// rescaled where it ends. A split's partial goes to out + split * M * N
// (kernel 3 per-channel with splits > 1: the bits of its exact int32
// sums). Scales per-channel or of groups of whole stages.
template <int BITS, bool INT8, bool GROUPED>
__global__ void __launch_bounds__(THREADS, 1)
tile_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ qw,
            const float* __restrict__ scale, void* __restrict__ out, int M,
            int K, int N, int G_, int tiles_n, int splits, int k_per_split,
            int aligned, int out_bf16) {
  using G = Geo<BITS, INT8, GROUPED>;
  using L = packing::Layout<BITS>;
  constexpr int NI = G::NI;
  // 32-byte K steps a stage: 16 bf16 (m16n8k16) or 32 int8 (m16n8k32)
  constexpr int STEPS = BK * G::XB / 32;
  // unpack columns a thread writes a stage, and after each product step
  constexpr int COLS = 4 * G::UNITS;
  constexpr int PER_STEP = COLS / STEPS;
  static_assert(COLS % STEPS == 0, "the unpack spreads over the steps");
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ops = smem + G::STAGES * G::STAGE;

  const int m0 = blockIdx.x / tiles_n * BM;
  const int n0 = blockIdx.x % tiles_n * G::BN;
  const int split = blockIdx.z;
  const int kb = split * k_per_split;
  const int ke = min(K, kb + k_per_split);
  const int n_stages = (ke - kb + BK - 1) / BK;
  const int group = K / G_;

  Src s;
  s.x = x + (size_t)m0 * K * G::XB;
  s.qw = qw + n0;
  s.scale = reinterpret_cast<const uint8_t*>(scale + n0);
  s.M = M; s.K = K; s.N = N; s.G = G_; s.m0 = m0; s.n0 = n0; s.kb = kb;
  s.packed_rows = (K + L::VALUES - 1) / L::VALUES * L::BYTES;
  s.aligned = aligned != 0;
  s.whole = s.aligned && K % BK == 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int t = lane % 4;
  // the exponent trick's constant, made from a kernel parameter (K < 2^31)
  // so that the compiler holds it in a register and each byte permute
  // takes its selector as the immediate
  const uint32_t magic = 0x4B000000u | ((uint32_t)K >> 31);

#pragma unroll
  for (int i = 0; i < G::LOOK; ++i) {
    if (i < n_stages) fetch<G>(s, smem + i * G::STAGE, i);
    expert_stream::cp_async_commit();
  }
  using T = typename Acc<INT8>::T;
  T acc[4][NI][4];
  float facc[GROUPED ? 4 : 1][NI][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][ni][e] = 0;
        if (GROUPED) facc[GROUPED ? mi : 0][ni][e] = 0.0f;
      }
  // the codes of the thread's units of the stage being unpacked
  uint32_t lo[G::UNITS][4], hi[G::UNITS][4];
  expert_stream::cp_async_wait<G::LOOK - 1>();
  __syncthreads();
#pragma unroll
  for (int h = 0; h < G::UNITS; ++h) {
    const int u = threadIdx.x + h * THREADS;
    gather<G>(smem, u, lo[h], hi[h]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      unpack_column<G, BITS, INT8>(smem, ops, u, j, lo[h], hi[h], magic);
  }

  for (int it = 0; it < n_stages; ++it) {
    // stage it + 1 has landed; every thread has unpacked stage it and
    // multiplied stage it - 1, whose ring slot the fetch below refills
    expert_stream::cp_async_wait<G::LOOK - 2>();
    __syncthreads();
    if (it + G::LOOK < n_stages)
      fetch<G>(s, smem + ((it + G::LOOK) % G::STAGES) * G::STAGE,
               it + G::LOOK);
    expert_stream::cp_async_commit();
    const bool next = it + 1 < n_stages;
    const uint8_t* st = smem + (it % G::STAGES) * G::STAGE;
    const uint8_t* nst = smem + ((it + 1) % G::STAGES) * G::STAGE;
    uint8_t* nop = ops + ((it + 1) & 1) * G::OP_BYTES;
    const uint8_t* op = ops + (it & 1) * G::OP_BYTES;
    if (next) {
#pragma unroll
      for (int h = 0; h < G::UNITS; ++h)
        gather<G>(nst, threadIdx.x + h * THREADS, lo[h], hi[h]);
    }
    const uint8_t* xa = st + G::ROWS * G::WRS + wm * WM * G::XRS;
    const uint8_t* wb = op + wn * G::WN * G::OPR;
#pragma unroll
    for (int kk = 0; kk < STEPS; ++kk) {
      uint32_t a[4][4], b[NI / 2][4];
      load_frags<NI>(xa, G::XRS, wb, G::OPR, kk * 32, lane, a, b);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const uint32_t b0 = b[ni >> 1][(ni & 1) * 2];
          const uint32_t b1 = b[ni >> 1][(ni & 1) * 2 + 1];
          if constexpr (INT8)
            mma_s8(acc[mi][ni], a[mi], b0, b1);
          else
            expert_stream::mma_bf16(acc[mi][ni], a[mi], b0, b1);
        }
      // the next stage's unpack, a part after each product step
      if (next) {
#pragma unroll
        for (int c = kk * PER_STEP; c < (kk + 1) * PER_STEP; ++c)
          unpack_column<G, BITS, INT8>(nst, nop,
                                       threadIdx.x + (c / 4) * THREADS,
                                       c % 4, lo[c / 4], hi[c / 4], magic);
      }
    }
    const int kend = kb + (it + 1) * BK;
    if (GROUPED && (kend % group == 0 || kend >= ke)) {
      // end of a scale group: rescale its exact sums by the lane's column
      // scales (columns 2t, 2t + 1 of each n8 tile)
      const float* ss = reinterpret_cast<const float*>(
          st + G::ROWS * G::WRS + BM * G::XRS);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const float2 sv = *reinterpret_cast<const float2*>(
            ss + wn * G::WN + ni * 8 + 2 * t);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            facc[GROUPED ? mi : 0][ni][e] +=
                (float)acc[mi][ni][e] * (e % 2 ? sv.y : sv.x);
            acc[mi][ni][e] = 0;
          }
      }
    }
  }

  float v[4][NI][4];
  const int c0 = n0 + wn * G::WN;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    // kernel 3 per-channel: the one exact sum, rescaled once as the plain
    // version does; with K split, its bits go out for the int32 second
    // pass
    float sc[2] = {0.0f, 0.0f};
    if (INT8 && !GROUPED && splits == 1) {
      const int c = c0 + ni * 8 + 2 * t;
      sc[0] = c < N ? __ldg(scale + c) : 0.0f;
      sc[1] = c + 1 < N ? __ldg(scale + c + 1) : 0.0f;
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!INT8)
          v[mi][ni][e] = (float)acc[mi][ni][e];
        else if (GROUPED)
          v[mi][ni][e] = facc[GROUPED ? mi : 0][ni][e];
        else if (splits == 1)
          v[mi][ni][e] = (float)acc[mi][ni][e] * sc[e % 2];
        else
          v[mi][ni][e] = __int_as_float((int)acc[mi][ni][e]);
      }
  }
  const bool bf = !INT8 && out_bf16 && splits == 1;
  store_tile<NI>(bf ? out : (void*)((float*)out + (size_t)split * M * N), v,
                 M, N, m0 + wm * WM, c0, lane, bf);
}

// ----------------------------------------------------------- launching

// the grid, or an error: tiles of the (M, N) output, n fastest
inline int grid_for(int M, int N, int bn, int splits, dim3* grid,
                    int* tiles_n) {
  const long long tm = (M + BM - 1) / BM, tn = (N + bn - 1) / bn;
  if (tm * tn > INT_MAX || splits > MAX_GRID_Z)
    return (int)cudaErrorInvalidValue;
  *grid = dim3((unsigned)(tm * tn), 1, (unsigned)splits);
  *tiles_n = (int)tn;
  return 0;
}

// the checks both kernels make: K cut into `splits` ranges of k_per_split
// rows (whole stages), none empty; groups of whole stages
inline bool valid(int M, int K, int N, int G, int bits, int splits,
                  int k_per_split, const void* workspace) {
  return M > 0 && K > 0 && N > 0 && G > 0 && K % G == 0 &&
         (G == 1 || (K / G) % BK == 0) && splits > 0 && k_per_split > 0 &&
         k_per_split % BK == 0 && (long long)splits * k_per_split >= K &&
         (long long)(splits - 1) * k_per_split < K &&
         (splits == 1 || workspace != nullptr) &&
         (bits == 2 || bits == 3 || bits == 4 || bits == 8);
}

// launch tile_kernel<BITS, INT8, GROUPED> over its grid (with its shared
// memory)
template <int BITS, bool INT8, bool GROUPED>
inline int launch_tile(cudaStream_t st, const uint8_t* x, const uint8_t* qw,
                       const float* scale, void* dst, int M, int K, int N,
                       int G, int splits, int k_per_split, int aligned,
                       int out_bf16 = 0) {
  using Gm = Geo<BITS, INT8, GROUPED>;
  dim3 grid;
  int tiles_n;
  const int code = grid_for(M, N, Gm::BN, splits, &grid, &tiles_n);
  if (code) return code;
  auto kernel = tile_kernel<BITS, INT8, GROUPED>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, Gm::SMEM, st>>>(x, qw, scale, dst, M, K, N, G,
                                          tiles_n, splits, k_per_split,
                                          aligned, out_bf16);
  return 0;
}

}  // namespace prefill_tile
