// The weight-streaming body shared by the two expert-batched kernels for
// Hopper (sm_90a): expert_dequant_matmul.cu (bf16 products, kernel 4) and
// expert_w8a8_matmul.cu (int8 products, kernel 5), whose kernel templates
// are stream_dequant.cuh and stream_w8a8.cuh. Each computes, for E
// experts at once, an (E, C, K) capacity buffer times an (E, K, N) packed
// low-bit weight stack, the weight read in the K-packed offset-binary
// layout of core/quant/types.py (packing.cuh). The dense kernels 1 and 3
// (dequant_matmul.cu, w8a8_matmul.cu) run the same templates at decode
// (M up to kernels/dequant_matmul.py's STREAM_MAX_M rows) as one expert,
// E = 1, with their own K splits.
//
// What bounds them. At decode an expert's capacity is C = 8 rows, so the
// product does 2*C = 16 operations per weight value: reading the packed
// weights is the bound (at W4 eight 6144x16384 experts are 403 MB, 0.12 ms
// at 3.35 TB/s), and second to it the unpack, about 805 M values a call,
// each a handful of integer and f32 instructions. At prefill capacities
// (hundreds of rows) the tensor cores bound them.
//
// The design. A block of 4 warps owns one strip of BN = 256 output
// columns of one expert, one range of K (a split) and one chunk of up to
// 8 * NT (NT = 1, 2 or 4) capacity rows. It streams the strip's packed
// weight rows from device memory exactly once, through a ring of STAGES
// stages of KS = 128 K rows in dynamic shared memory, filled by 16-byte
// cp.async copies (each stage's packed rows are contiguous 256-byte runs
// of a row, so every copy is wide; ragged columns and rows past K are
// zero-filled by the copy's source size). Every thread both copies and
// computes, so a stage is marked full by cp.async's own groups
// (wait_group) and one __syncthreads, which also marks the stage consumed
// before it is refilled: no mbarrier or TMA descriptor is needed (nor the
// libcuda entry point that encodes one). The stage also holds the chunk's
// x rows for its K range and the scale rows of the groups it touches.
// With three blocks an SM at decode, up to 6 stages (96 KiB of W4
// weights) are in flight on each SM.
//
// The products run on the tensor cores with the weight as the wide
// operand: a strip's columns are the M side of mma.sync.m16n8k16 (16
// columns a tile) and the capacity rows its N side (n8), so C = 8 fills
// one n8 tile with no padding. Warp w owns the strip's columns
// 64w .. 64w + 63 as four m16 tiles, laid out so that lane (g, t) (g =
// lane / 4, t = lane % 4) owns the eight contiguous columns 8g .. 8g + 7:
// fragment row g of tile j is column 8g + j, row g + 8 is 8g + 4 + j.
// The order of K inside a 16-row step is free as long as both operands
// follow it: lane t takes the 4 contiguous K rows 4t .. 4t + 3, so its
// weight bytes for the step are 8-byte reads of 1 (W2), 2 (W3, W4) or 4
// (W8) packed rows, unpacked in registers (load_planes: byte j of plane
// i is K row 4t + i of column 8g + 4 * half + j) with shifts, masks and
// byte permutes on whole 32-bit words, and its x values are one 16-byte
// (f32), 8-byte (bf16) or 4-byte (int8) read. Staged rows are padded (PAD bytes a packed
// row, 64 or 16 bytes an x row) so that a warp's reads fall on distinct
// banks at W4 and W2.
//
// When the strips, chunks and experts alone give too few blocks (wo's
// 16384 x 6144), the wrapper splits K across blocks in whole stages; each
// split writes an f32 partial and split_k.cuh sums them in split order,
// so the result does not depend on block timing. Capacities above 32
// rows (prefill) take several chunks, each re-streaming its strip; chunks
// of one strip are neighbouring blocks, so they mostly meet the strip in
// L2. (A 64-row chunk ran slower at prefill capacities: its f32 x rows
// make a 166 KiB ring, one block an SM.) For capacities in the hundreds
// wgmma with the capacity rows as a 64-row operand would win: later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include "packing.cuh"
#include "split_k.cuh"

namespace expert_stream {

constexpr int BN = 256;         // output columns of a block's strip
constexpr int KS = 128;         // K rows a ring stage holds
constexpr int STAGES = 3;       // ring stages
constexpr int THREADS = 128;    // 4 warps, 64 columns each
// resident blocks an SM the launch bound asks for: three at decode (a
// capacity tile of 8 or 16 rows), where the ring's 69 KiB at W4 let three
// fit and the unpack's latency wants their 12 warps; one for the 32-row
// tile, whose accumulators take 160-200 registers. With only the block
// size bound, ptxas traded registers for an occupancy the shared memory
// never allows, and the decode kernels spilled
__host__ __device__ constexpr int min_blocks(int nt) { return nt <= 2 ? 3 : 1; }
constexpr int WARP_COLS = 64;   // four m16 tiles
constexpr int STEPS = KS / 16;  // mma K steps a stage
constexpr int MAX_SMEM = 232448;  // the H100's dynamic shared memory a block
constexpr int MAX_GRID_Z = 65535;
static_assert(THREADS / 32 * WARP_COLS == BN, "the warps cover the strip");

// shared-memory geometry of a stage's packed weight rows
template <int BITS>
struct Stage {
  using L = packing::Layout<BITS>;
  static constexpr int ROWS = KS / L::VALUES * L::BYTES;   // packed rows
  static constexpr int ROWS16 = 16 / L::VALUES * L::BYTES;  // a K step's
  // padding: at W2 and W4 lane t's first packed row starts 32t bytes
  // (mod 128) along, so a warp's 8-byte reads hit distinct banks
  static constexpr int PAD = BITS == 4 || BITS == 8 ? 16 : 32;
  static constexpr int RS = BN + PAD;                      // row stride
  static constexpr int BYTES = ROWS * RS;
};

// bytes a staged x row takes: KS values of x_bytes each, padded so that
// the rows of one read land 64 (f32), 32 (bf16) or 16 (int8) bytes apart
// mod 128
__host__ __device__ constexpr int x_stride(int x_bytes) {
  return KS * x_bytes + (x_bytes == 4 ? 64 : x_bytes == 2 ? 32 : 16);
}

// scale rows a stage holds: 1 for per-channel scales (G == 1) or a group
// of whole stages, the most groups a stage can touch for a group of whole
// K steps, and 0 for any other group (its scales are read per value from
// global memory)
__host__ __device__ constexpr int scale_rows(int K, int G) {
  return G == 1 || (K / G) % KS == 0 ? 1
         : (K / G) % 16 ? 0
         : ((KS - 16) / (K / G) + 2 < STEPS ? (KS - 16) / (K / G) + 2
                                             : STEPS);
}

template <int BITS>
__host__ __device__ constexpr int stage_bytes(int nt, int x_bytes, int srows) {
  return Stage<BITS>::BYTES + 8 * nt * x_stride(x_bytes) + srows * BN * 4;
}

__host__ inline int stage_bytes_for(int bits, int nt, int x_bytes,
                                    int srows) {
  switch (bits) {
    case 2: return stage_bytes<2>(nt, x_bytes, srows);
    case 3: return stage_bytes<3>(nt, x_bytes, srows);
    case 4: return stage_bytes<4>(nt, x_bytes, srows);
    default: return stage_bytes<8>(nt, x_bytes, srows);
  }
}

// ------------------------------------------------------------ the ring

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy `rows` rows of WIDTH bytes (a multiple of 16) into shared memory,
// row r at dst + r * dst_pitch, from global memory, row r at src + r *
// src_pitch: rows at or past valid_rows, and bytes at or past valid_bytes
// of a row, are zeros. `aligned`: src and src_pitch are multiples of 16,
// so each 16 bytes go by one cp.async (zero-filled past its source size);
// else byte loads and a 16-byte store (ragged N or K: slow, right).
// NTHREADS: the block's threads, which share the copies.
template <int WIDTH, int NTHREADS = THREADS>
__device__ __forceinline__ void copy_rows(uint8_t* dst, int dst_pitch,
                                          const uint8_t* src,
                                          size_t src_pitch, int rows,
                                          int valid_rows,
                                          long long valid_bytes,
                                          bool aligned) {
  constexpr int CH = WIDTH / 16;
  static_assert(WIDTH % 16 == 0, "whole 16-byte copies");
  for (int i = threadIdx.x; i < rows * CH; i += NTHREADS) {
    const int r = i / CH, c = (i % CH) * 16;
    const long long left = r < valid_rows ? valid_bytes - c : 0;
    const int nb = left <= 0 ? 0 : left >= 16 ? 16 : (int)left;
    uint8_t* d = dst + r * dst_pitch + c;
    const uint8_t* s = src + r * src_pitch + c;
    if (aligned) {
      cp_async16(d, nb ? s : src, nb);  // src: a valid address for 0 bytes
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      for (int b = 0; b < nb; ++b) w[b / 4] |= (uint32_t)s[b] << (8 * (b % 4));
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Where a block's stage `it` comes from: expert e's packed rows, its x
// chunk and its scale rows, and where in shared memory they go.
struct Tile {
  const uint8_t* qw;     // expert e's packed stack, column n0
  const uint8_t* x;      // expert e's x, capacity row c0 (bytes)
  const uint8_t* scale;  // expert e's scales, column n0 (bytes)
  int K, N, G, C, c0, n0, kb, x_bytes, cc, srows, packed_rows;
  bool aligned;
};

template <int BITS>
__device__ __forceinline__ void fetch_stage(const Tile& tl, uint8_t* st,
                                            int it) {
  using S = Stage<BITS>;
  using L = packing::Layout<BITS>;
  const int k0 = tl.kb + it * KS;
  const int pr0 = k0 / (int)L::VALUES * (int)L::BYTES;
  copy_rows<BN>(st, S::RS, tl.qw + (size_t)pr0 * tl.N, (size_t)tl.N, S::ROWS,
                tl.packed_rows - pr0, tl.N - tl.n0, tl.aligned);
  uint8_t* xs = st + S::BYTES;
  const int xw = x_stride(tl.x_bytes);
  if (tl.x_bytes == 4)
    copy_rows<KS * 4>(xs, xw, tl.x + (size_t)k0 * 4, (size_t)tl.K * 4, tl.cc,
                      tl.C - tl.c0, (long long)(tl.K - k0) * 4, tl.aligned);
  else if (tl.x_bytes == 2)
    copy_rows<KS * 2>(xs, xw, tl.x + (size_t)k0 * 2, (size_t)tl.K * 2, tl.cc,
                      tl.C - tl.c0, (long long)(tl.K - k0) * 2, tl.aligned);
  else
    copy_rows<KS>(xs, xw, tl.x + k0, (size_t)tl.K, tl.cc, tl.C - tl.c0,
                  (long long)(tl.K - k0), tl.aligned);
  if (tl.srows) {
    const int g0 = tl.G == 1 ? 0 : k0 / (tl.K / tl.G);
    copy_rows<BN * 4>(xs + tl.cc * xw, BN * 4,
                      tl.scale + (size_t)g0 * tl.N * 4, (size_t)tl.N * 4,
                      tl.srows, tl.G - g0, (long long)(tl.N - tl.n0) * 4,
                      tl.aligned);
  }
}

// ------------------------------------------------------- the fragments

// The lane's 4 K rows (4t .. 4t + 3 of the K step whose packed rows start
// at w, already offset to the lane's columns 8g) of its 8 columns, as
// byte planes: byte j of P[h][i] is the offset-binary value of K row
// 4t + i of column 8g + 4h + j. rs: the staged rows' stride.
template <int BITS>
__device__ __forceinline__ void load_planes(const uint8_t* w, int t,
                                            uint32_t P[2][4]) {
  constexpr int RS = Stage<BITS>::RS;
  if (BITS == 2) {
    // one packed row: K rows 4t .. 4t + 3 in bits 0-1, 2-3, 4-5, 6-7
    const uint2 v = *reinterpret_cast<const uint2*>(w + t * RS);
    const uint32_t h[2] = {v.x, v.y};
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) P[s][i] = (h[s] >> (2 * i)) & 0x03030303u;
  } else if (BITS == 4) {
    // rows 2t (K 4t, 4t + 1) and 2t + 1 (K 4t + 2, 4t + 3), low nibble first
    const uint2 a = *reinterpret_cast<const uint2*>(w + 2 * t * RS);
    const uint2 b = *reinterpret_cast<const uint2*>(w + (2 * t + 1) * RS);
    const uint32_t ha[2] = {a.x, a.y}, hb[2] = {b.x, b.y};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      P[s][0] = ha[s] & 0x0F0F0F0Fu;
      P[s][1] = (ha[s] >> 4) & 0x0F0F0F0Fu;
      P[s][2] = hb[s] & 0x0F0F0F0Fu;
      P[s][3] = (hb[s] >> 4) & 0x0F0F0F0Fu;
    }
  } else if (BITS == 8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint2 v = *reinterpret_cast<const uint2*>(w + (4 * t + i) * RS);
      P[0][i] = v.x;
      P[1][i] = v.y;
    }
  } else {
    // W3: a K step is two 8-value groups of 3 bytes; lane t takes values
    // 4h .. 4h + 3 (h = t % 2) of group t / 2: 12 bits that start in byte
    // h, so bytes h and h + 1 of the group, shifted right by 4h
    const int h = t & 1;
    const int ra = 3 * (t >> 1) + h;
    const uint2 a = *reinterpret_cast<const uint2*>(w + ra * RS);
    const uint2 b = *reinterpret_cast<const uint2*>(w + (ra + 1) * RS);
    const uint32_t ha[2] = {a.x, a.y}, hb[2] = {b.x, b.y};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      // columns 0, 1 in the low and high 16 bits; then columns 2, 3
      const uint32_t c01 = __byte_perm(ha[s], hb[s], 0x5140) >> (4 * h);
      const uint32_t c23 = __byte_perm(ha[s], hb[s], 0x7362) >> (4 * h);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        P[s][i] = __byte_perm((c01 >> (3 * i)) & 0x00070007u,
                              (c23 >> (3 * i)) & 0x00070007u, 0x6420);
    }
  }
}

// bf16 x2 of (lo, hi), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A (16 x 16 bf16, row-major) B (16 x 8 bf16, column-major), f32 sums
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A (16 x 16 u8, row-major) B (16 x 8 s8, column-major), exact int32
// sums (wrapping, so a sum whose true value fits int32 is exact however
// its partial sums run)
__device__ __forceinline__ void mma_u8s8(int d[4], uint32_t a0, uint32_t a1,
                                         uint32_t b) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.u8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// Write a lane's 8 contiguous outputs of one capacity row c (columns col ..
// col + 7, vals[0..7]) to row c of an (., N) f32 matrix, masking columns
// at or past N.
__device__ __forceinline__ void store8(float* row, int col, int N,
                                       const float vals[8], bool vec) {
  if (vec && col + 8 <= N) {
    *reinterpret_cast<float4*>(row + col) =
        make_float4(vals[0], vals[1], vals[2], vals[3]);
    *reinterpret_cast<float4*>(row + col + 4) =
        make_float4(vals[4], vals[5], vals[6], vals[7]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (col + i < N) row[col + i] = vals[i];
  }
}

// store8 into a bf16 row: the 8 values rounded to nearest even, one
// 16-byte store when vec (N a multiple of 8)
__device__ __forceinline__ void store8_bf16(__nv_bfloat16* row, int col,
                                            int N, const float vals[8],
                                            bool vec) {
  if (vec && col + 8 <= N) {
    *reinterpret_cast<uint4*>(row + col) = make_uint4(
        pack_bf16(vals[0], vals[1]), pack_bf16(vals[2], vals[3]),
        pack_bf16(vals[4], vals[5]), pack_bf16(vals[6], vals[7]));
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (col + i < N) row[col + i] = __float2bfloat16_rn(vals[i]);
  }
}

// true when every operand's rows start on 16 bytes (the cp.async path)
inline bool aligned16(const void* a, const void* b, const void* c, int N,
                      long long x_row_bytes) {
  return ((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) % 16 == 0 &&
         N % 16 == 0 && x_row_bytes % 16 == 0;
}

}  // namespace expert_stream
