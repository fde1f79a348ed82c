// RTN quantize + pack of low-bit weights on Hopper (sm_90a).
//
// Replaces the TPU kernel `quantize_pack_pallas`
// (src/repro/kernels/quantize.py). For a stack of B weights w (B, K, N),
// f32 or bf16, with scales (B, G, N) f32, it writes the packed layout of
// core/quant/types.py (packing.cuh):
//
//   q[b, k, n] = clip(round_half_even(w[b, k, n] / scale[b, k / rows, n]),
//                     -QMAX, QMAX)        rows = K / G
//
// stored offset-binary (q + QMAX) along K, VALUES to a packed group; the
// rows of the last group past K are zero fields, as types.pack pads them.
//
// What bounds it on the H100, as the card showed it (H100 80GB HBM3, 700
// W; tools/stats_pack_sweep.py): bytes, with the divisions overlapped,
// at the deploy stacks. Each weight value is read once (4 or 2 bytes) and
// becomes bits / 8 bytes of output: serve_w4's 16 x 2048 x 8192 f32 stack
// is 1.2 GB, 0.36 ms at 3.35 TB/s, and this kernel takes ~0.43 ms (the
// first design 0.95). Its 268 M IEEE divisions are some 0.1-0.15 ms of
// issue at the full SM rate, so they run while other warps' loads are in
// flight. The first design gave a thread one packed group of one column
// (8 bytes in flight, two divisions, a 1-byte store, half a million
// blocks that each lived for about one memory round trip) and ran at
// 0.19-0.38 of the bound at every size: issue and latency, not bytes. At
// a single 2048 x 2048 weight (17 MB) the call is one round trip and a
// launch, ~0.016 ms against 0.006 of bytes. The design:
//
//   - a thread owns COLS = 4 consecutive columns and a run of RUN_ROWS
//     rows down K (RUN_ROWS / VALUES packed groups); all of the run's
//     loads (16 bytes a row f32, 8 bf16) are issued before its first
//     division, 128 bytes a thread in flight at f32 (runs of 16 rows, more
//     bytes and registers a thread, were slower on the card);
//   - the run's scale row is one 16-byte load, and a counter steps it
//     down the run where a group ends inside it (groups of 3 rows, say;
//     never for g128 or per-channel scales), so no division by the
//     group's rows is left in the loop;
//   - the packed bytes of a row of the layout go out as one 4-byte store
//     of the 4 columns (W3's 3-byte words as three such rows);
//   - a tile of 32 column quads x RUNS runs is a block's unit of work,
//     and a grid of 16 blocks for each SM walks the tiles
//     (kernels/quantize_pack.py::plan_pack);
//   - N not a multiple of 4, or a pointer off the vector alignment, takes
//     the same walk with scalar loads and 1-byte stores.
//
// The bytes must equal the plain version's exactly: the quotient is IEEE
// division (__fdiv_rn; never a multiply by 1/s), rounded half to even by
// rintf (roundf rounds half away from zero), clipped after rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "packing.cuh"

namespace {

constexpr int QUADS = 32;       // column quads a tile (threadIdx.x)
constexpr int RUNS = 8;         // runs a tile (threadIdx.y)
constexpr int THREADS = QUADS * RUNS;
constexpr int COLS = 4;         // columns a thread
constexpr int RUN_ROWS = 8;     // rows of K a thread's run

__device__ __forceinline__ void load_cols(float (&v)[COLS],
                                          const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load_cols(float (&v)[COLS],
                                          const __nv_bfloat16* p) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// columns n .. n + COLS - 1 of a row, those past N as 0
template <bool VEC, typename T>
__device__ __forceinline__ void load_row(float (&v)[COLS], const T* p,
                                         int cols) {
  if (VEC) {
    load_cols(v, p);
  } else {
#pragma unroll
    for (int c = 0; c < COLS; ++c) v[c] = c < cols ? to_float(p[c]) : 0.f;
  }
}

// byte `byte` of each column's word, as one row of the packed layout
template <bool VEC>
__device__ __forceinline__ void store_row(uint8_t* p,
                                          const uint32_t (&word)[COLS],
                                          int byte, int cols) {
  if (VEC) {
    uint32_t packed = 0;
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      packed |= ((word[c] >> (8 * byte)) & 0xffu) << (8 * c);
    *reinterpret_cast<uint32_t*>(p) = packed;
  } else {
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      if (c < cols) p[c] = (uint8_t)(word[c] >> (8 * byte));
  }
}

// Tile t = ((b * run_blocks) + rb) * quad_blocks + qb: stack index b,
// runs rb * RUNS .. + RUNS - 1, column quads qb * QUADS .. + QUADS - 1.
template <int BITS, typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
quantize_pack_kernel(const T* __restrict__ w, const float* __restrict__ scale,
                     uint8_t* __restrict__ out, int K, int N, int G,
                     int rows_per_group, int packed_groups, int quad_blocks,
                     int run_blocks, int tiles) {
  using L = packing::Layout<BITS>;
  constexpr int VALUES = (int)L::VALUES;
  constexpr int RUN = RUN_ROWS / VALUES;   // packed groups a run
  static_assert(RUN * VALUES == RUN_ROWS, "a run is whole packed groups");
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int qb = tile % quad_blocks;
    const int rest = tile / quad_blocks;
    const int rb = rest % run_blocks;
    const long long b = rest / run_blocks;
    const int n = (qb * QUADS + (int)threadIdx.x) * COLS;
    const int p0 = (rb * RUNS + (int)threadIdx.y) * RUN;
    if (n >= N || p0 >= packed_groups) continue;
    const int k0 = p0 * VALUES;
    const int cols = N - n;
    const T* wb = w + (b * K + k0) * N + n;
    const float* sb = scale + b * G * (long long)N + n;

    float v[RUN_ROWS][COLS];   // the run's loads, all before a division
#pragma unroll
    for (int i = 0; i < RUN_ROWS; ++i) {
      if (k0 + i < K) {
        load_row<VEC>(v[i], wb + (long long)i * N, cols);
      } else {
#pragma unroll
        for (int c = 0; c < COLS; ++c) v[i][c] = 0.f;
      }
    }
    int g = k0 / rows_per_group;          // the run's first scale row
    int left = (g + 1) * rows_per_group - k0;   // its rows from k0 on
    float s[COLS];
    load_row<VEC>(s, sb + (long long)g * N, cols);

    uint8_t* ob =
        out + (b * packed_groups + p0) * L::BYTES * (long long)N + n;
#pragma unroll
    for (int p = 0; p < RUN; ++p) {
      if (p0 + p < packed_groups) {
        uint32_t word[COLS] = {};
#pragma unroll
        for (int vi = 0; vi < VALUES; ++vi) {
          const int i = p * VALUES + vi;
          if (k0 + i < K) {
            if (left == 0) {   // the next scale row
              ++g;
              left = rows_per_group;
              load_row<VEC>(s, sb + (long long)g * N, cols);
            }
            --left;
#pragma unroll
            for (int c = 0; c < COLS; ++c) {
              float q = rintf(__fdiv_rn(v[i][c], s[c]));
              q = fminf(fmaxf(q, (float)-L::QMAX), (float)L::QMAX);
              word[c] |= (uint32_t)((int)q + L::QMAX) << (BITS * vi);
            }
          }
        }
#pragma unroll
        for (int byte = 0; byte < (int)L::BYTES; ++byte)
          store_row<VEC>(ob + ((long long)p * L::BYTES + byte) * N, word,
                         byte, cols);
      }
    }
  }
}

template <int BITS, typename T, bool VEC>
cudaError_t launch(const void* w, const void* scale, void* out, int B, int K,
                   int N, int G, int blocks, cudaStream_t stream) {
  using L = packing::Layout<BITS>;
  constexpr int RUN = RUN_ROWS / (int)L::VALUES;
  const int packed_groups = (K + (int)L::VALUES - 1) / (int)L::VALUES;
  const int quad_blocks = (N + QUADS * COLS - 1) / (QUADS * COLS);
  const int run_blocks = (packed_groups + RUN * RUNS - 1) / (RUN * RUNS);
  const long long tiles = (long long)B * run_blocks * quad_blocks;
  if (tiles > 0x7fffffff || blocks <= 0) return cudaErrorInvalidValue;
  quantize_pack_kernel<BITS, T, VEC><<<blocks, dim3(QUADS, RUNS), 0, stream>>>(
      static_cast<const T*>(w), static_cast<const float*>(scale),
      static_cast<uint8_t*>(out), K, N, G, K / G, packed_groups, quad_blocks,
      run_blocks, (int)tiles);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t dispatch(const void* w, const void* scale, void* out, int B,
                     int K, int N, int G, int bits, int blocks,
                     cudaStream_t s) {
  switch (bits) {
    case 2: return launch<2, T, VEC>(w, scale, out, B, K, N, G, blocks, s);
    case 3: return launch<3, T, VEC>(w, scale, out, B, K, N, G, blocks, s);
    case 4: return launch<4, T, VEC>(w, scale, out, B, K, N, G, blocks, s);
    case 8: return launch<8, T, VEC>(w, scale, out, B, K, N, G, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// w (B, K, N) f32 (bf16 when w_bf16), scale (B, G, N) f32 with G dividing
// K, out (B, packed_rows(K), N) uint8, all contiguous on the current
// device; `blocks` blocks walk the tiles. vec: N a multiple of 4, w and
// scale on 16 bytes (w on 8 when bf16) and out on 4. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int quantize_pack(const void* w, const void* scale, void* out,
                             int B, int K, int N, int G, int bits, int w_bf16,
                             int vec, int blocks, void* stream) {
  if (B <= 0 || K <= 0 || N <= 0 || G <= 0 || K % G)
    return cudaErrorInvalidValue;
  if (vec && (N % COLS ||
              reinterpret_cast<uintptr_t>(w) % (w_bf16 ? 8 : 16) ||
              reinterpret_cast<uintptr_t>(scale) % 16 ||
              reinterpret_cast<uintptr_t>(out) % 4))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16)
    return vec ? dispatch<__nv_bfloat16, true>(w, scale, out, B, K, N, G,
                                               bits, blocks, s)
               : dispatch<__nv_bfloat16, false>(w, scale, out, B, K, N, G,
                                                bits, blocks, s);
  return vec ? dispatch<float, true>(w, scale, out, B, K, N, G, bits, blocks,
                                     s)
             : dispatch<float, false>(w, scale, out, B, K, N, G, bits, blocks,
                                      s);
}

extern "C" const char* quantize_pack_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
