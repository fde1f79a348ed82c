// Per-channel mean and population variance of a (T, C) activation on
// Hopper (sm_90a): the statistics of the norm tweak's channel-wise
// distribution loss (paper Eq. 2).
//
// Replaces the TPU kernel `channel_stats_pallas`
// (src/repro/kernels/channel_stats.py). The TPU kernel sums x and x^2 in
// one pass and returns sum(x^2) / T - mean^2, which cancels
// catastrophically when |mean| >> std (at mean 1e3 and std 1, f32 keeps
// no correct digit of the variance). The loss the port computes with it
// (core/normtweak/losses.py, as the JAX package's) takes the two-pass
// variance; this kernel computes that function: exact per-tile two-pass
// statistics merged with Chan's formula, on values shifted by the
// channel's first row (x - x[0, c] is exact while x stays within a
// factor 2 of x[0, c]), so the means the merge works with are O(std) and
// not O(|mean|), and their f32 rounding stays far below the variance at
// any mean (unshifted, the merge's deltas of two means near 1e3 carry
// errors of 1e-4 into a variance of 1).
//
// What bounds it on the H100: bytes. Every element is read once (4 bytes
// f32, 2 bf16) for a few operations; 16384 x 2048 f32 (one tweak step's
// output) is 134 MB, 0.040 ms at 3.35 TB/s. The design:
//
//   stage 1: a block of 32 x 8 threads owns a strip of 32 channels and a
//     range of rows; it walks the range in tiles of 256 rows. Each thread
//     loads its 32 rows of its channel, shifted, into registers (warp
//     loads are contiguous along C; 32 independent loads in flight),
//     the tile's sum is reduced over the 8 row-threads in a fixed order
//     to the tile mean, then sum (x - tile mean)^2 likewise: a two-pass
//     result from one read of memory. Tiles merge into the block's
//     running (count, mean, M2) with Chan's formula, in tile order;
//   stage 2: one thread per channel merges the blocks' partials over the
//     row ranges, in range order, and writes shift + mean and M2 / T.
//
// No atomics and a fixed order everywhere: the result depends only on the
// shape, so a tweak run repeats bit for bit (Adam turns last-bit gradient
// differences into whole learning-rate steps).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STRIP = 32;                  // channels a block (threadIdx.x)
constexpr int ROW_THREADS = 8;             // threadIdx.y
constexpr int ROWS_PER_THREAD = 32;
constexpr int TILE_ROWS = ROW_THREADS * ROWS_PER_THREAD;   // 256

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// (n_a, mean_a, m2_a) += (n_b, mean_b, m2_b), Chan et al.
__device__ __forceinline__ void chan_merge(float& n_a, float& mean_a,
                                           float& m2_a, float n_b,
                                           float mean_b, float m2_b) {
  const float n = n_a + n_b;
  if (n_b == 0.f) return;
  const float delta = mean_b - mean_a;
  const float frac = n_b / n;
  mean_a += delta * frac;
  m2_a += m2_b + delta * delta * n_a * frac;
  n_a = n;
}

template <typename T>
__global__ void __launch_bounds__(STRIP * ROW_THREADS)
channel_stats_partial(const T* __restrict__ x, int T_rows, int C,
                      int rows_per_range, float* __restrict__ part_mean,
                      float* __restrict__ part_m2) {
  __shared__ float red[ROW_THREADS][STRIP];
  __shared__ float tile_mean[STRIP];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * STRIP + tx;
  const int range = blockIdx.y;
  const int r0 = range * rows_per_range;
  const int r1 = min(T_rows, r0 + rows_per_range);
  const float shift = c < C ? to_float(x[c]) : 0.f;   // row 0
  float run_n = 0.f, run_mean = 0.f, run_m2 = 0.f;   // valid in ty == 0
  for (int tile = r0; tile < r1; tile += TILE_ROWS) {
    // this thread's rows: tile + ty + ROW_THREADS * i
    float v[ROWS_PER_THREAD];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i) {
      const int r = tile + ty + ROW_THREADS * i;
      v[i] = (r < r1 && c < C) ? to_float(x[(long long)r * C + c]) - shift
                               : 0.f;
      sum += v[i];
    }
    const int cnt = min(TILE_ROWS, r1 - tile);
    red[ty][tx] = sum;
    __syncthreads();
    if (ty == 0) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < ROW_THREADS; ++j) s += red[j][tx];
      tile_mean[tx] = s / (float)cnt;
    }
    __syncthreads();
    const float mu = tile_mean[tx];
    float m2 = 0.f;
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i) {
      const int r = tile + ty + ROW_THREADS * i;
      const float d = v[i] - mu;
      m2 += (r < r1) ? d * d : 0.f;
    }
    red[ty][tx] = m2;
    __syncthreads();
    if (ty == 0) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < ROW_THREADS; ++j) s += red[j][tx];
      chan_merge(run_n, run_mean, run_m2, (float)cnt, mu, s);
    }
    __syncthreads();
  }
  if (ty == 0 && c < C) {
    part_mean[(long long)range * C + c] = run_mean;
    part_m2[(long long)range * C + c] = run_m2;
  }
}

template <typename T>
__global__ void channel_stats_merge(const T* __restrict__ x,
                                    const float* __restrict__ part_mean,
                                    const float* __restrict__ part_m2,
                                    int T_rows, int C, int rows_per_range,
                                    int ranges, float* __restrict__ mean,
                                    float* __restrict__ var) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float n = 0.f, mu = 0.f, m2 = 0.f;
  for (int r = 0; r < ranges; ++r) {
    const float cnt =
        (float)min(rows_per_range, T_rows - r * rows_per_range);
    chan_merge(n, mu, m2, cnt, part_mean[(long long)r * C + c],
               part_m2[(long long)r * C + c]);
  }
  mean[c] = to_float(x[c]) + mu;
  var[c] = m2 / (float)T_rows;
}

template <typename T>
cudaError_t launch(const void* x, void* mean, void* var, void* work,
                   int T_rows, int C, int rows_per_range, int ranges,
                   cudaStream_t stream) {
  float* part_mean = static_cast<float*>(work);
  float* part_m2 = part_mean + (long long)ranges * C;
  dim3 grid((C + STRIP - 1) / STRIP, ranges);
  channel_stats_partial<T><<<grid, dim3(STRIP, ROW_THREADS), 0, stream>>>(
      static_cast<const T*>(x), T_rows, C, rows_per_range, part_mean,
      part_m2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  channel_stats_merge<T><<<(C + 255) / 256, 256, 0, stream>>>(
      static_cast<const T*>(x), part_mean, part_m2, T_rows, C,
      rows_per_range, ranges,
      static_cast<float*>(mean), static_cast<float*>(var));
  return cudaGetLastError();
}

}  // namespace

// x (T, C) f32 (bf16 when x_bf16), contiguous; mean and var (C,) f32;
// work 2 * ranges * C f32. Row range r covers rows [r * rows_per_range,
// min(T, (r + 1) * rows_per_range)); ranges * rows_per_range >= T, every
// range non-empty, ranges <= 65535. Returns the CUDA error code of the
// launches (0 on success).
extern "C" int channel_stats(const void* x, void* mean, void* var, void* work,
                             int T_rows, int C, int rows_per_range, int ranges,
                             int x_bf16, void* stream) {
  if (T_rows <= 0 || C <= 0 || rows_per_range <= 0 || ranges <= 0 ||
      ranges > 65535 || (long long)(ranges - 1) * rows_per_range >= T_rows ||
      (long long)ranges * rows_per_range < T_rows)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(x, mean, var, work, T_rows, C,
                                        rows_per_range, ranges, s)
                : launch<float>(x, mean, var, work, T_rows, C, rows_per_range,
                                ranges, s);
}

extern "C" const char* channel_stats_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
