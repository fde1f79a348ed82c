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
// factor 2 of x[0, c]), so the means the merges work with are O(std) and
// not O(|mean|).
//
// What bounds it on the H100, as the card showed it (H100 80GB HBM3, 700
// W; tools/stats_pack_sweep.py): bytes, at large T. Every element is read
// once (4 bytes f32, 2 bf16) for a few operations; the calibration set's
// 262,144 x 2048 f32 is 2.1 GB, 0.64 ms at 3.35 TB/s, and this kernel
// takes ~0.70 ms there (torch.var_mean ~0.77). A tweak step's 16,384 x
// 2048 (0.040 ms of bytes) takes ~0.063: the write-back of the dirty L2
// that a cold call meets and a fixed ~9 us of launch and merges. The
// first design (one scalar load per element, four block barriers a
// 256-row tile, nothing in flight while a tile reduced, a second launch to
// merge the row ranges) ran at a third of the bound, and as long in bf16
// as in f32: latency, not bytes. With its data in L2 this one still moved
// only ~2 TB/s until each copy lost its per-row branches and 64-bit
// products and each tile's loads were issued together, so the loop, not
// DRAM, was in the way. The design:
//
//   - a thread owns 16 bytes of a row (4 f32 or 8 bf16 channels) and
//     TILE rows of each stage; a block of 256 threads covers a strip of
//     STRIP channels, and the ranks of a thread-block cluster take every
//     ranks-th stage of the strip, so they sweep it together;
//   - each thread streams its own 16-byte slots through a ring of STAGES
//     stages in shared memory with cp.async (zero-filled past C), the
//     next stage in flight while it reduces one, so no block barrier runs
//     inside the walk; a row of C not a multiple of the vector width, or a
//     pointer not on 16 bytes, takes the same slots through scalar loads;
//   - a thread's tile is two-pass from registers (its 8 slots loaded at
//     once: sum, tile mean, sum of squared deviations), merged into the
//     thread's partial by Chan's formula; every partial keeps its mean as
//     a frame (its first tile's mean) plus an offset from it, so the long
//     serial merges of a large T round at the offset's scale, not at
//     |mean - x[0, c]|'s;
//   - at the end the block's row threads merge pairwise in a fixed tree
//     through shared memory, and rank 0 of the cluster merges the ranks'
//     partials in rank order through distributed shared memory and writes
//     shift + mean and M2 / T: one launch, no work buffer;
//   - the planner (kernels/channel_stats.py::plan_stats) launches about
//     one block for every other SM: on the card 96 blocks of 3 ranks beat
//     160-256 at every large shape, f32 and bf16.
//
// No atomics and a fixed order everywhere: the result depends only on the
// shape, so a tweak run repeats bit for bit (Adam turns last-bit gradient
// differences into whole learning-rate steps). The vector and the scalar
// path fill the same slots, so a pointer's alignment does not move a bit.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int STRIP = 64;       // channels a block
constexpr int TILE = 8;         // rows of a thread's tile, one slot each
constexpr int STAGES = 2;       // tiles of a thread in the ring
constexpr int MAX_RANKS = 8;    // the portable cluster size
constexpr int SLOT = 16;        // bytes a thread copies of a row
constexpr int STAGE_BYTES = TILE * THREADS * SLOT;
constexpr int SMEM = STAGES * STAGE_BYTES;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes, zero-filled past `bytes` (0: all zeros)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (n_a, frame_a + off_a, m2_a) += (n_b, frame_b + off_b, m2_b), Chan et
// al., in a's frame: the difference of the two means is taken frame from
// frame and offset from offset, so it rounds at their scale
__device__ __forceinline__ void chan_merge(float& n_a, float& frame_a,
                                           float& off_a, float& m2_a,
                                           float n_b, float frame_b,
                                           float off_b, float m2_b) {
  if (n_b == 0.f) return;
  if (n_a == 0.f) {
    n_a = n_b;
    frame_a = frame_b;
    off_a = off_b;
    m2_a = m2_b;
    return;
  }
  const float n = n_a + n_b;
  const float frac = n_b / n;
  const float delta = (frame_b - frame_a) + (off_b - off_a);
  off_a += delta * frac;
  m2_a += m2_b + delta * delta * n_a * frac;
  n_a = n;
}

// a 16-byte slot's values as floats (4 f32, or 8 bf16: a bf16 is the high
// half of its f32)
__device__ __forceinline__ void unpack(float (&v)[4], uint4 t) {
  v[0] = __uint_as_float(t.x);
  v[1] = __uint_as_float(t.y);
  v[2] = __uint_as_float(t.z);
  v[3] = __uint_as_float(t.w);
}

__device__ __forceinline__ void unpack(float (&v)[8], uint4 t) {
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// Two-pass statistics of a thread's tile, rows i < cnt of `raw` shifted by
// row 0: mean and sum of squared deviations per channel. FULL: cnt ==
// TILE, no row masked.
template <int CH, bool FULL>
__device__ __forceinline__ void tile_stats(const uint4 (&raw)[TILE], int cnt,
                                           const float (&shift)[CH],
                                           float (&mean)[CH],
                                           float (&dev)[CH]) {
#pragma unroll
  for (int j = 0; j < CH; ++j) mean[j] = dev[j] = 0.f;
#pragma unroll
  for (int i = 0; i < TILE; ++i) {
    float v[CH];
    unpack(v, raw[i]);
#pragma unroll
    for (int j = 0; j < CH; ++j)
      if (FULL || i < cnt) mean[j] += v[j] - shift[j];
  }
  const float inv = FULL ? 1.f / TILE : 1.f / (float)cnt;
#pragma unroll
  for (int j = 0; j < CH; ++j) mean[j] *= inv;
#pragma unroll
  for (int i = 0; i < TILE; ++i) {
    float v[CH];
    unpack(v, raw[i]);
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const float d = (v[j] - shift[j]) - mean[j];
      if (FULL || i < cnt) dev[j] += d * d;
    }
  }
}

// this thread's CH channels of row `row` into its 16-byte slot
template <typename T, bool VEC>
__device__ __forceinline__ void fill_slot(uint8_t* slot, const T* x,
                                          long long row, int c0, int C) {
  constexpr int CH = SLOT / (int)sizeof(T);
  if (VEC) {
    const bool in = c0 < C;
    cp_async16(slot, in ? x + row * C + c0 : x, in ? SLOT : 0);
  } else {
    T* d = reinterpret_cast<T*>(slot);
#pragma unroll
    for (int j = 0; j < CH; ++j)
      d[j] = c0 + j < C ? x[row * C + c0 + j] : T(0.f);
  }
}

// Grid (ranks, strips), cluster (ranks, 1, 1); the rows are cut into
// stages of STAGE_ROWS, and rank k takes stages k, k + ranks, k + 2 ranks,
// ..., so a cluster's ranks sweep the strip together.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
channel_stats_kernel(const T* __restrict__ x, int T_rows, int C,
                     float* __restrict__ mean, float* __restrict__ var) {
  constexpr int CH = SLOT / (int)sizeof(T);     // channels a thread
  constexpr int LANES = STRIP / CH;             // threads across the strip
  constexpr int RT = THREADS / LANES;           // row threads
  constexpr int STAGE_ROWS = RT * TILE;
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ranks = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid % LANES, ty = tid / LANES;
  const int c0 = blockIdx.y * STRIP + lane * CH;
  const int all_stages = (T_rows + STAGE_ROWS - 1) / STAGE_ROWS;
  const int stages = (all_stages - rank + ranks - 1) / ranks;   // this rank's

  // this rank's stage s: this thread's rows first_row(s) + i * RT
  auto first_row = [&](int s) {
    return (long long)(rank + s * ranks) * STAGE_ROWS + ty;
  };
  const bool c_in = c0 < C;   // else its slots are zero-filled
  const T* xc = x + (c_in ? c0 : 0);
  const long long row_step = (long long)RT * C;
  auto issue = [&](int s) {
    if (s < stages) {
      uint8_t* slot = smem + (s % STAGES) * STAGE_BYTES + tid * SLOT;
      const long long r = first_row(s);
      if (VEC && r + (TILE - 1) * RT < T_rows) {   // every row in range
        const T* p = xc + r * C;
#pragma unroll
        for (int i = 0; i < TILE; ++i, p += row_step)
          cp_async16(slot + i * THREADS * SLOT, p, c_in ? SLOT : 0);
      } else {
#pragma unroll
        for (int i = 0; i < TILE; ++i)
          if (r + i * RT < T_rows)
            fill_slot<T, VEC>(slot + i * THREADS * SLOT, x, r + i * RT, c0,
                              C);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES; ++s) issue(s);

  float shift[CH];   // row 0
#pragma unroll
  for (int j = 0; j < CH; ++j)
    shift[j] = c0 + j < C ? to_float(x[c0 + j]) : 0.f;
  float n = 0.f, frame[CH], off[CH], m2[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) frame[j] = off[j] = m2[j] = 0.f;

  for (int s = 0; s < stages; ++s) {
    cp_async_wait<STAGES - 1>();   // this thread's stage s has landed
    const uint8_t* base = smem + (s % STAGES) * STAGE_BYTES + tid * SLOT;
    uint4 raw[TILE];   // every slot at once (rows past T hold stale bytes)
#pragma unroll
    for (int i = 0; i < TILE; ++i)
      raw[i] = *reinterpret_cast<const uint4*>(base + i * THREADS * SLOT);
    const long long left = T_rows - first_row(s);
    const int cnt = left <= 0 ? 0 : (int)min((long long)TILE,
                                             (left + RT - 1) / RT);
    if (cnt > 0) {
      float tm[CH], dev[CH];
      if (cnt == TILE)
        tile_stats<CH, true>(raw, cnt, shift, tm, dev);
      else
        tile_stats<CH, false>(raw, cnt, shift, tm, dev);
      // Chan's merge of the tile into the thread's partial (the tile in
      // the frame 0, its mean as offset), with the weights the thread's
      // channels share
      const float fc = (float)cnt, nn = n + fc;
      const float frac = fc / nn, wgt = n * frac;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        if (n == 0.f) {
          frame[j] = tm[j];
          m2[j] = dev[j];
        } else {
          const float delta = (tm[j] - frame[j]) - off[j];
          off[j] += delta * frac;
          m2[j] += dev[j] + delta * delta * wgt;
        }
      }
      n = nn;
    }
    issue(s + STAGES);   // into the slots just read
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: the row threads' partials go there

  float* pn = reinterpret_cast<float*>(smem);
  float* pf = pn + RT * STRIP;
  float* po = pf + RT * STRIP;
  float* pm = po + RT * STRIP;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int e = ty * STRIP + lane * CH + j;
    pn[e] = n;
    pf[e] = frame[j];
    po[e] = off[j];
    pm[e] = m2[j];
  }
  // row threads merged pairwise: step 1 merges ty + 1 into ty (ty even),
  // step 2 ty + 2 into ty (ty % 4 == 0), ...; row thread 0 ends with the
  // block's partial
  for (int step = 1; step < RT; step *= 2) {
    __syncthreads();
    const int pairs = RT / (2 * step);
    for (int e = tid; e < pairs * STRIP; e += THREADS) {
      const int a = (e / STRIP) * 2 * step * STRIP + e % STRIP;
      const int b = a + step * STRIP;
      chan_merge(pn[a], pf[a], po[a], pm[a], pn[b], pf[b], po[b], pm[b]);
    }
  }
  cluster.sync();   // every rank's partial is in its shared memory

  if (rank == 0 && tid < STRIP) {
    float cn = pn[tid], cf = pf[tid], co = po[tid], cm = pm[tid];
    for (int k = 1; k < ranks; ++k)
      chan_merge(cn, cf, co, cm, *cluster.map_shared_rank(pn + tid, k),
                 *cluster.map_shared_rank(pf + tid, k),
                 *cluster.map_shared_rank(po + tid, k),
                 *cluster.map_shared_rank(pm + tid, k));
    const int c = blockIdx.y * STRIP + tid;
    if (c < C) {
      mean[c] = to_float(x[c]) + (cf + co);
      var[c] = cm / (float)T_rows;
    }
  }
  cluster.sync();   // the peers' shared memory stays until rank 0 has read
}

template <typename T, bool VEC>
cudaError_t launch(const void* x, void* mean, void* var, int T_rows, int C,
                   int ranks, cudaStream_t stream) {
  auto kernel = channel_stats_kernel<T, VEC>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e == cudaSuccess)   // room for 2 blocks an SM
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, (C + STRIP - 1) / STRIP, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), T_rows,
                            C, static_cast<float*>(mean),
                            static_cast<float*>(var));
}

}  // namespace

// x (T, C) f32 (bf16 when x_bf16), contiguous; mean and var (C,) f32.
// Each strip's cluster has `ranks` blocks, 1 <= ranks <= MAX_RANKS and no
// more than the stages of T (every rank takes at least one). vec: 16-byte
// copies, for C a multiple of the vector width (4 f32, 8 bf16) and x on 16
// bytes. Returns the CUDA error code of the launch (0 on success).
extern "C" int channel_stats(const void* x, void* mean, void* var,
                             int T_rows, int C, int ranks, int x_bf16,
                             int vec, void* stream) {
  const int width = x_bf16 ? 8 : 4;
  const int stage_rows = THREADS / (STRIP / width) * TILE;
  if (T_rows <= 0 || C <= 0 || ranks <= 0 || ranks > MAX_RANKS ||
      (C + STRIP - 1) / STRIP > 65535 ||
      (long long)(ranks - 1) * stage_rows >= T_rows ||
      (vec && (C % width || reinterpret_cast<uintptr_t>(x) % 16)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return vec ? launch<__nv_bfloat16, true>(x, mean, var, T_rows, C, ranks,
                                             s)
               : launch<__nv_bfloat16, false>(x, mean, var, T_rows, C, ranks,
                                              s);
  return vec ? launch<float, true>(x, mean, var, T_rows, C, ranks, s)
             : launch<float, false>(x, mean, var, T_rows, C, ranks, s);
}

// Clusters of `ranks` blocks that the current card holds at once (CUDA's
// occupancy calculator over shared memory, registers and the GPCs).
extern "C" int channel_stats_max_clusters(int ranks, int x_bf16,
                                          int* clusters) {
  if (ranks <= 0 || ranks > MAX_RANKS) return cudaErrorInvalidValue;
  const void* kernel =
      x_bf16 ? (const void*)channel_stats_kernel<__nv_bfloat16, true>
             : (const void*)channel_stats_kernel<float, true>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, 1024, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

extern "C" const char* channel_stats_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
