// Paged attention over a block table with inline int8-KV dequant, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_attention_pallas`
// (src/repro/kernels/paged_attention.py, body template.make_paged_kernel).
// For each (slot, kv-head) it walks the slot's block-table pages and folds
// each live page into an f32 online softmax over R = m_rows * G query rows
// (m-major: row r is the token at fill position kv_len - m_rows + r / G):
//
//   * a page is skipped when it starts at or beyond kv_len, when its table
//     entry is -1, or when it lies wholly behind the sliding window (the
//     window bound widened by m_rows - 1, as template.tile_live does);
//   * row r sees positions < kv_len - (m_rows - 1 - r / G) (and, with a
//     window, > that limit - 1 - window); masked scores are -1e30 and
//     their probabilities are zeroed explicitly;
//   * the final divide is guarded (max(l, 1e-30)), so a slot with
//     kv_len == 0 comes out as exact zeros.
//
// On the TPU the page walk is the sequential third grid axis, carrying
// (m, l, acc) in VMEM scratch from step to step. Blocks on this card run in
// no order, so the walk is a loop inside one block, which keeps (m, l, acc)
// in shared memory, and the block loads its own block-table row and fill
// count (there is no scalar prefetch).
//
// What bounds it on this card: reading the live K/V pages. A decode read
// does 4*R*hd operations per 2*hd*4 bytes of f32 K/V it reads (or half the
// bytes with int8), far below the card's ~295 operations per byte, so it is
// memory bound, and the bytes that count are those of the live pages only.
// What the design does about that: dead pages are never read, each live
// page is read once for all R rows of its kv head (GQA rows and verify
// rows share the read), and int8 pages are dequantized in shared memory,
// never written back. It is the simple first design: one block per (slot,
// kv head), pages loaded synchronously one at a time, scalar f32 dot
// products. Splitting long walks across blocks and overlapping the next
// page's load with this page's math is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr float NEG = -1e30f;

__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const float* __restrict__ q, const void* k_pool,
                       const void* v_pool, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ block_table,
                       const int* __restrict__ kv_len, float* __restrict__ out,
                       int KVH, int R, int HD, int HDV, int PS, int W,
                       int m_rows, int window, float sm_scale, int quant) {
  extern __shared__ float smem[];
  const int KLD = HD + 1;  // padded K rows: consecutive t hit other banks
  float* qs = smem;                  // R x HD
  float* ks = qs + R * HD;           // PS x KLD
  float* vs = ks + PS * KLD;         // PS x HDV
  float* ps = vs + PS * HDV;         // R x PS: scores, then probabilities
  float* acc = ps + R * PS;          // R x HDV
  float* m_run = acc + R * HDV;      // R
  float* l_run = m_run + R;          // R
  float* corr = l_run + R;           // R

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int G = R / m_rows;
  const int kl = kv_len[s];

  const float* qp = q + (size_t)(s * KVH + h) * R * HD;
  for (int i = tid; i < R * HD; i += THREADS) qs[i] = qp[i];
  for (int i = tid; i < R * HDV; i += THREADS) acc[i] = 0.0f;
  for (int i = tid; i < R; i += THREADS) {
    m_run[i] = NEG;
    l_run[i] = 0.0f;
  }
  __syncthreads();

  for (int w = 0; w < W; ++w) {
    const int base = w * PS;
    const int page = block_table[(size_t)s * W + w];
    bool live = base < kl && page >= 0;
    if (window >= 0) live = live && base + PS > kl - (m_rows - 1) - window;
    if (!live) continue;  // the same for every thread of the block

    const size_t tok0 = (size_t)page * PS;
    for (int i = tid; i < PS * HD; i += THREADS) {
      const int t = i / HD, d = i % HD;
      const size_t tok = (tok0 + t) * KVH + h;
      ks[t * KLD + d] =
          quant ? (float)((const int8_t*)k_pool)[tok * HD + d] * k_scale[tok]
                : ((const float*)k_pool)[tok * HD + d];
    }
    for (int i = tid; i < PS * HDV; i += THREADS) {
      const int t = i / HDV, d = i % HDV;
      const size_t tok = (tok0 + t) * KVH + h;
      vs[i] = quant
                  ? (float)((const int8_t*)v_pool)[tok * HDV + d] * v_scale[tok]
                  : ((const float*)v_pool)[tok * HDV + d];
    }
    __syncthreads();

    for (int i = tid; i < R * PS; i += THREADS) {
      const int r = i / PS, t = i % PS;
      float dot = 0.0f;
      for (int d = 0; d < HD; ++d) dot += qs[r * HD + d] * ks[t * KLD + d];
      const int pos = base + t;
      const int lim = kl - (m_rows - 1 - r / G);
      bool valid = pos < lim;
      if (window >= 0) valid = valid && pos > lim - 1 - window;
      ps[i] = valid ? dot * sm_scale : NEG;
    }
    __syncthreads();

    for (int r = tid; r < R; r += THREADS) {
      const int lim = kl - (m_rows - 1 - r / G);
      float m_new = m_run[r];
      for (int t = 0; t < PS; ++t) m_new = fmaxf(m_new, ps[r * PS + t]);
      float sum = 0.0f;
      for (int t = 0; t < PS; ++t) {
        const int pos = base + t;
        bool valid = pos < lim;
        if (window >= 0) valid = valid && pos > lim - 1 - window;
        // a live page can lie wholly outside an early row's reach
        // (m_rows > 1); that row's max is still NEG, so zero masked
        // columns explicitly instead of trusting exp to underflow
        const float p = valid ? expf(ps[r * PS + t] - m_new) : 0.0f;
        ps[r * PS + t] = p;
        sum += p;
      }
      const float c = expf(m_run[r] - m_new);
      corr[r] = c;
      l_run[r] = l_run[r] * c + sum;
      m_run[r] = m_new;
    }
    __syncthreads();

    for (int i = tid; i < R * HDV; i += THREADS) {
      const int r = i / HDV, d = i % HDV;
      float pv = 0.0f;
      for (int t = 0; t < PS; ++t) pv += ps[r * PS + t] * vs[t * HDV + d];
      acc[i] = acc[i] * corr[r] + pv;
    }
    __syncthreads();
  }

  float* op = out + (size_t)(s * KVH + h) * R * HDV;
  for (int i = tid; i < R * HDV; i += THREADS)
    op[i] = acc[i] / fmaxf(l_run[i / HDV], 1e-30f);
}

}  // namespace

// q (S, KVH, R, HD) f32; pools (P, PS, KVH, HD[V]) f32, or int8 with
// (P, PS, KVH) f32 scale pools when quant != 0; block_table (S, W) int32;
// kv_len (S,) int32 -> out (S, KVH, R, HDV) f32. window < 0 means none.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int paged_attention(const void* q, const void* k_pool,
                               const void* v_pool, const void* k_scale,
                               const void* v_scale, const void* block_table,
                               const void* kv_len, void* out, int S, int KVH,
                               int R, int HD, int HDV, int PS, int W,
                               int m_rows, int window, float sm_scale,
                               int quant, void* stream) {
  if (S <= 0 || KVH <= 0 || R <= 0 || HD <= 0 || HDV <= 0 || PS <= 0 ||
      W <= 0 || m_rows <= 0 || R % m_rows != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)R * HD + (size_t)PS * (HD + 1) +
                                       (size_t)PS * HDV + (size_t)R * PS +
                                       (size_t)R * HDV + 3 * (size_t)R);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(S, KVH);
  paged_attention_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, k_pool, v_pool, (const float*)k_scale,
      (const float*)v_scale, (const int*)block_table, (const int*)kv_len,
      (float*)out, KVH, R, HD, HDV, PS, W, m_rows, window, sm_scale, quant);
  return (int)cudaGetLastError();
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
