// Paged attention over a block table with inline int8-KV dequant, for
// Hopper (sm_90a). Three pool types: f32, bf16 (each element upcast to
// f32 as it is read, as the TPU kernel upcasts its bf16 pools) and int8
// with f32 scale pools; q f32 or bf16 (upcast into shared memory), the
// output f32 or bf16 (one rounding of the f32 result).
//
// Replaces the TPU kernel `paged_attention_pallas`
// (src/repro/kernels/paged_attention.py, body template.make_paged_kernel).
// For each (slot, kv-head) it folds the live tokens of the slot's
// block-table pages into an f32 online softmax over R = m_rows * G query
// rows (m-major: row r is the token at fill position kv_len - m_rows +
// r / G):
//
//   * a page is dead when it starts at or beyond kv_len, when its table
//     entry is -1, or when it lies wholly behind the sliding window (the
//     window bound widened by m_rows - 1, as template.tile_live does);
//   * row r sees positions < kv_len - (m_rows - 1 - r / G) (and, with a
//     window, > that limit - 1 - window); masked scores are -1e30 and
//     their probabilities are zeroed explicitly;
//   * the final divide is guarded (max(l, 1e-30)), so a slot with
//     kv_len == 0 comes out as exact zeros.
//
// What bounds it on this card: reading the live K/V pages. A decode read
// does ~4 * R * hd operations per 2 * hd * 4 bytes of f32 K/V (half the
// bytes with bf16, a quarter with int8): 2-12 operations a byte for R
// from 4 to 24 at f32, far below
// the ~20 f32 operations a byte the card's CUDA cores can do per byte of
// memory rate, so the bytes of the live pages set the time, and the
// design's job is to keep bytes in flight on every SM and the math per
// byte short enough to hide under them.
//
// On the TPU the page walk is the sequential third grid axis, carrying
// (m, l, acc) in VMEM scratch. Here one launch splits each (slot, kv
// head)'s walk over a thread-block cluster of n_split <= 8 blocks (grid
// (n_split, S * KVH, row chunks), cluster (n_split, 1, 1); n_split is
// chosen on the host by kernels/paged_attention.py::plan_paged from
// shapes alone; a block takes RC = 2, 4, 6 or 8 of the R rows):
//
//   * each block reads its slot's kv_len and works out the live page range
//     on the device (the first page not wholly behind the window up to
//     the last page below the fill), and takes its own contiguous
//     1/n_split share of it, so the split follows the live pages, not the
//     table width, and needs no host sync. A block whose share is empty
//     keeps an empty partial (m = -1e30, l = 0, acc = 0);
//   * the share is walked in tiles of TT = 32 tokens through a ring of
//     STAGES = 3 tiles in shared memory, filled by 16-byte cp.async copies
//     (hd is a multiple of 4 with f32 pools, of 8 with bf16, of 16 with
//     int8, so a token's head row is whole 16-byte units): the copies of
//     tile i + 2 start
//     before tile i's math. Each tile's token rows (page id x page
//     size x kv heads, or -1 for a dead token) are worked out one tile
//     ahead into a small table, so the copy loop does no division. Dead
//     tokens are zero-filled by the copy's source size and masked. bf16
//     and int8 K/V stay so in shared memory and are upcast in registers:
//     an int8 K scale scales the dot product and its V scale the
//     probability, never written back;
//   * each of the 4 warps runs its own online softmax over 8 tokens of
//     every tile (4 lanes a token, each a quarter of the head row; warp
//     shuffles reduce the dot products and the rows' max and sum, all
//     rows' shuffles of a step sent together), then adds its tokens'
//     P.V to RC rows x 4 columns a lane in registers, so a tile needs one
//     block barrier (the ring's) and no phase runs on a few threads;
//   * after the walk the block merges its warps' partials in warp order,
//     and the cluster's rank-0 block reads every rank's partial through
//     distributed shared memory after cluster.sync(), merges them in rank
//     order (a partial with l = 0 weighs 0) and writes the output; a
//     second cluster.sync() keeps the peers' shared memory alive until
//     then. No global workspace, no atomics, no second launch: the result
//     depends only on the shapes and the data, and repeats bit for bit.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TT = 32;          // tokens a tile
constexpr int TW = TT / WARPS;  // tokens a warp takes of each tile
constexpr int STAGES = 3;       // tiles in the ring (2 in flight)
constexpr int MAX_SPLIT = 8;    // the portable cluster size
constexpr int MAX_HDV = 128;    // a lane holds 4 columns of the output
constexpr int MAX_SMEM = 232448;
constexpr float NEG = -1e30f;

inline int align16(long long x) { return (int)((x + 15) / 16 * 16); }

// Shared-memory layout of one launch, from its shapes
// (kernels/paged_attention.py::geometry mirrors it):
//   ring  STAGES tiles: TT K rows of ksb bytes, TT V rows of vsb bytes
//         (es bytes an element: 4 f32, 2 bf16, 1 int8), with int8 pools
//         TT K scales and TT V scales (f32); after the
//         walk it holds the warps' partial acc, WARPS x rc x HDV f32
//   q     the block's rc rows x HD f32
//   pw    each warp's probabilities, WARPS x TW x rc f32 (rc padded to
//         a multiple of 4)
//   red   the merges' m, l and weights, RED x rc f32
//   tab   the token rows of STAGES + 1 tiles, TT ints each
//   bt    the slot's block-table row, W ints
constexpr int RED = 3 * WARPS + 3 + MAX_SPLIT;
struct Geo {
  int ksb, vsb, stage, q_off, pw_off, red_off, tab_off, bt_off, smem;
  int rc, chunks;
};

// the pool types, by their kernel parameter `kind`
constexpr int KV_F32 = 0, KV_INT8 = 1, KV_BF16 = 2;

Geo geometry(int R, int HD, int HDV, int W, int kind) {
  Geo g;
  const int quant = kind == KV_INT8;
  const int es = kind == KV_INT8 ? 1 : kind == KV_BF16 ? 2 : 4;
  // K rows padded to 4 mod 8 16-byte units: the 8 lanes of a quarter warp
  // (2 tokens x 4 quarters of a row) hit 8 distinct bank groups
  const int u0 = HD * es / 16;
  g.ksb = 16 * (u0 + (12 - u0 % 8) % 8);
  g.vsb = HDV * es;
  g.stage = TT * (g.ksb + g.vsb) + (quant ? 2 * TT * 4 : 0);
  g.rc = R <= 2 ? 2 : R <= 4 ? 4 : R <= 6 ? 6 : 8;
  g.chunks = (R + g.rc - 1) / g.rc;
  const long long ring = (long long)STAGES * g.stage;
  const long long part = (long long)WARPS * g.rc * HDV * 4;
  g.q_off = align16(ring > part ? ring : part);
  g.pw_off = g.q_off + align16((long long)g.rc * HD * 4);
  g.red_off = g.pw_off + WARPS * TW * ((g.rc + 3) / 4 * 4) * 4;
  g.tab_off = g.red_off + align16(RED * g.rc * 4);
  g.bt_off = g.tab_off + (STAGES + 1) * TT * 4;
  g.smem = g.bt_off + align16(4LL * W);
  return g;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// copies of 16 (or 4) bytes, zero-filled past `bytes` (0: all zeros)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
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

__device__ __forceinline__ float4 to_float4(char4 c) {
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}

// f32 of bf16 pairs: w holds (lo, hi), lo in the low half
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xFFFF0000u));
}

__device__ __forceinline__ float4 bf16x4_to_float4(uint2 w) {
  const float2 a = bf16x2_to_float2(w.x), b = bf16x2_to_float2(w.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void fma4(float p, float4 v, float4& a) {
  a.x = fmaf(p, v.x, a.x);
  a.y = fmaf(p, v.y, a.y);
  a.z = fmaf(p, v.z, a.z);
  a.w = fmaf(p, v.w, a.w);
}

// KIND: the pools' type (KV_F32, KV_INT8, KV_BF16). q_bf16 / out_bf16: q
// and out are bf16, else f32
template <int KIND, int RC>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const void* q, const void* k_pool,
                       const void* v_pool, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ block_table,
                       const int* __restrict__ kv_len, void* out,
                       int KVH, int R, int HD, int HDV, int PS, int W,
                       int m_rows, int window, float sm_scale, int n_split,
                       int q_bf16, int out_bf16, Geo g) {
  constexpr bool QUANT = KIND == KV_INT8, BF16 = KIND == KV_BF16;
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int sh = blockIdx.y;  // slot * KVH + kv head
  const int s = sh / KVH, h = sh % KVH;
  const int r_base = blockIdx.z * RC;  // this block's rows
  const int nr = min(RC, R - r_base);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = R / m_rows;

  float* qs = (float*)(smem + g.q_off);
  constexpr int RP = (RC + 3) / 4 * 4;  // a token's probabilities, padded
  float* pw = (float*)(smem + g.pw_off) + warp * TW * RP;
  float* red = (float*)(smem + g.red_off);
  int* tab = (int*)(smem + g.tab_off);
  int* bts = (int*)(smem + g.bt_off);

  // q rows and the block-table row are in flight while kv_len arrives (a
  // bf16 q is upcast as it is stored)
  const size_t q0 = ((size_t)sh * R + r_base) * HD;
  if (q_bf16) {
    const __nv_bfloat16* qsrc = (const __nv_bfloat16*)q + q0;
    for (int i = tid; i < nr * HD; i += THREADS)
      qs[i] = __bfloat162float(qsrc[i]);
  } else {
    const float* qsrc = (const float*)q + q0;
    for (int i = tid; i < nr * HD; i += THREADS)
      cp_async4(qs + i, qsrc + i, 4);
  }
  for (int i = tid; i < W; i += THREADS)
    cp_async4(bts + i, block_table + (size_t)s * W + i, 4);
  cp_async_commit();
  for (int i = nr * HD + tid; i < RC * HD; i += THREADS) qs[i] = 0.0f;
  const int kl = kv_len[s];

  // the live page range, and this block's share of it
  int w_lo = 0;
  if (window >= 0) {
    const int x = kl - (m_rows - 1) - window;
    if (x > 0) w_lo = x / PS;
  }
  const int w_hi = min(W, (kl + PS - 1) / PS);
  const int n_live = max(0, w_hi - w_lo);
  const int pa = w_lo + (int)((long long)rank * n_live / n_split);
  const int pb = w_lo + (int)((long long)(rank + 1) * n_live / n_split);
  const int ts = pa * PS;
  const int te = min(pb * PS, kl);
  const int n_tiles = te > ts ? (te - ts + TT - 1) / TT : 0;

  // tile t's token rows into table slot t % (STAGES + 1): the pool row
  // ((page * PS + offset) * KVH + h), or -1 past the share or on a -1 page
  auto fill_tab = [&](int t) {
    if (tid < TT && t < n_tiles) {
      const int rel = t * TT + tid;
      int row = -1;
      if (ts + rel < te) {
        const int w = rel / PS;
        const int page = bts[pa + w];
        if (page >= 0) row = (page * PS + rel - w * PS) * KVH + h;
      }
      tab[(t % (STAGES + 1)) * TT + tid] = row;
    }
  };

  // this thread's copies: 16-byte part k_part of K rows k_j0, k_j0 +
  // k_step, ... (likewise V), the same in every tile; kc and vc are the
  // 16-byte units of a K and a V row
  const int es = QUANT ? 1 : BF16 ? 2 : 4;
  const int kc = HD * es / 16, vc = HDV * es / 16;
  const int k_step = THREADS / kc, v_step = THREADS / vc;
  const int k_j0 = tid / kc, k_part = tid - k_j0 * kc;
  const int v_j0 = tid / vc, v_part = tid - v_j0 * vc;
  const size_t k_row = (size_t)HD * es, v_row = (size_t)HDV * es;
  const uint8_t* kp8 = (const uint8_t*)k_pool;
  const uint8_t* vp8 = (const uint8_t*)v_pool;

  // start tile t's copies into its stage (an empty group past the last
  // tile, so the wait counts stay uniform)
  auto fetch = [&](int t) {
    if (t < n_tiles) {
      uint8_t* st = smem + (t % STAGES) * g.stage;
      const int* tb = tab + (t % (STAGES + 1)) * TT;
      if (k_j0 < k_step)
        for (int j = k_j0; j < TT; j += k_step) {
          const int row = tb[j];
          cp_async16(st + j * g.ksb + k_part * 16,
                     row >= 0 ? kp8 + row * k_row + k_part * 16 : kp8,
                     row >= 0 ? 16 : 0);
        }
      uint8_t* vs = st + TT * g.ksb;
      if (v_j0 < v_step)
        for (int j = v_j0; j < TT; j += v_step) {
          const int row = tb[j];
          cp_async16(vs + j * g.vsb + v_part * 16,
                     row >= 0 ? vp8 + row * v_row + v_part * 16 : vp8,
                     row >= 0 ? 16 : 0);
        }
      if (QUANT) {
        float* sc = (float*)(st + TT * (g.ksb + g.vsb));
        for (int c = tid; c < 2 * TT; c += THREADS) {
          const int row = tb[c % TT];
          const float* pool = c < TT ? k_scale : v_scale;
          cp_async4(sc + c, row >= 0 ? pool + row : pool, row >= 0 ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };

  cp_async_wait<0>();
  __syncthreads();  // q and the table row landed
#pragma unroll
  for (int t = 0; t < STAGES; ++t) fill_tab(t);
  __syncthreads();
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) fetch(t);

  // the scores: lane (tj, dq) takes quarter dq of token tj's row; the
  // P.V: lane (tg, cgl) takes columns 4 cgl .. 4 cgl + 3 of tokens tg,
  // tg + nts, ... of the warp's 8
  const int tj = lane >> 2, dq = lane & 3;
  const int cgs = HDV / 4;
  const int nts = 32 / cgs;
  const int tg = lane / cgs, cgl = lane - tg * cgs;
  float m[RC], l[RC];
  float4 acc[RC];
  int lim[RC];
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    m[r] = NEG;
    l[r] = 0.0f;
    acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    // a padding row (past R) sees no position
    lim[r] = r < nr ? kl - (m_rows - 1 - (r_base + r) / G) : -(1 << 30);
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // the tile landed; the previous tile is consumed
    fetch(tile + STAGES - 1);
    fill_tab(tile + STAGES);
    const uint8_t* st = smem + (tile % STAGES) * g.stage;
    const int* tb = tab + (tile % (STAGES + 1)) * TT;

    const int j = warp * TW + tj;
    const int pos = ts + tile * TT + j;
    const bool tok = tb[j] >= 0;
    float ksc = 1.0f, vsc = 1.0f;
    if (QUANT) {
      const float* sc = (const float*)(st + TT * (g.ksb + g.vsb));
      ksc = sc[j];
      vsc = sc[TT + j];
    }
    float d[RC];
#pragma unroll
    for (int r = 0; r < RC; ++r) d[r] = 0.0f;
    const float4* q4 = (const float4*)qs;
    if (QUANT) {
      const int4* kr = (const int4*)(st + j * g.ksb);
      for (int c = dq; c < kc; c += 4) {
        const int4 raw = kr[c];
        const char4* c4 = (const char4*)&raw;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 kv = to_float4(c4[e]);
#pragma unroll
          for (int r = 0; r < RC; ++r)
            d[r] = dot4(q4[r * (HD / 4) + 4 * c + e], kv, d[r]);
        }
      }
    } else if (BF16) {
      // a 16-byte unit is 8 bf16 values: two float4s of the row
      const uint4* kr = (const uint4*)(st + j * g.ksb);
      for (int c = dq; c < kc; c += 4) {
        const uint4 raw = kr[c];
        const float4 k0 = bf16x4_to_float4(make_uint2(raw.x, raw.y));
        const float4 k1 = bf16x4_to_float4(make_uint2(raw.z, raw.w));
#pragma unroll
        for (int r = 0; r < RC; ++r) {
          d[r] = dot4(q4[r * (HD / 4) + 2 * c], k0, d[r]);
          d[r] = dot4(q4[r * (HD / 4) + 2 * c + 1], k1, d[r]);
        }
      }
    } else {
      const float4* kr = (const float4*)(st + j * g.ksb);
      for (int c = dq; c < kc; c += 4) {
        const float4 kv = kr[c];
#pragma unroll
        for (int r = 0; r < RC; ++r)
          d[r] = dot4(q4[r * (HD / 4) + c], kv, d[r]);
      }
    }
    // each step's shuffles for all rows together: the rows' chains overlap
#pragma unroll
    for (int o = 1; o < 4; o <<= 1)
#pragma unroll
      for (int r = 0; r < RC; ++r)
        d[r] += __shfl_xor_sync(0xffffffffu, d[r], o);
    float mx[RC];
    unsigned valid = 0;
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      bool v = tok && pos < lim[r];
      if (window >= 0) v = v && pos > lim[r] - 1 - window;
      valid |= (unsigned)v << r;
      d[r] = v ? d[r] * ksc * sm_scale : NEG;
      mx[r] = d[r];
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int r = 0; r < RC; ++r)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
    float p[RC], sum[RC], c[RC];
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const float m_new = fmaxf(m[r], mx[r]);
      // a row can have no valid token among the warp's (m_rows > 1, a -1
      // page, the share's end); its max may still be NEG, so zero masked
      // probabilities explicitly instead of trusting exp to underflow
      p[r] = (valid >> r) & 1 ? expf(d[r] - m_new) : 0.0f;
      sum[r] = p[r];
      c[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int r = 0; r < RC; ++r)
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], o);
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      l[r] = l[r] * c[r] + sum[r];
      acc[r].x *= c[r];
      acc[r].y *= c[r];
      acc[r].z *= c[r];
      acc[r].w *= c[r];
    }
    if (dq == 0) {
      float pv[RP];
#pragma unroll
      for (int r = 0; r < RP; ++r)
        pv[r] = r < RC ? p[r < RC ? r : 0] * vsc : 0.0f;
      float4* pw4 = (float4*)(pw + tj * RP);
#pragma unroll
      for (int r = 0; r < RP; r += 4)
        pw4[r / 4] = make_float4(pv[r], pv[r + 1], pv[r + 2], pv[r + 3]);
    }
    __syncwarp();
    if (tg < nts) {
      const uint8_t* vs = st + TT * g.ksb;
      for (int t2 = tg; t2 < TW; t2 += nts) {
        const uint8_t* vr = vs + (warp * TW + t2) * g.vsb;
        const float4 v4 = QUANT ? to_float4(((const char4*)vr)[cgl])
                          : BF16 ? bf16x4_to_float4(((const uint2*)vr)[cgl])
                                 : ((const float4*)vr)[cgl];
        const float4* pp = (const float4*)(pw + t2 * RP);
#pragma unroll
        for (int r = 0; r < RC; r += 4) {
          const float4 p4 = pp[r / 4];
          fma4(p4.x, v4, acc[r]);
          fma4(p4.y, v4, acc[r + 1]);
          if (r + 2 < RC) fma4(p4.z, v4, acc[r + 2 < RC ? r + 2 : r]);
          if (r + 3 < RC) fma4(p4.w, v4, acc[r + 3 < RC ? r + 3 : r]);
        }
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the warps' partials

  float* wacc = (float*)smem;  // WARPS x RC x HDV
  float* wm = red;             // WARPS x RC each: m, l, merge weights
  float* wl = red + WARPS * RC;
  float* ww = red + 2 * WARPS * RC;
  float* bm = red + 3 * WARPS * RC;  // the block's m and l
  float* bl = bm + RC;
  float* rl = bl + RC;  // rank 0: the merged l, then MAX_SPLIT x RC weights
  float* rw = rl + RC;
  // the warp's acc summed over its token groups, in group order
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < nts; ++k) {
      const int src = k * cgs + cgl;
      t.x += __shfl_sync(0xffffffffu, acc[r].x, src);
      t.y += __shfl_sync(0xffffffffu, acc[r].y, src);
      t.z += __shfl_sync(0xffffffffu, acc[r].z, src);
      t.w += __shfl_sync(0xffffffffu, acc[r].w, src);
    }
    if (lane < cgs) ((float4*)wacc)[(warp * RC + r) * cgs + lane] = t;
    if (lane == 0) {
      wm[warp * RC + r] = m[r];
      wl[warp * RC + r] = l[r];
    }
  }
  __syncthreads();
  // the block's partial: the warps merged in warp order (a warp with l = 0
  // weighs 0) into warp 0's rows
  if (tid < RC) {
    float mb = NEG;
    for (int w = 0; w < WARPS; ++w) mb = fmaxf(mb, wm[w * RC + tid]);
    float lb = 0.0f;
    for (int w = 0; w < WARPS; ++w) {
      const float lw = wl[w * RC + tid];
      const float wk = lw > 0.0f ? expf(wm[w * RC + tid] - mb) : 0.0f;
      ww[w * RC + tid] = wk;
      lb += wk * lw;
    }
    bm[tid] = mb;
    bl[tid] = lb;
  }
  __syncthreads();
  for (int e = tid; e < RC * cgs; e += THREADS) {
    const int r = e / cgs;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < WARPS; ++w)
      fma4(ww[w * RC + r], ((const float4*)wacc)[w * RC * cgs + e], t);
    ((float4*)wacc)[e] = t;
  }
  cluster.sync();  // every rank's (m, l, acc) is in its shared memory

  if (rank == 0) {
    // merge weights per row and rank: a partial with l = 0 (an empty
    // share, or no valid token of the row in it) weighs 0
    if (tid < nr) {
      float m_tot = NEG;
      for (int k = 0; k < n_split; ++k)
        m_tot = fmaxf(m_tot, *cluster.map_shared_rank(bm + tid, k));
      float l_tot = 0.0f;
      for (int k = 0; k < n_split; ++k) {
        const float mk = *cluster.map_shared_rank(bm + tid, k);
        const float lk = *cluster.map_shared_rank(bl + tid, k);
        const float wk = lk > 0.0f ? expf(mk - m_tot) : 0.0f;
        rw[k * RC + tid] = wk;
        l_tot += wk * lk;
      }
      rl[tid] = fmaxf(l_tot, 1e-30f);
    }
    __syncthreads();
    const size_t o0 = ((size_t)sh * R + r_base) * HDV;
    for (int e = tid; e < nr * cgs; e += THREADS) {
      const int r = e / cgs;
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < n_split; ++k)
        fma4(rw[k * RC + r],
             *cluster.map_shared_rank((const float4*)wacc + e, k), t);
      const float lr = rl[r];
      const float4 o = make_float4(t.x / lr, t.y / lr, t.z / lr, t.w / lr);
      if (out_bf16) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(o.x, o.y);
        __nv_bfloat162 hi = __floats2bfloat162_rn(o.z, o.w);
        ((uint2*)((__nv_bfloat16*)out + o0))[e] = make_uint2(
            *reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
      } else {
        ((float4*)((float*)out + o0))[e] = o;
      }
    }
  }
  cluster.sync();  // the peers' shared memory stays until rank 0 has read
}

template <int KIND, int RC>
cudaError_t launch(const Geo& g, int n_split, int S, int KVH,
                   cudaStream_t stream, const void* q, const void* k_pool,
                   const void* v_pool, const float* k_scale,
                   const float* v_scale, const int* block_table,
                   const int* kv_len, void* out, int R, int HD, int HDV,
                   int PS, int W, int m_rows, int window, float sm_scale,
                   int q_bf16, int out_bf16) {
  auto kernel = paged_attention_kernel<KIND, RC>;
  if (g.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, S * KVH, g.chunks);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, q, k_pool, v_pool, k_scale,
                            v_scale, block_table, kv_len, out, KVH, R, HD,
                            HDV, PS, W, m_rows, window, sm_scale, n_split,
                            q_bf16, out_bf16, g);
}

}  // namespace

// q (S, KVH, R, HD) f32 (bf16 with q_bf16); pools (P, PS, KVH, HD[V]) of
// the type `kind` names: f32 (KV_F32), bf16 (KV_BF16), or int8 (KV_INT8)
// with (P, PS, KVH) f32 scale pools; block_table (S, W) int32; kv_len (S,)
// int32 -> out (S, KVH, R, HDV) f32 (bf16 with out_bf16). window < 0
// means none. Each (slot, kv head, row chunk) is one cluster of n_split
// blocks (1..8). HD and HDV are multiples of 4 (f32), 8 (bf16) or 16
// (int8), HDV at most 128; the pools and out start on 16 bytes. Returns
// the CUDA error code of the launch (0 on success).
extern "C" int paged_attention(const void* q, const void* k_pool,
                               const void* v_pool, const void* k_scale,
                               const void* v_scale, const void* block_table,
                               const void* kv_len, void* out, int S, int KVH,
                               int R, int HD, int HDV, int PS, int W,
                               int m_rows, int window, float sm_scale,
                               int kind, int n_split, int q_bf16,
                               int out_bf16, void* stream) {
  const int mult = kind == KV_INT8 ? 16 : kind == KV_BF16 ? 8 : 4;
  if (S <= 0 || KVH <= 0 || R <= 0 || HD <= 0 || HDV <= 0 || PS <= 0 ||
      W <= 0 || m_rows <= 0 || R % m_rows != 0 || HD % mult != 0 ||
      HDV % mult != 0 || HDV > MAX_HDV || n_split < 1 ||
      n_split > MAX_SPLIT || (long long)S * KVH > 65535 ||
      (kind != KV_F32 && kind != KV_INT8 && kind != KV_BF16) ||
      ((uintptr_t)k_pool | (uintptr_t)v_pool | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Geo g = geometry(R, HD, HDV, W, kind);
  if (g.smem > MAX_SMEM || g.chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const auto* ks = (const float*)k_scale;
  const auto* vs = (const float*)v_scale;
  const auto* bt = (const int*)block_table;
  const auto* kl = (const int*)kv_len;
  cudaError_t e;
#define PAGED_LAUNCH(KI, RC)                                                  \
  e = launch<KI, RC>(g, n_split, S, KVH, st, q, k_pool, v_pool, ks, vs, bt,  \
                     kl, out, R, HD, HDV, PS, W, m_rows, window, sm_scale,   \
                     q_bf16, out_bf16)
#define PAGED_ROWS(KI)                      \
  if (g.rc == 2) PAGED_LAUNCH(KI, 2);       \
  else if (g.rc == 4) PAGED_LAUNCH(KI, 4);  \
  else if (g.rc == 6) PAGED_LAUNCH(KI, 6);  \
  else PAGED_LAUNCH(KI, 8)
  if (kind == KV_INT8) {
    PAGED_ROWS(KV_INT8);
  } else if (kind == KV_BF16) {
    PAGED_ROWS(KV_BF16);
  } else {
    PAGED_ROWS(KV_F32);
  }
#undef PAGED_ROWS
#undef PAGED_LAUNCH
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
