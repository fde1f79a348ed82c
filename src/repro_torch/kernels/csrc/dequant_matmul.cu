// Fused low-bit dequantize + matmul for Hopper (sm_90a): one linear.
//
// Replaces the TPU kernel `dequant_matmul_pallas`
// (src/repro/kernels/dequant_matmul.py:43, its pallas_call at :59).
// Computes
//
//   out[m, n] = sum_k bf16(x[m, k]) * bf16(f32(q[k, n] - QMAX) * scale[g(k), n])
//
// accumulated in f32 and written f32, or bf16 (one rounding of the f32
// sum), where x is f32 or bf16 and q comes from the K-packed offset-binary bytes
// of core/quant/types.py (packing.cuh) and g(k) = 0 per-channel (G == 1),
// else k / (K / G). The scale is applied before the bf16 rounding, as the
// plain version (kernels/ref.py::dequant_matmul_ref) and the TPU kernel
// do.
//
// What bounds it on this card. Decode (M = the serving slots, 8) does
// 2*M = 16 operations per packed weight value and is bound by reading the
// packed weights: at W4 a 2048x8192 weight is 8 MiB, 2.5 us at 3.35 TB/s.
// Prefill and the pipeline (M = 512 to 16,384 rows) are bound by the bf16
// tensor cores.
//
// Two bodies, chosen by M in the one planner of both dense kernels
// (kernels/dequant_matmul.py::plan):
//   - body 0, decode (M up to STREAM_MAX_M): the weight-streaming kernel
//     of stream_dequant.cuh (kernel 4's) as one expert, E = 1: each packed
//     byte read once through a cp.async ring, the weight's columns the M
//     side of mma.sync.m16n8k16 and the token rows its n8 side, K split
//     until the strips fill the card;
//   - body 1, prefill: the pipelined tensor-core tile of prefill_tile.cuh:
//     128 x 256 tiles (128 token rows x 256 weight columns), each
//     stage's weight unpacked once into a bf16 tile that feeds all 128
//     token rows. An f32 x is rounded to bf16 into the workspace first
//     (one pass); a bf16 x is the tile's operand as it is.
// Scale groups of 8-32 rows take body 0 at any M (slow, right).
#include "prefill_tile.cuh"
#include "stream_dequant.cuh"

namespace {

// bf16(x), rounded to nearest even as the plain version's
// x.to(bfloat16): kernel 1's x rows, converted once per launch so that
// the tile streams half the bytes and converts nothing per stage. n
// values, 8 a thread; vec: x and xb 16-byte aligned.
__global__ void to_bf16_kernel(const float* __restrict__ x,
                               __nv_bfloat16* __restrict__ xb, size_t n,
                               int vec) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (vec && i + 8 <= n) {
    const float4 a = *reinterpret_cast<const float4*>(x + i);
    const float4 b = *reinterpret_cast<const float4*>(x + i + 4);
    *reinterpret_cast<uint4*>(xb + i) = make_uint4(
        expert_stream::pack_bf16(a.x, a.y), expert_stream::pack_bf16(a.z, a.w),
        expert_stream::pack_bf16(b.x, b.y), expert_stream::pack_bf16(b.z, b.w));
  } else {
    for (size_t j = i; j < n && j < i + 8; ++j)
      xb[j] = __float2bfloat16_rn(x[j]);
  }
}

// bytes of kernel 1's bf16 copy of x at the head of its workspace (the
// split partials follow)
inline size_t xb_bytes(int M, int K) {
  return ((size_t)M * K * 2 + 255) / 256 * 256;
}

// body 1: an f32 x rounded to bf16 into the workspace's head (a bf16 x
// as it is), the tile, the split sum
int launch_prefill(const void* x, const void* qw, const void* scale,
                   void* out, void* workspace, int M, int K, int N, int G,
                   int bits, int splits, int k_per_split, int x_bf16,
                   int out_bf16, cudaStream_t st) {
  if (!prefill_tile::valid(M, K, N, G, bits, splits, k_per_split,
                           workspace) ||
      (workspace == nullptr && !x_bf16))
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  size_t head = 0;
  if (!x_bf16) {
    const size_t n = (size_t)M * K;
    __nv_bfloat16* xw = (__nv_bfloat16*)workspace;
    to_bf16_kernel<<<(unsigned)((n + 8 * 256 - 1) / (8 * 256)), 256, 0,
                     st>>>((const float*)x, xw, n,
                           (uintptr_t)x % 16 == 0 ? 1 : 0);
    xb = xw;
    head = xb_bytes(M, K);
  }
  float* partial = (float*)((uint8_t*)workspace + head);
  void* dst = splits > 1 ? (void*)partial : out;
  const int aligned =
      expert_stream::aligned16(xb, qw, scale, N, (long long)K * 2) ? 1 : 0;
  const uint8_t* xp = (const uint8_t*)xb;
  const uint8_t* qp = (const uint8_t*)qw;
  const float* sp = (const float*)scale;
  int code;
  using prefill_tile::launch_tile;
  switch (bits) {
    case 2: code = launch_tile<2, false, false>(st, xp, qp, sp, dst, M, K, N, G, splits, k_per_split, aligned, out_bf16); break;
    case 3: code = launch_tile<3, false, false>(st, xp, qp, sp, dst, M, K, N, G, splits, k_per_split, aligned, out_bf16); break;
    case 4: code = launch_tile<4, false, false>(st, xp, qp, sp, dst, M, K, N, G, splits, k_per_split, aligned, out_bf16); break;
    default: code = launch_tile<8, false, false>(st, xp, qp, sp, dst, M, K, N, G, splits, k_per_split, aligned, out_bf16); break;
  }
  if (code) return code;
  if (splits > 1)
    split_k::sum_splits(partial, out, (size_t)M * N, splits, 1, out_bf16,
                        st);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) f32 (bf16 with x_bf16), qw (packed_rows(K), N) uint8, scale
// (G, N) f32 -> out (M, N) f32 (bf16 with out_bf16), all contiguous on the
// current device. body 0: nt n8 tiles of token rows a block (1, 2 or 4),
// K in ranges of k_per_split rows (a multiple of 128), and with splits > 1
// a workspace of splits x M x N f32 partials (a bf16 x: scale groups of
// whole 16-row K steps). body 1: K in ranges of a multiple of 64 rows (nt
// unused), and a workspace of M x K bf16 (padded to 256 bytes; none for a
// bf16 x) followed, with splits > 1, by the partials. Returns the CUDA
// error code of the launches (0 on success).
extern "C" int dequant_matmul(const void* x, const void* qw, const void* scale,
                              void* out, void* workspace, int M, int K, int N,
                              int G, int bits, int body, int nt, int splits,
                              int k_per_split, int x_bf16, int out_bf16,
                              void* stream) {
  if (body == 0)
    return expert_dq::launch(x, qw, scale, out, workspace, 1, M, K, N, G,
                             bits, nt, splits, k_per_split, x_bf16, out_bf16,
                             stream);
  if (body == 1)
    return launch_prefill(x, qw, scale, out, workspace, M, K, N, G, bits,
                          splits, k_per_split, x_bf16, out_bf16,
                          (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// Resident blocks per SM, written to *blocks, of body 0 (8 token rows a
// block) or body 1 at `bits` with one scale row a stage (the variants the
// model paths run), by CUDA's occupancy calculator over their registers
// and shared memory. Returns the CUDA error code (0 on success).
template <int BITS>
static int blocks_per_sm(int body, int* blocks) {
  using namespace expert_stream;
  cudaError_t err;
  if (body == 0) {
    const int smem = STAGES * stage_bytes<BITS>(1, 4, 1);
    auto kernel = expert_dq::expert_dq_kernel<BITS, 1, false, false>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                          THREADS, smem);
  } else {
    const int smem = prefill_tile::Geo<BITS, false, false>::SMEM;
    auto kernel = prefill_tile::tile_kernel<BITS, false, false>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, kernel, prefill_tile::THREADS, smem);
  }
  return (int)err;
}

extern "C" int dequant_matmul_blocks_per_sm(int body, int bits, int* blocks) {
  switch (bits) {
    case 2: return blocks_per_sm<2>(body, blocks);
    case 3: return blocks_per_sm<3>(body, blocks);
    case 4: return blocks_per_sm<4>(body, blocks);
    case 8: return blocks_per_sm<8>(body, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* dequant_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
