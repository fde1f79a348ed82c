// Int8 activations times low-bit packed weights on the int8 tensor cores
// of Hopper (sm_90a): the W8A8 / W4A8 matmul of one linear.
//
// Replaces the TPU kernel `w8a8_matmul_pallas`
// (src/repro/kernels/w8a8_matmul.py:36, its pallas_call at :55).
// Computes
//
//   out[m, n] = sum_g scale[g, n] * (sum_{k in group g} xq[m, k] * (q[k, n] - QMAX))
//
// before the per-token activation rescale (the caller, kernels/ops.py,
// multiplies by it). xq is int8 (per-token quantized activations); q
// comes from the K-packed offset-binary bytes of core/quant/types.py
// (packing.cuh). Each inner sum over a scale group (a multiple of 16
// rows; per-channel scales make one group of all of K) is exact in int32;
// it is rescaled by scale[g, n] in f32 and summed over groups in f32, as
// the plain version (kernels/ref.py::w8a8_matmul_ref) does. Per-channel,
// the one exact sum over all of K is rescaled once, also when K is split
// (the splits add in int32), so the result is the plain version's bits.
//
// What bounds it on this card. Decode (M = 8 slots) is bound by reading
// the packed weights: at W4 a 2048x8192 weight is 8 MiB, 2.5 us at 3.35
// TB/s. Prefill (M in the hundreds) does 2*M*K*N int8 operations and is
// bound by the int8 tensor cores (1979 TOP/s dense).
//
// Two bodies, chosen by M in the one planner of both dense kernels
// (kernels/dequant_matmul.py::plan):
//   - body 0, decode (M up to STREAM_MAX_M): the weight-streaming kernel
//     of stream_w8a8.cuh (kernel 5's) as one expert, E = 1: each packed
//     byte read once through a cp.async ring into mma.sync u8 x s8 with
//     the weight as the M side, the codes' offset taken out with a tile
//     of ones;
//   - body 1, prefill: the pipelined tensor-core tile of prefill_tile.cuh:
//     128 x 256 tiles (128 x 128 for grouped scales), each stage's weight
//     unpacked once into an int8 tile (q - QMAX) that feeds all 128 token
//     rows through mma.sync m16n8k32.
// Scale groups of 16 or 32 rows take body 0 at any M (slow, right).
#include "prefill_tile.cuh"
#include "stream_w8a8.cuh"

namespace {

template <int BITS>
int launch_tile_bits(bool grouped, cudaStream_t st, const uint8_t* xq,
                     const uint8_t* qw, const float* scale, float* dst, int M,
                     int K, int N, int G, int splits, int k_per_split,
                     int aligned) {
  return grouped ? prefill_tile::launch_tile<BITS, true, true>(
                       st, xq, qw, scale, dst, M, K, N, G, splits,
                       k_per_split, aligned)
                 : prefill_tile::launch_tile<BITS, true, false>(
                       st, xq, qw, scale, dst, M, K, N, G, splits,
                       k_per_split, aligned);
}

// body 1: the tile, then the split sum (per-channel: in int32, rescaled
// once)
int launch_prefill(const void* xq, const void* qw, const void* scale,
                   void* out, void* workspace, int M, int K, int N, int G,
                   int bits, int splits, int k_per_split, cudaStream_t st) {
  // a split holds whole scale groups: each group's sum is exact
  if (!prefill_tile::valid(M, K, N, G, bits, splits, k_per_split,
                           workspace) ||
      (G > 1 && k_per_split % (K / G) != 0))
    return (int)cudaErrorInvalidValue;
  float* dst = splits > 1 ? (float*)workspace : (float*)out;
  const int aligned = expert_stream::aligned16(xq, qw, scale, N, K) ? 1 : 0;
  const uint8_t* xp = (const uint8_t*)xq;
  const uint8_t* qp = (const uint8_t*)qw;
  const float* sp = (const float*)scale;
  const bool grouped = G > 1;
  int code;
  switch (bits) {
    case 2: code = launch_tile_bits<2>(grouped, st, xp, qp, sp, dst, M, K, N, G, splits, k_per_split, aligned); break;
    case 3: code = launch_tile_bits<3>(grouped, st, xp, qp, sp, dst, M, K, N, G, splits, k_per_split, aligned); break;
    case 4: code = launch_tile_bits<4>(grouped, st, xp, qp, sp, dst, M, K, N, G, splits, k_per_split, aligned); break;
    default: code = launch_tile_bits<8>(grouped, st, xp, qp, sp, dst, M, K, N, G, splits, k_per_split, aligned); break;
  }
  if (code) return code;
  if (splits > 1 && !grouped)
    split_k::sum_int_splits(dst, sp, (float*)out, M, N, splits, 1, st);
  else if (splits > 1)
    split_k::sum_splits(dst, out, (size_t)M * N, splits, 1, 0, st);
  return (int)cudaGetLastError();
}

}  // namespace

// xq (M, K) int8, qw (packed_rows(K), N) uint8, scale (G, N) f32 -> out
// (M, N) f32, all contiguous on the current device. body 0: nt n8 tiles
// of token rows a block (1, 2 or 4), K in ranges of k_per_split rows (a
// multiple of 128 and of the group); body 1: K in ranges of a multiple of
// 64 rows and of the group (nt unused). With splits > 1 workspace holds
// splits x M x N partials (per-channel: the bits of exact int32 sums).
// Returns the CUDA error code of the launches (0 on success).
extern "C" int w8a8_matmul(const void* xq, const void* qw, const void* scale,
                           void* out, void* workspace, int M, int K, int N,
                           int G, int bits, int body, int nt, int splits,
                           int k_per_split, void* stream) {
  if (body == 0)
    return expert_w8::launch(xq, qw, scale, out, workspace, 1, M, K, N, G,
                             bits, nt, splits, k_per_split, stream);
  if (body == 1)
    return launch_prefill(xq, qw, scale, out, workspace, M, K, N, G, bits,
                          splits, k_per_split, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// Resident blocks per SM, written to *blocks, of body 0 (8 token rows a
// block) or body 1 at `bits` with per-channel scales (the variants the
// model paths run), by CUDA's occupancy calculator over their registers
// and shared memory. Returns the CUDA error code (0 on success).
template <int BITS>
static int blocks_per_sm(int body, int* blocks) {
  using namespace expert_stream;
  cudaError_t err;
  if (body == 0) {
    const int smem = STAGES * stage_bytes<BITS>(1, 1, 0);
    auto kernel = expert_w8::expert_w8_kernel<BITS, 1, false>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                          THREADS, smem);
  } else {
    const int smem = prefill_tile::Geo<BITS, true, false>::SMEM;
    auto kernel = prefill_tile::tile_kernel<BITS, true, false>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, kernel, prefill_tile::THREADS, smem);
  }
  return (int)err;
}

extern "C" int w8a8_matmul_blocks_per_sm(int body, int bits, int* blocks) {
  switch (bits) {
    case 2: return blocks_per_sm<2>(body, blocks);
    case 3: return blocks_per_sm<3>(body, blocks);
    case 4: return blocks_per_sm<4>(body, blocks);
    case 8: return blocks_per_sm<8>(body, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* w8a8_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
