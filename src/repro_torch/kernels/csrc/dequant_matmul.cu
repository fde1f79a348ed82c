// Fused low-bit dequantize + matmul for Hopper (sm_90a): one linear.
//
// Replaces the TPU kernel `dequant_matmul_pallas`
// (src/repro/kernels/dequant_matmul.py, body template.make_matmul_kernel
// with epilogue "dequant_bf16"). Computes
//
//   out[m, n] = sum_k bf16(x[m, k]) * bf16(q[k, n] * scale[g(k), n])
//
// accumulated in f32. The body, what bounds it on this card and what its
// design does about that are in dequant_matmul.cuh.
#include "dequant_matmul.cuh"

using namespace dequant_mm;

// x (M, K) f32, qw (packed_rows(K), N) uint8, scale (G, N) f32 -> out
// (M, N) f32, all contiguous on the current device. With splits > 1, K is
// cut into ranges of k_per_split rows (a multiple of 32) and workspace
// holds splits x M x N f32 partials. Returns the CUDA error code of the
// launches (0 on success).
extern "C" int dequant_matmul(const void* x, const void* qw, const void* scale,
                              void* out, void* workspace, int M, int K, int N,
                              int G, int bits, int splits, int k_per_split,
                              void* stream) {
  return launch(x, qw, scale, out, workspace, M, K, N, G, bits, splits,
                k_per_split, stream);
}

// Resident blocks per SM of the main kernel for `bits` with one scale per
// K step (the variant llama-shaped linears run; its registers and shared
// memory decide this), written to *blocks. Returns the CUDA error code (0
// on success).
extern "C" int dequant_matmul_blocks_per_sm(int bits, int* blocks) {
  cudaError_t err;
  switch (bits) {
    case 2:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, dequant_matmul_kernel<2, true>, THREADS, 0);
      break;
    case 3:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, dequant_matmul_kernel<3, true>, THREADS, 0);
      break;
    case 4:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, dequant_matmul_kernel<4, true>, THREADS, 0);
      break;
    case 8:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, dequant_matmul_kernel<8, true>, THREADS, 0);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* dequant_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
