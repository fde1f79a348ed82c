// Int8 activations times low-bit packed weights on the int8 tensor cores
// of Hopper (sm_90a): the W8A8 / W4A8 matmul of one linear.
//
// Replaces the TPU kernel `w8a8_matmul_pallas`
// (src/repro/kernels/w8a8_matmul.py, body template.make_matmul_kernel
// with epilogue "int8_mxu"). Computes
//
//   out[m, n] = sum_g scale[g, n] * (sum_{k in group g} xq[m, k] * q[k, n])
//
// before the per-token activation rescale. The body, what bounds it on
// this card and what its design does about that are in w8a8_matmul.cuh.
#include "w8a8_matmul.cuh"

// xq (M, K) int8, qw (packed_rows(K), N) uint8, scale (G, N) f32 -> out
// (M, N) f32, all contiguous on the current device. A scale group (K / G
// rows, or all of K when G == 1) must be a multiple of 16 rows. With
// splits > 1, K is cut into ranges of k_per_split rows (a multiple of 32,
// and of the group when G > 1) and workspace holds splits x M x N f32
// partials. vec_x: xq's rows may be read 16 bytes at a time (K % 16 == 0
// and xq 16-byte aligned). Returns the CUDA error code of the launches (0
// on success).
extern "C" int w8a8_matmul(const void* xq, const void* qw, const void* scale,
                           void* out, void* workspace, int M, int K, int N,
                           int G, int bits, int splits, int k_per_split,
                           int vec_x, void* stream) {
  return w8a8_mm::launch(xq, qw, scale, out, workspace, M, K, N, G, bits,
                         splits, k_per_split, vec_x, stream);
}

extern "C" const char* w8a8_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
