// Expert-batched W8A8 / W4A8 matmul on the int8 tensor cores of Hopper
// (sm_90a): every expert of an MoE layer's stacked linear in one launch.
//
// Replaces the TPU kernel `expert_w8a8_matmul_pallas`
// (src/repro/kernels/expert_w8a8_matmul.py, the W8A8 matmul body with a
// leading expert grid axis). Computes, for each expert e of E,
//
//   out[e, c, n] = sum_g scale[e, g, n] * (sum_{k in group g} xq[e, c, k] * q[e, k, n])
//
// over the (E, C, K) int8 capacity buffer of an MoE layer, before the
// per-token activation rescale (the caller, kernels/ops.py, quantizes the
// buffer's E*C rows per token and multiplies by their scales). It is the
// dense kernel's body (w8a8_matmul.cuh) with the expert on the grid: z =
// expert * splits + split, each expert's operands a whole matrix further
// on. What bounds it is the dense kernel's, summed over the experts: at
// decode (C = 8) the E packed weights (at W4 eight 6144x16384 experts: 403
// MB, 0.12 ms at 3.35 TB/s); at prefill capacities the int8 tensor cores.
#include "w8a8_matmul.cuh"

// xq (E, C, K) int8, qw (E, packed_rows(K), N) uint8, scale (E, G, N) f32
// -> out (E, C, N) f32, all contiguous on the current device; the
// conditions on groups, splits and vec_x are the dense kernel's
// (w8a8_matmul.cuh), and workspace holds E x splits x C x N f32 partials.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int expert_w8a8_matmul(const void* xq, const void* qw,
                                  const void* scale, void* out,
                                  void* workspace, int E, int C, int K,
                                  int N, int G, int bits, int splits,
                                  int k_per_split, int vec_x, void* stream) {
  return w8a8_mm::launch<true>(xq, qw, scale, out, workspace, E, C, K, N, G,
                               bits, splits, k_per_split, vec_x, stream);
}

extern "C" const char* expert_w8a8_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
