// Expert-batched fused low-bit dequantize + matmul for Hopper (sm_90a):
// every expert of an MoE layer's stacked linear in one launch.
//
// Replaces the TPU kernel `expert_dequant_matmul_pallas`
// (src/repro/kernels/expert_dequant_matmul.py, the dequant matmul body
// with a leading expert grid axis). Computes, for each expert e of E,
//
//   out[e, c, n] = sum_k bf16(x[e, c, k]) * bf16(q[e, k, n] * scale[e, g(k), n])
//
// accumulated in f32, over the (E, C, K) capacity buffer of an MoE layer.
// It is the dense kernel's body (dequant_matmul.cuh) with the expert on
// the grid: z = expert * splits + split, each expert's operands a whole
// matrix further on. What bounds it is the dense kernel's, summed over the
// experts: at decode (C = 8) the E packed weights (at W4 eight 6144x16384
// experts: 403 MB, 0.12 ms at 3.35 TB/s); at prefill capacities (C in the
// tens to hundreds) the bf16 tensor cores.
#include "dequant_matmul.cuh"

// x (E, C, K) f32, qw (E, packed_rows(K), N) uint8, scale (E, G, N) f32 ->
// out (E, C, N) f32, all contiguous on the current device. With splits >
// 1, each expert's K is cut into ranges of k_per_split rows (a multiple of
// 32) and workspace holds E x splits x C x N f32 partials. Returns the
// CUDA error code of the launches (0 on success).
extern "C" int expert_dequant_matmul(const void* x, const void* qw,
                                     const void* scale, void* out,
                                     void* workspace, int E, int C, int K,
                                     int N, int G, int bits, int splits,
                                     int k_per_split, void* stream) {
  return dequant_mm::launch<true>(x, qw, scale, out, workspace, E, C, K, N,
                                  G, bits, splits, k_per_split, stream);
}

extern "C" const char* expert_dequant_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
