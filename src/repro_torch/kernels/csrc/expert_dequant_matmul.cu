// Expert-batched fused low-bit dequantize + matmul for Hopper (sm_90a):
// every expert of an MoE layer's stacked linear in one launch.
//
// Replaces the TPU kernel `expert_dequant_matmul_pallas`
// (src/repro/kernels/expert_dequant_matmul.py:33, its pallas_call at :49).
// Computes, for each expert e of E,
//
//   out[e, c, n] = sum_k bf16(x[e, c, k]) * bf16(f32(q[e, k, n] - QMAX) * scale[e, g(k), n])
//
// accumulated in f32 and written f32, or bf16 (one rounding of the f32
// sum), over the (E, C, K) f32 or bf16 capacity buffer of an MoE layer;
// g(k) = 0 per-channel (G == 1), else k / (K / G). The scale is applied
// before the bf16 rounding, as the plain version
// (kernels/ref.py::expert_dequant_matmul_ref) and the TPU kernel do.
//
// What bounds it: at decode (C = 8) reading the packed weights (at W4
// eight 6144x16384 experts: 403 MB, 0.12 ms at 3.35 TB/s), and close
// behind, the unpack of ~805 M values; at prefill capacities the bf16
// tensor cores. The design, shared with the W8A8 expert kernel, is in
// expert_stream.cuh: each packed byte streamed once through a cp.async
// ring, the strip's columns the M side of mma.sync.m16n8k16 and the
// capacity rows its n8 side. The kernel template and its unpack are in
// stream_dequant.cuh, which kernel 1 (dequant_matmul.cu) also runs at
// decode, as E = 1.
#include "stream_dequant.cuh"

// x (E, C, K) f32 (bf16 with x_bf16), qw (E, packed_rows(K), N) uint8,
// scale (E, G, N) f32 -> out (E, C, N) f32 (bf16 with out_bf16), all
// contiguous on the current device: expert_dq::launch in
// stream_dequant.cuh says what the plan's nt, splits and k_per_split and
// the workspace are. Returns the CUDA error code of the launches (0 on
// success).
extern "C" int expert_dequant_matmul(const void* x, const void* qw,
                                     const void* scale, void* out,
                                     void* workspace, int E, int C, int K,
                                     int N, int G, int bits, int nt,
                                     int splits, int k_per_split, int x_bf16,
                                     int out_bf16, void* stream) {
  return expert_dq::launch(x, qw, scale, out, workspace, E, C, K, N, G, bits,
                          nt, splits, k_per_split, x_bf16, out_bf16, stream);
}

extern "C" const char* expert_dequant_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
