// Expert-batched W8A8 / W4A8 matmul on the int8 tensor cores of Hopper
// (sm_90a): every expert of an MoE layer's stacked linear in one launch.
//
// Replaces the TPU kernel `expert_w8a8_matmul_pallas`
// (src/repro/kernels/expert_w8a8_matmul.py:33, its pallas_call at :51).
// Computes, for each expert e of E,
//
//   out[e, c, n] = sum_g scale[e, g, n] * (sum_{k in group g} xq[e, c, k] * (q[e, k, n] - QMAX))
//
// over the (E, C, K) int8 capacity buffer of an MoE layer, before the
// per-token activation rescale (the caller, kernels/ops.py, quantizes the
// buffer's E*C rows per token and multiplies by their scales). Each inner
// sum over a scale group (a whole number of 16-row K steps; per-channel
// scales make one group of all of K) is exact in int32; it is rescaled by
// scale[e, g, n] in f32 and summed over groups in f32, as the plain
// version (kernels/ref.py::expert_w8a8_matmul_ref) does.
//
// What bounds it: at decode (C = 8) reading the packed weights (at W4
// eight 6144x16384 experts: 403 MB, 0.12 ms at 3.35 TB/s); at prefill
// capacities the int8 tensor cores. The design, shared with the bf16
// expert kernel, is in expert_stream.cuh: each packed byte streamed once
// through a cp.async ring, the strip's columns the M side of
// mma.sync.m16n8k16 and the capacity rows its n8 side. The kernel
// template and its unpack (a byte transpose, the offset taken out with
// a tile of ones) are in stream_w8a8.cuh, which kernel 3
// (w8a8_matmul.cu) also runs at decode, as E = 1.
#include "stream_w8a8.cuh"

// xq (E, C, K) int8, qw (E, packed_rows(K), N) uint8, scale (E, G, N) f32
// -> out (E, C, N) f32, all contiguous on the current device. A scale
// group (K / G rows, or all of K when G == 1) must be a multiple of 16
// rows. nt: n8 tiles of capacity rows a block holds (1, 2 or 4; C takes
// ceil(C / 8nt) chunks). With splits > 1, each expert's K is cut into
// ranges of k_per_split rows (a multiple of 128, and of the group when
// G > 1; no range empty) and workspace holds E x splits x C x N f32
// partials. Returns the CUDA error code of the launches (0 on success).
extern "C" int expert_w8a8_matmul(const void* xq, const void* qw,
                                  const void* scale, void* out,
                                  void* workspace, int E, int C, int K,
                                  int N, int G, int bits, int nt,
                                  int splits, int k_per_split,
                                  void* stream) {
  return expert_w8::launch(xq, qw, scale, out, workspace, E, C, K, N, G, bits,
                          nt, splits, k_per_split, stream);
}

extern "C" const char* expert_w8a8_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
