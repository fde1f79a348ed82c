// RTN quantize + pack of low-bit weights on Hopper (sm_90a).
//
// Replaces the TPU kernel `quantize_pack_pallas`
// (src/repro/kernels/quantize.py). For a stack of B weights w (B, K, N),
// f32 or bf16, with scales (B, G, N) f32, it writes the packed layout of
// core/quant/types.py (packing.cuh):
//
//   q[b, k, n] = clip(round_half_even(w[b, k, n] / scale[b, k / rows, n]),
//                     -QMAX, QMAX)        rows = K / G
//
// stored offset-binary (q + QMAX) along K, VALUES to a packed group; the
// rows of the last group past K are zero fields, as types.pack pads them.
//
// What bounds it on the H100: bytes. Each weight value is read once (4 or
// 2 bytes) and becomes bits / 8 bytes of output, with a handful of
// operations between: 2048 x 8192 x 16 f32 weights are 1.07 GB, 0.32 ms
// at 3.35 TB/s. The design therefore only has to keep the memory system
// busy: one thread per (stack index, packed group, column) reads its
// VALUES K-consecutive values down one column and writes its BYTES bytes;
// consecutive threads take consecutive columns, so every warp's reads of
// a row and its byte writes are contiguous runs. The grid is (column
// blocks, packed groups, stack index), so a thread finds its place with
// no integer division (a first version decoded a flat 64-bit index with
// 64-bit divisions, which the card emulates in ~100 instructions each,
// and ran at 3.4x the bound). Nothing depends on the group size: any group
// that divides K works, including groups smaller than a packed group.
//
// The bytes must equal the plain version's exactly: the quotient is IEEE
// division (nvcc's default -prec-div=true; never a multiply by 1/s),
// rounded half to even by rintf (roundf rounds half away from zero),
// clipped after rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "packing.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int BITS, typename T>
__global__ void __launch_bounds__(THREADS)
quantize_pack_kernel(const T* __restrict__ w, const float* __restrict__ scale,
                     uint8_t* __restrict__ out, int K, int N, int groups,
                     int rows_per_group, int packed_groups) {
  using L = packing::Layout<BITS>;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const int r = blockIdx.y;
  const long long b = blockIdx.z;
  const T* wb = w + b * K * (long long)N;
  const float* sb = scale + b * groups * (long long)N;
  uint32_t word = 0;
#pragma unroll
  for (unsigned i = 0; i < L::VALUES; ++i) {
    const int k = r * (int)L::VALUES + (int)i;
    if (k < K) {
      const float s = sb[(long long)(k / rows_per_group) * N + n];
      float q = rintf(to_float(wb[(long long)k * N + n]) / s);
      q = fminf(fmaxf(q, (float)-L::QMAX), (float)L::QMAX);
      word |= (uint32_t)((int)q + L::QMAX) << (BITS * i);
    }
  }
  uint8_t* ob = out + b * (long long)packed_groups * L::BYTES * N;
#pragma unroll
  for (unsigned byte = 0; byte < L::BYTES; ++byte)
    ob[((long long)r * L::BYTES + byte) * N + n] =
        (uint8_t)(word >> (8 * byte));
}

template <int BITS, typename T>
cudaError_t launch(const void* w, const void* scale, void* out, int B, int K,
                   int N, int G, cudaStream_t stream) {
  using L = packing::Layout<BITS>;
  const int packed_groups = (K + (int)L::VALUES - 1) / (int)L::VALUES;
  if (packed_groups > 65535 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((N + THREADS - 1) / THREADS, packed_groups, B);
  quantize_pack_kernel<BITS, T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(w), static_cast<const float*>(scale),
      static_cast<uint8_t*>(out), K, N, G, K / G, packed_groups);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* w, const void* scale, void* out, int B,
                     int K, int N, int G, int bits, cudaStream_t stream) {
  switch (bits) {
    case 2: return launch<2, T>(w, scale, out, B, K, N, G, stream);
    case 3: return launch<3, T>(w, scale, out, B, K, N, G, stream);
    case 4: return launch<4, T>(w, scale, out, B, K, N, G, stream);
    case 8: return launch<8, T>(w, scale, out, B, K, N, G, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// w (B, K, N) f32 (bf16 when w_bf16), scale (B, G, N) f32 with G dividing
// K, out (B, packed_rows(K), N) uint8, all contiguous on the current
// device; B and the packed groups of K at most 65535 each. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int quantize_pack(const void* w, const void* scale, void* out,
                             int B, int K, int N, int G, int bits, int w_bf16,
                             void* stream) {
  if (B <= 0 || K <= 0 || N <= 0 || G <= 0 || K % G)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_bf16 ? dispatch<__nv_bfloat16>(w, scale, out, B, K, N, G, bits, s)
                : dispatch<float>(w, scale, out, B, K, N, G, bits, s);
}

extern "C" const char* quantize_pack_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
