// Dequantize + matmul of a packed INT2/4/8 weight matrix:
//   out[m, n] = sum_k x[m, k] * (v[k, n] * s[j, k] + o[j, k]) + bias[n],
//   j = n / 256, out f32 [M, N], where v is the level itself (uniform grid)
//   or, given a codebook, the level's point pts[lvl] (LUT variant).
//
// Replaces the TPU kernels _uniform_kernel and _codebook_kernel of
// quantized_distillation_tpu/kernels/dequant_matmul.py (both launched by
// dequant_matmul there), which stream one bucket group of packed bytes per
// grid step into VMEM and feed the MXU; the codebook kernel first maps each
// level through 2^bits select-accumulate passes, the TPU having no vector
// gather. Here one template serves both: the LUT variant loads the points
// into shared memory once per block and looks each level up there
// (dequant_tile.cuh), which adds no pass over the weights.
//
// What bounds it on an H100: at the serving shapes (M = 1280 decode rows,
// K = 512..768, N = 256..1024) the work is 0.3-2 GFLOP against 4-8 MB of
// traffic (mostly the f32 output), 80-270 operations per byte, below the
// ~295 at which bf16 tensor cores would be the limit, so device memory
// bounds it in principle. This first kernel is simple and
// right rather than fast: each 256-thread block computes a 64x64 tile with
// f32 FMA on CUDA cores, staging a 16-deep K slab of x and of the
// dequantized weight in shared memory (dequant_tile.cuh). The packed bytes
// are read once per row tile and unpacked in shared memory, so the weight
// traffic stays at bits/32 of an f32 matrix; the [K, N] dense weight never
// exists in device memory. Tensor cores (wgmma), TMA and pipelining are the
// next steps.
//
// Rounding: the plain PyTorch version dequant_matmul_reference (see
// dequant_tile.cuh). Any K (the loop masks a ragged last slab), any M, any N.

#include "dequant_tile.cuh"

namespace qdt {

template <typename XT, bool BF16, bool LUT>
__global__ void __launch_bounds__(THREADS)
    dequant_matmul_kernel(const XT* __restrict__ x,
                          const uint8_t* __restrict__ packed,
                          const float* __restrict__ scale,
                          const float* __restrict__ offset,
                          const float* __restrict__ points,
                          const float* __restrict__ bias,
                          float* __restrict__ out, int M, int K, int N,
                          int bits, int64_t row_bytes) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  __shared__ float lut[LUT ? LUT_MAX : 1];
  if constexpr (LUT) load_lut(points, bits, lut);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  float acc[4][4] = {};
  tile_mma<XT, BF16, LUT>(x, M, K, packed, scale, offset, lut, bits, row_bytes,
                          N, row0, col0, acc, As, Bs);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = row0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = col0 + tx * 4 + jj;
      if (n < N) out[(int64_t)m * N + n] = bias ? acc[i][jj] + bias[n] : acc[i][jj];
    }
  }
}

template <typename XT, bool BF16, bool LUT>
static void launch(const void* x, const void* packed, const void* scale,
                   const void* offset, const void* points, const void* bias,
                   void* out, int M, int K, int N, int bits, int64_t row_bytes,
                   cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dequant_matmul_kernel<XT, BF16, LUT><<<grid, THREADS, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale), static_cast<const float*>(offset),
      static_cast<const float*>(points), static_cast<const float*>(bias),
      static_cast<float*>(out), M, K, N, bits, row_bytes);
}

template <typename XT, bool BF16>
static void launch_lut(const void* x, const void* packed, const void* scale,
                       const void* offset, const void* points, const void* bias,
                       void* out, int M, int K, int N, int bits,
                       int64_t row_bytes, cudaStream_t stream) {
  if (points)
    launch<XT, BF16, true>(x, packed, scale, offset, points, bias, out, M, K, N, bits, row_bytes, stream);
  else
    launch<XT, BF16, false>(x, packed, scale, offset, points, bias, out, M, K, N, bits, row_bytes, stream);
}

}  // namespace qdt

// x: [M, K] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); compute_bf16 selects the
// compute type; packed: uint8 [K, npad*bits/8]; scale/offset: f32
// [npad/256, K]; points: f32 [2^bits] codebook (LUT variant) or null
// (uniform grid); bias: f32 [N] or null; out: f32 [M, N].
// Returns cudaGetLastError() after the launch.
extern "C" int qdt_dequant_matmul(const void* x, int x_bf16, int compute_bf16,
                                  const void* packed, const void* scale,
                                  const void* offset, const void* points,
                                  const void* bias, void* out, int M, int K,
                                  int N, int npad, int bits, void* stream) {
  using namespace qdt;
  const int64_t row_bytes = (int64_t)npad * bits / 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (compute_bf16)
      launch_lut<__nv_bfloat16, true>(x, packed, scale, offset, points, bias, out, M, K, N, bits, row_bytes, s);
    else
      launch_lut<__nv_bfloat16, false>(x, packed, scale, offset, points, bias, out, M, K, N, bits, row_bytes, s);
  } else {
    if (compute_bf16)
      launch_lut<float, true>(x, packed, scale, offset, points, bias, out, M, K, N, bits, row_bytes, s);
    else
      launch_lut<float, false>(x, packed, scale, offset, points, bias, out, M, K, N, bits, row_bytes, s);
  }
  return static_cast<int>(cudaGetLastError());
}
