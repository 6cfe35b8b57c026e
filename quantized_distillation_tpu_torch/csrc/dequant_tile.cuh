// Shared f32 tile loop of the packed-weight kernels: one 64x64 output tile
// of x[M, K] @ dequant(W)[K, N], accumulated in f32 by plain FMA on the CUDA
// cores (f32 compute).
//
// The packed layout is the one kernels/packed.py writes: W's levels are
// planar-packed uint8 [K, Npad*bits/8] in 256-column buckets (value t of
// byte i of a bucket is column i + t*256/f, f = 8/bits), and the per-bucket
// affine is scale/offset [Npad/256, K] f32, so w[k,n] = lvl*s[j,k] + o[j,k]
// with j = n/256. A 64-column tile never straddles a bucket, so each K-row
// of a tile has one (scale, offset) pair. A learned-codebook matrix (LUT
// variant) stores each weight's point index as its level and the 2^bits f32
// points beside it: w[k,n] = pts[lvl]*s[j,k] + o[j,k]. Its block first loads
// the points (at most 256 floats) into shared memory with load_lut, and the
// tile loop looks each level up there: a GPU gathers from shared memory in
// one instruction, where the TPU kernel needs 2^bits select passes.
//
// Rounding follows the plain PyTorch version (dequant_matmul_reference) at
// f32 compute: the weight (or its LUT value) is dequantized in f32 (separate
// multiply and add, no fused multiply-add, so it is the same float) and the
// products are summed in f32; only the order of the sum differs. bf16
// compute runs on the tensor cores instead (dequant_tile_tc.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qdt {

constexpr int BUCKET = 256;
constexpr int BM = 64;   // tile rows
constexpr int BN = 64;   // tile columns (divides BUCKET)
constexpr int BK = 16;   // K slab per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int LUT_MAX = 256;  // points of an 8-bit codebook

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Level of logical column n in row k of the planar-packed matrix.
__device__ __forceinline__ int unpack_level(const uint8_t* packed,
                                            int64_t row_bytes, int k, int n,
                                            int bits) {
  const int f = 8 / bits;
  const int plane = BUCKET / f;
  const int j = n / BUCKET;
  const int c = n % BUCKET;
  const uint8_t b = packed[(int64_t)k * row_bytes + (int64_t)j * plane + c % plane];
  return (b >> ((c / plane) * bits)) & ((1 << bits) - 1);
}

// Copy the 2^bits codebook points into shared memory; every thread of the
// block calls it, and it ends with a barrier.
__device__ __forceinline__ void load_lut(const float* __restrict__ points,
                                         int bits, float* lut) {
  for (int i = threadIdx.x; i < (1 << bits); i += blockDim.x) lut[i] = points[i];
  __syncthreads();
}

// acc[i][jj] += sum_k x[row0 + ty*4 + i, k] * w[k, col0 + tx*4 + jj], with
// rows >= M and columns >= N read as 0; with LUT, a level indexes the points
// in shared memory `lut` (see load_lut). Every thread of the block calls it;
// it ends with a barrier, so the caller may reuse shared memory after it.
template <typename XT, bool LUT>
__device__ __forceinline__ void tile_mma(
    const XT* __restrict__ x, int M, int K, const uint8_t* __restrict__ packed,
    const float* __restrict__ scale, const float* __restrict__ offset,
    const float* lut, int bits, int64_t row_bytes, int N, int row0, int col0,
    float (&acc)[4][4], float (*As)[BM], float (*Bs)[BN]) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int j = col0 / BUCKET;
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int e = tid; e < BM * BK; e += THREADS) {
      // x slab [BM rows, BK k]: consecutive threads read consecutive k
      const int m = e / BK, kk = e % BK;
      const int gm = row0 + m, gk = k0 + kk;
      float v = 0.f;
      if (gm < M && gk < K) v = load_f32(x + (int64_t)gm * K + gk);
      As[kk][m] = v;
    }
#pragma unroll
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN, cn = e % BN;
      const int gk = k0 + kk, gn = col0 + cn;
      float w = 0.f;
      if (gk < K && gn < N) {
        const int level = unpack_level(packed, row_bytes, gk, gn, bits);
        const float lvl = LUT ? lut[level] : (float)level;
        const int64_t so = (int64_t)j * K + gk;
        w = __fadd_rn(__fmul_rn(lvl, scale[so]), offset[so]);
      }
      Bs[kk][cn] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = Bs[kk][tx * 4 + i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
    }
    __syncthreads();
  }
}

}  // namespace qdt
