// Fused generator: dequantize + matmul + bias, then per row the top-k
// (k <= 8) logits with their vocab indices and the row logsumexp, without
// writing the [M, N] logits to device memory.
//
// Replaces the TPU kernel _topk_kernel of
// quantized_distillation_tpu/kernels/topk_fused.py (launched by
// dequant_matmul_topk there), both its uniform branch and its codebook-LUT
// branch (pts_ref): given a codebook, each level is first looked up in the
// 2^bits points, which pass 1 keeps in shared memory (dequant_tile.cuh's LUT
// variant). That kernel walks the vocab in order on one
// core, carrying lane-class survivors in VMEM from one grid step to the
// next. Blocks on a GPU run in no order and carry nothing between them, so
// this is two passes:
//
//   pass 1 (topk_partial_kernel): a grid of (64-row tile) x (vocab split).
//     Each block walks its split in 64-column tiles: the logits tile is
//     computed on chip (dequant_tile.cuh) into shared memory with the bias
//     added, then 4 threads per row scan it, each keeping an exact top-8 of
//     (value, index) in registers and an online (max, sum of exp). The 4
//     lists of a row merge by warp shuffles and only [M, splits, 8] values
//     and indices plus [M, splits] (max, sum) reach device memory.
//   pass 2 (topk_merge_kernel): one thread per row merges its splits'
//     lists into the top-k and computes lse = max + log(sum).
//
// Ties go to the lower vocab index at every step (values descending, equal
// values by ascending index: the order of jax.lax.top_k and of the plain
// version's stable sort), so the result is exact for every input and the
// TPU kernel's exactness certificate is always 1. Padded vocab columns take
// part with whatever bias they carry (the uniform serving generator is
// packed N-wide with -1e9 there), and columns at or past the logical width N
// never do: a codebook generator is packed with edge-padded weights and an
// N-long bias, so pass 1 masks every column n >= N itself.
//
// What bounds it on an H100: at the serving shape (M = 1280, K = 256,
// N = 32768) it does 21.5 GFLOP against ~6 MB (the 4 MB of packed weights
// and the f32 activations), ~3,500 operations per byte, so the tensor-core
// rate bounds it. This first kernel runs the products as f32 FMA on CUDA
// cores (see dequant_tile.cuh), far from that bound; tensor cores are the
// next step. The logits never reach memory, which was the point of the TPU
// kernel and stays the point here.

#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "dequant_tile.cuh"

namespace qdt {

constexpr int KMAX = 8;
constexpr int SEL = 4;  // threads per row in the select phase (BM * SEL == THREADS)

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// Insert (v, i) into a list kept in (value desc, index asc) order.
__device__ __forceinline__ void insert(float (&tv)[KMAX], int (&ti)[KMAX],
                                       float v, int i) {
  if (!better(v, i, tv[KMAX - 1], ti[KMAX - 1])) return;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (better(v, i, tv[j], ti[j])) {
      const float t = tv[j];
      tv[j] = v;
      v = t;
      const int u = ti[j];
      ti[j] = i;
      i = u;
    }
  }
}

// Online (max, sum of exp(x - max)) merge; an empty side has max -inf.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    s = s2;
    return;
  }
  const float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

template <typename XT, bool BF16, bool LUT>
__global__ void __launch_bounds__(THREADS)
    topk_partial_kernel(const XT* __restrict__ x,
                        const uint8_t* __restrict__ packed,
                        const float* __restrict__ scale,
                        const float* __restrict__ offset,
                        const float* __restrict__ points,
                        const float* __restrict__ bias, int M, int K, int N,
                        int bits, int64_t row_bytes, int tiles_per_split,
                        int splits, float* __restrict__ part_v,
                        int* __restrict__ part_i, float* __restrict__ part_m,
                        float* __restrict__ part_s) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  __shared__ float S[BM][BN + 1];
  __shared__ float lut[LUT ? LUT_MAX : 1];
  if constexpr (LUT) load_lut(points, bits, lut);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int r = tid / SEL, q = tid % SEL;  // select role: row r, quarter q
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int ntiles = (N + BN - 1) / BN;
  const int t0 = split * tiles_per_split;
  const int t1 = min(ntiles, t0 + tiles_per_split);

  float tv[KMAX];
  int ti[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    tv[j] = -INFINITY;
    ti[j] = INT_MAX;
  }
  float rm = -INFINITY, rs = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int col0 = t * BN;
    float acc[4][4] = {};
    tile_mma<XT, BF16, LUT>(x, M, K, packed, scale, offset, lut, bits,
                            row_bytes, N, row0, col0, acc, As, Bs);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int n = col0 + tx * 4 + jj;
        S[ty * 4 + i][tx * 4 + jj] = n < N ? acc[i][jj] + bias[n] : 0.f;
      }
    __syncthreads();
    if (row0 + r < M) {
#pragma unroll 4
      for (int c = 0; c < BN / SEL; ++c) {
        const int cn = q * (BN / SEL) + c;
        const int n = col0 + cn;
        if (n >= N) break;
        const float v = S[r][cn];
        if (v > rm) {
          rs = rs * expf(rm - v) + 1.f;
          rm = v;
        } else {
          rs += expf(v - rm);
        }
        insert(tv, ti, v, n);
      }
    }
    __syncthreads();
  }

  // merge the SEL lists of a row (consecutive lanes of one warp)
#pragma unroll
  for (int off = SEL / 2; off >= 1; off /= 2) {
    float ov[KMAX];
    int oi[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      ov[j] = __shfl_down_sync(0xffffffffu, tv[j], off);
      oi[j] = __shfl_down_sync(0xffffffffu, ti[j], off);
    }
    const float om = __shfl_down_sync(0xffffffffu, rm, off);
    const float os = __shfl_down_sync(0xffffffffu, rs, off);
    if (q < off) {
#pragma unroll
      for (int j = 0; j < KMAX; ++j) insert(tv, ti, ov[j], oi[j]);
      lse_merge(rm, rs, om, os);
    }
  }
  const int row = row0 + r;
  if (q == 0 && row < M) {
    const int64_t base = (int64_t)row * splits + split;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      part_v[base * KMAX + j] = tv[j];
      part_i[base * KMAX + j] = ti[j];
    }
    part_m[base] = rm;
    part_s[base] = rs;
  }
}

__global__ void topk_merge_kernel(const float* __restrict__ part_v,
                                  const int* __restrict__ part_i,
                                  const float* __restrict__ part_m,
                                  const float* __restrict__ part_s, int M,
                                  int splits, int k, float* __restrict__ out_v,
                                  int* __restrict__ out_i,
                                  float* __restrict__ out_lse) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= M) return;
  float tv[KMAX];
  int ti[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    tv[j] = -INFINITY;
    ti[j] = INT_MAX;
  }
  float m = -INFINITY, s = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const int64_t base = (int64_t)row * splits + sp;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) insert(tv, ti, part_v[base * KMAX + j], part_i[base * KMAX + j]);
    lse_merge(m, s, part_m[base], part_s[base]);
  }
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      out_v[(int64_t)row * k + j] = tv[j];
      out_i[(int64_t)row * k + j] = ti[j];
    }
  }
  out_lse[row] = m + logf(s);
}

template <typename XT, bool BF16, bool LUT>
static void launch_partial(const void* x, const void* packed, const void* scale,
                           const void* offset, const void* points,
                           const void* bias, int M, int K, int N, int bits,
                           int64_t row_bytes, int tiles_per_split, int splits,
                           void* part_v, void* part_i, void* part_m,
                           void* part_s, cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, splits);
  topk_partial_kernel<XT, BF16, LUT><<<grid, THREADS, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale), static_cast<const float*>(offset),
      static_cast<const float*>(points), static_cast<const float*>(bias), M, K,
      N, bits, row_bytes, tiles_per_split, splits, static_cast<float*>(part_v),
      static_cast<int*>(part_i), static_cast<float*>(part_m),
      static_cast<float*>(part_s));
}

template <typename XT, bool BF16>
static void launch_partial_lut(const void* x, const void* packed,
                               const void* scale, const void* offset,
                               const void* points, const void* bias, int M,
                               int K, int N, int bits, int64_t row_bytes,
                               int tiles_per_split, int splits, void* part_v,
                               void* part_i, void* part_m, void* part_s,
                               cudaStream_t stream) {
  if (points)
    launch_partial<XT, BF16, true>(x, packed, scale, offset, points, bias, M, K, N, bits, row_bytes, tiles_per_split, splits, part_v, part_i, part_m, part_s, stream);
  else
    launch_partial<XT, BF16, false>(x, packed, scale, offset, points, bias, M, K, N, bits, row_bytes, tiles_per_split, splits, part_v, part_i, part_m, part_s, stream);
}

}  // namespace qdt

// x: [M, K] f32 or bf16 (x_bf16); packed/scale/offset/points as in
// qdt_dequant_matmul; bias: f32 [N] (required); scratch part_v/part_i
// [M, splits, 8] and part_m/part_s [M, splits]; outputs out_v f32 [M, k],
// out_i int32 [M, k], out_lse f32 [M]. Vocab tile t (64 columns) belongs to
// split t / tiles_per_split. Returns cudaGetLastError() after both launches.
extern "C" int qdt_topk_fused(const void* x, int x_bf16, int compute_bf16,
                              const void* packed, const void* scale,
                              const void* offset, const void* points,
                              const void* bias, int M, int K, int N, int npad,
                              int bits, int k,
                              int tiles_per_split, int splits, void* part_v,
                              void* part_i, void* part_m, void* part_s,
                              void* out_v, void* out_i, void* out_lse,
                              void* stream) {
  using namespace qdt;
  const int64_t row_bytes = (int64_t)npad * bits / 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (compute_bf16)
      launch_partial_lut<__nv_bfloat16, true>(x, packed, scale, offset, points, bias, M, K, N, bits, row_bytes, tiles_per_split, splits, part_v, part_i, part_m, part_s, s);
    else
      launch_partial_lut<__nv_bfloat16, false>(x, packed, scale, offset, points, bias, M, K, N, bits, row_bytes, tiles_per_split, splits, part_v, part_i, part_m, part_s, s);
  } else {
    if (compute_bf16)
      launch_partial_lut<float, true>(x, packed, scale, offset, points, bias, M, K, N, bits, row_bytes, tiles_per_split, splits, part_v, part_i, part_m, part_s, s);
    else
      launch_partial_lut<float, false>(x, packed, scale, offset, points, bias, M, K, N, bits, row_bytes, tiles_per_split, splits, part_v, part_i, part_m, part_s, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 128;
  topk_merge_kernel<<<(M + threads - 1) / threads, threads, 0, s>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<const float*>(part_m), static_cast<const float*>(part_s), M,
      splits, k, static_cast<float*>(out_v), static_cast<int*>(out_i),
      static_cast<float*>(out_lse));
  return static_cast<int>(cudaGetLastError());
}
