// Grouped matrix product over the experts a card holds (the expert layer of
// models/deepseek_v2.py): one product per held expert over that expert's
// contiguous rows, with the group offsets read on the device.
//
// No TPU kernel is replaced: the JAX package has no expert layer.
//
// offs ([G + 1] int64) bounds the G held groups: group g is rows
// offs[g]..offs[g + 1] of the permuted pairs; rows from offs[G] on are the
// discard group, which no kernel reads or writes.
//
// grouped_mm_kernel<B_ALONG>: out[p] = x[rows[p]] @ B_g for every row p of a
//   held group g. B_g is w[g] ([R, J], the forward) or w[g]^T (w[g] is
//   [J, R], the data gradient: B_ALONG, read along the depth). rows (int64)
//   gathers the rows of x inside the kernel; without it x's row p is read.
//   With covered (int64 [G]), each row tile adds the rows it writes to its
//   group's count, so a row that no tile covers shows as a drop.
// grouped_mm_wgrad_kernel: dw[g] = x[rows_g]^T @ dy_g, a reduction over
//   however many rows group g has (0 for an empty group).
//
// What bounds it on an H100: the f32 operations. The train configurations
// keep TF32 off, so the products run on the CUDA cores (67 TFLOP/s of FMA);
// at a held expert's widths (2048 -> 1408 and back) a 128 x 128 output tile
// does 64 FMAs per float it reads from device memory and 4 per float it
// reads from shared memory, so neither feed bounds it. The design is the
// classic SIMT product: 256 threads a block, each holding an 8 x 8 block of
// the output tile in registers (rows ty*4.. and 64 + ty*4.., columns alike,
// so that the shared-memory reads and the output's stores are float4s on
// neighbouring addresses); a depth step of 8, double-buffered in shared
// memory, the next step's two float4s a thread fetched into registers while
// the current step is multiplied, one __syncthreads a step.
//
// Capture: every grid is sized for the worst case (all P rows in one group
// takes ceil(P / 128) row tiles, and each group's ragged last tile one more:
// ceil(P / 128) + G), and each block finds its group and row tile from offs
// on the device; a block past the last tile returns at once. So there is no
// host sync and no buffer of data-dependent size, and the calls are
// captured in the train step's CUDA graph. Blocks are ordered with the
// output's column tiles fastest, so the blocks that read one row tile run
// together and share it through L2.
//
// Numerics: f32 in and out, each output a sequence of FMAs in depth order;
// the host checks that every width is a multiple of 4 and every row
// 16-byte aligned (float4 loads).

#include <cuda_runtime.h>
#include <stdint.h>

namespace qdt {

constexpr int TILE = 128;          // output tile: rows and columns
constexpr int DEPTH = 8;           // depth step
constexpr int LD = TILE + 4;       // padded shared row: transposed stores spread over banks
constexpr int THREADS = 256;       // 16 x 16 threads, 8 x 8 outputs each

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Element (r, i) of an operand at row(i)[r]: contiguous along the depth r.
// A thread fetches 4 depths of one row i (two threads a row) and stores
// them transposed, s[r][i].
struct AlongLoad {
  const float* p;  // row(i) + r4
  int i, r4, depth;
  bool ok;
  __device__ float4 fetch(int r0) const {
    return ok && r0 + r4 < depth ? ldg4(p + r0) : zero4();
  }
  __device__ void put(float (*s)[LD], float4 v) const {
    s[r4][i] = v.x;
    s[r4 + 1][i] = v.y;
    s[r4 + 2][i] = v.z;
    s[r4 + 3][i] = v.w;
  }
};

// Element (r, i) of an operand at base + r * ld + i: contiguous along i. A
// thread fetches 4 neighbouring i of one depth r (32 threads a depth).
struct AcrossLoad {
  const float* p;  // base + r * ld + i4
  long long ld;
  int r, i4, depth;
  bool ok;
  __device__ float4 fetch(int r0) const {
    return ok && r0 + r < depth ? ldg4(p + (long long)r0 * ld) : zero4();
  }
  __device__ void put(float (*s)[LD], float4 v) const {
    *reinterpret_cast<float4*>(&s[r][i4]) = v;
  }
};

// Element (r, i) at base + src(p) * ld + i, for the row p = start + r of a
// group ending at end (src(p) = rows[p], or p): contiguous along i.
struct RowsAcrossLoad {
  const float* base;  // + i0 + i4
  const long long* rows;
  long long ld, start, end;
  int r, i4;
  bool ok;
  __device__ float4 fetch(int r0) const {
    const long long p = start + r0 + r;
    if (!ok || p >= end) return zero4();
    const long long src = rows ? rows[p] : p;
    return ldg4(base + src * ld);
  }
  __device__ void put(float (*s)[LD], float4 v) const {
    *reinterpret_cast<float4*>(&s[r][i4]) = v;
  }
};

// acc[i][j] = sum over the depth of A(r, row i) * B(r, column j), for this
// thread's 8 rows and 8 columns of the block's tile, over `steps` depth
// steps.
template <class LA, class LB>
__device__ __forceinline__ void mainloop(const LA& la, const LB& lb, int steps,
                                         float (&acc)[8][8]) {
  __shared__ __align__(16) float sa[2][DEPTH][LD];
  __shared__ __align__(16) float sb[2][DEPTH][LD];
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (steps <= 0) return;
  la.put(sa[0], la.fetch(0));
  lb.put(sb[0], lb.fetch(0));
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < steps;
    float4 na = zero4(), nb = zero4();
    if (more) {
      na = la.fetch((s + 1) * DEPTH);
      nb = lb.fetch((s + 1) * DEPTH);
    }
#pragma unroll
    for (int k = 0; k < DEPTH; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sa[cur][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sa[cur][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sb[cur][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sb[cur][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      la.put(sa[cur ^ 1], na);
      lb.put(sb[cur ^ 1], nb);
    }
    __syncthreads();
  }
}

// Row i (0..7) of this thread's 8 x 8 block within the tile; column j alike.
__device__ __forceinline__ int tile_row(int i) {
  return (i < 4 ? 0 : 64) + (threadIdx.x >> 4) * 4 + (i & 3);
}
__device__ __forceinline__ int tile_col(int half) {
  return half * 64 + (threadIdx.x & 15) * 4;
}

template <bool B_ALONG>
__global__ void __launch_bounds__(THREADS, 2)
    grouped_mm_kernel(const float* __restrict__ x, const long long* __restrict__ rows,
                      const float* __restrict__ w, float* __restrict__ out,
                      const long long* __restrict__ offs, long long* covered, int G,
                      int depth, int width, long long sxm, long long swg, long long ldw,
                      long long som) {
  // this block's group and row tile: tiles are numbered group by group
  const long long mt = blockIdx.y;
  long long first = 0, start = 0, end = 0;
  int g = -1;
  for (int q = 0; q < G; ++q) {
    const long long s = offs[q], e = offs[q + 1];
    const long long tiles = (e - s + TILE - 1) / TILE;
    if (mt < first + tiles) {
      g = q;
      start = s + (mt - first) * TILE;
      end = e;
      break;
    }
    first += tiles;
  }
  if (g < 0) return;  // past the last tile: the whole block leaves
  const int j0 = blockIdx.x * TILE;
  const int t = threadIdx.x;
  if (covered != nullptr && blockIdx.x == 0 && t == 0) {
    const long long n = (end - start < TILE ? end - start : TILE);
    atomicAdd(reinterpret_cast<unsigned long long*>(covered) + g,
              static_cast<unsigned long long>(n));
  }

  AlongLoad la;
  {
    const long long p = start + (t >> 1);
    la.i = t >> 1;
    la.r4 = (t & 1) * 4;
    la.depth = depth;
    la.ok = p < end;
    const long long src = la.ok ? (rows ? rows[p] : p) : 0;
    la.p = x + src * sxm + la.r4;
  }
  const float* wg = w + (long long)g * swg;
  float acc[8][8];
  if constexpr (B_ALONG) {  // B(r, j) = w[g][j, r]
    AlongLoad lb;
    lb.i = t >> 1;
    lb.r4 = (t & 1) * 4;
    lb.depth = depth;
    lb.ok = j0 + lb.i < width;
    lb.p = wg + (long long)(lb.ok ? j0 + lb.i : 0) * ldw + lb.r4;
    mainloop(la, lb, (depth + DEPTH - 1) / DEPTH, acc);
  } else {  // B(r, j) = w[g][r, j]
    AcrossLoad lb;
    lb.r = t >> 5;
    lb.i4 = (t & 31) * 4;
    lb.ld = ldw;
    lb.depth = depth;
    lb.ok = j0 + lb.i4 < width;
    lb.p = wg + (long long)lb.r * ldw + (lb.ok ? j0 + lb.i4 : 0);
    mainloop(la, lb, (depth + DEPTH - 1) / DEPTH, acc);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long p = start + tile_row(i);
    if (p >= end) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + tile_col(h);
      if (j < width)
        *reinterpret_cast<float4*>(out + p * som + j) =
            make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    grouped_mm_wgrad_kernel(const float* __restrict__ x, const long long* __restrict__ rows,
                            const float* __restrict__ dy, float* __restrict__ dw,
                            const long long* __restrict__ offs, int K, int N, long long sxm,
                            long long sdm, long long sdg, long long sdk) {
  const int g = blockIdx.z;
  const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  const long long start = offs[g], end = offs[g + 1];
  const int t = threadIdx.x;
  RowsAcrossLoad la, lb;  // A(r, i) = x[src(start + r), i]; B(r, j) = dy[start + r, j]
  la.rows = rows;
  lb.rows = nullptr;
  la.start = lb.start = start;
  la.end = lb.end = end;
  la.r = lb.r = t >> 5;
  la.i4 = lb.i4 = (t & 31) * 4;
  la.ld = sxm;
  lb.ld = sdm;
  la.ok = i0 + la.i4 < K;
  lb.ok = j0 + lb.i4 < N;
  la.base = x + (la.ok ? i0 + la.i4 : 0);
  lb.base = dy + (lb.ok ? j0 + lb.i4 : 0);
  const long long n = end - start;
  float acc[8][8];
  mainloop(la, lb, static_cast<int>((n + DEPTH - 1) / DEPTH), acc);

  float* dwg = dw + (long long)g * sdg;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = i0 + tile_row(i);
    if (k >= K) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + tile_col(h);
      if (j < N)
        *reinterpret_cast<float4*>(dwg + (long long)k * sdk + j) =
            make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
    }
  }
}

}  // namespace qdt

// out[p] = x[rows[p]] @ w[g] (w_along = 0: w [G, depth, width]) or
// x[rows[p]] @ w[g]^T (w_along = 1: w [G, width, depth]) over the held
// groups; rows may be null (x's row p); covered (int64 [G]) may be null.
// x, w, out f32 with unit stride along their last dim; depth and width
// multiples of 4; sxm, ldw (w's stride over its middle dim), som multiples
// of 4; every pointer 16-byte aligned. row_tiles = ceil(P / 128) for the P
// rows of out. Returns cudaGetLastError() after the launch.
extern "C" int qdt_grouped_mm(const void* x, const void* rows, const void* w, void* out,
                              const void* offs, void* covered, int G, int depth, int width,
                              int row_tiles, long long sxm, long long swg, long long ldw,
                              long long som, int w_along, void* stream) {
  using namespace qdt;
  const dim3 grid((width + TILE - 1) / TILE, row_tiles + G);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xr = static_cast<const float*>(x);
  const auto* rr = static_cast<const long long*>(rows);
  const auto* wr = static_cast<const float*>(w);
  auto* o = static_cast<float*>(out);
  const auto* of = static_cast<const long long*>(offs);
  auto* cv = static_cast<long long*>(covered);
  if (w_along)
    grouped_mm_kernel<true><<<grid, THREADS, 0, s>>>(xr, rr, wr, o, of, cv, G, depth, width,
                                                     sxm, swg, ldw, som);
  else
    grouped_mm_kernel<false><<<grid, THREADS, 0, s>>>(xr, rr, wr, o, of, cv, G, depth, width,
                                                      sxm, swg, ldw, som);
  return static_cast<int>(cudaGetLastError());
}

// dw[g] = x[rows_g]^T @ dy_g for g < G: x f32 rows of K (stride sxm), dy
// [P, N] (stride sdm), dw [G, K, N] (strides sdg, sdk), each with unit
// stride along its last dim; K, N and the strides multiples of 4; rows may
// be null. Every element of dw is written. Returns cudaGetLastError().
extern "C" int qdt_grouped_wgrad(const void* x, const void* rows, const void* dy, void* dw,
                                 const void* offs, int G, int K, int N, long long sxm,
                                 long long sdm, long long sdg, long long sdk, void* stream) {
  using namespace qdt;
  const dim3 grid((N + TILE - 1) / TILE, (K + TILE - 1) / TILE, G);
  qdt::grouped_mm_wgrad_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const long long*>(rows),
      static_cast<const float*>(dy), static_cast<float*>(dw),
      static_cast<const long long*>(offs), K, N, sxm, sdm, sdg, sdk);
  return static_cast<int>(cudaGetLastError());
}
