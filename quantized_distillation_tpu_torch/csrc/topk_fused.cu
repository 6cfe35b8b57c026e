// Fused generator: dequantize + matmul + bias, then per row the top-k
// (k <= 8) logits with their vocab indices and the row logsumexp, without
// writing the [M, N] logits to device memory.
//
// Replaces the TPU kernel _topk_kernel of
// quantized_distillation_tpu/kernels/topk_fused.py:78 (launched by
// dequant_matmul_topk there, :685), both its uniform branch and its
// codebook-LUT branch (pts_ref, :197-202): given a codebook, each level is
// first looked up in the 2^bits points, which a block keeps in shared
// memory. That kernel walks the vocab in order on one core, carrying
// lane-class survivors in VMEM from one grid step to the next. Blocks on a
// GPU run in no order and carry nothing between them, so this is two
// passes:
//
//   pass 1: a grid of (row tile) x (vocab split). Each block walks its
//     split's vocab tiles, computes each logits tile on chip, adds the bias
//     and folds it into each row's exact top-8 of (value, index) and online
//     (max, sum of exp). Only [M, splits, 8] values and indices plus
//     [M, splits] (max, sum) reach device memory.
//   pass 2 (topk_merge_kernel): one warp per row merges its splits' lists
//     (contiguous, so the reads coalesce) into the top-k and computes
//     lse = max + log(sum).
//
// bf16 compute (the serving path) runs pass 1 on the tensor cores
// (topk_tc_kernel): a block of WG warpgroups rounds its 64 * MT * WG rows
// of x to bf16 once, into K/64 swizzled A slabs that stay resident in
// shared memory for the whole split. Only weights move after that: the
// packed bytes and each slab's scale and offset stream through
// dequant_tile_tc.cuh's TMA ring, AHEAD slabs ahead, over the split's
// (vocab tile, k slab) pairs, so the ring does not drain at a tile
// boundary. Each weight is dequantized once per block (transform_b, shared
// with the dequant-matmul) into a double-buffered swizzled bf16 B tile and
// multiplied by wgmma.m64n64k16 into f32 registers. At a tile's last slab,
// after wgmma.wait_group 0, each thread folds its accumulators straight
// into its rows' state: in wgmma's layout a thread holds 16 columns of each
// of 2 MT rows, and the 4 lanes of a quad share the rows. One exponential
// per logit (the tile's max first, one rescale a tile). Where K is so large
// that x cannot stay resident even for 64 rows, topk_tc_stream_kernel
// streams x per slab through tc::tile_mma_tc instead (the ring then drains
// at every tile).
//
// The selection (select_tile) is filter, then merge. Every lane of a quad
// holds its row's list alike, and one compare a logit against the list's
// k-th value drops nearly everything: beyond a split's first tiles a
// value rarely enters a row's top-k (about k ln(n / k) of a split's n
// columns do). A split's first tile, where the list is empty, and any tile
// where a quad has many survivors (a run of records) are filtered again by
// the k-th of the 8 pairs that are the quad's lanes' two best: a bound from
// the tile alone. The survivors merge into the list once a tile: the lanes
// store the row's values in the B tiles (free between a tile's last product
// and the next tile's dequant, so shared memory, and with it the plan, is
// what it was) and each lane of the quad inserts the quad's survivors, in
// one order, into its copy of the list; the loop runs as often as the
// warp's busiest quad has survivors. At the end of the split lane 0 of each
// quad writes the row's list; (max, sum) merge by shuffles. The logits
// never reach device memory. What bounds the selection is its share of the
// CUDA cores' time between one tile's products and the next, which it does
// not overlap: an exponential and a compare a logit, the scratch stores
// where a warp has a survivor, and one insert (a few selects deep) a
// survivor. On an H100 at the serving shape it is ~74 us of a ~160 us call.
//
// f32 compute stays on the CUDA cores (topk_partial_kernel over tile_mma,
// logits through a shared-memory tile, 4 threads a row): the tensor cores
// have no exact f32 mode, and the f32 token parity checks rest on f32.
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
// and the f32 activations read once, the candidates written), ~3,600
// operations per byte, so the bf16 tensor-core rate bounds it: 21.7 us at
// 989 TFLOP/s. Beyond the products, every block unpacks and dequantizes
// its split's weights once (10 row tiles of 128 rows: 84 M weights a call)
// and the CUDA cores take one exponential and one compare per logit
// (41.9 M logits); both run beside the tensor cores, not on them.
//
// The generator's device work stays in kernels whose names hold
// topk_tc_kernel, topk_tc_stream_kernel, topk_partial_kernel or
// topk_merge_kernel: the benchmark's generator_roofline finds the
// generator's time by those names, so a renamed or added kernel would drop
// its time from the share and inflate it.

#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "dequant_tile.cuh"
#include "dequant_tile_tc.cuh"

namespace qdt {

constexpr int KMAX = 8;
constexpr int SEL = 4;  // threads per row in the f32 select phase (BM * SEL == THREADS)
constexpr int MERGE_THREADS = 256;  // pass 2: a warp per row

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

// Pass 1's outputs: [M, splits, KMAX] values and indices, [M, splits] max
// and sum.
struct Parts {
  float* v;
  int* i;
  float* m;
  float* s;
};

// ------------------------------------------------- f32 compute, CUDA cores

template <typename XT, bool LUT>
__global__ void __launch_bounds__(THREADS)
    topk_partial_kernel(const XT* __restrict__ x,
                        const uint8_t* __restrict__ packed,
                        const float* __restrict__ scale,
                        const float* __restrict__ offset,
                        const float* __restrict__ points,
                        const float* __restrict__ bias, int M, int K, int N,
                        int bits, int64_t row_bytes, int tiles_per_split,
                        int splits, Parts out) {
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
    tile_mma<XT, LUT>(x, M, K, packed, scale, offset, lut, bits, row_bytes, N, row0, col0, acc,
                      As, Bs);
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
      out.v[base * KMAX + j] = tv[j];
      out.i[base * KMAX + j] = ti[j];
    }
    out.m[base] = rm;
    out.s[base] = rs;
  }
}

// ----------------------------------------------- bf16 compute, tensor cores

constexpr unsigned FULL = 0xffffffffu;
// Survivors of a quad above which a tile is filtered again by its own best
// pairs before the merge (the first tile of a split, a run of records).
constexpr int HEAVY = 2 * KMAX;

// The state of R rows of one thread. The 4 lanes of a quad share their
// rows in wgmma's layout and hold each row's list alike: its exact top-KMAX
// so far of (value, index) in (value desc, index asc) order, and its
// ktop-th value, the filter's threshold. Each lane keeps its own online
// (max, sum of exp(x - max)) over its columns.
template <int R>
struct Rows {
  float tv[R][KMAX];
  int ti[R][KMAX];
  float kth[R], m[R], s[R];
  __device__ __forceinline__ Rows() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        tv[r][j] = -INFINITY;
        ti[r][j] = INT_MAX;
      }
      kth[r] = m[r] = -INFINITY;
      s[r] = 0.f;
    }
  }
};

// Column of value e of a thread's row of a tile, less 2 (lane % 4), in
// wgmma's layout (sub-tile e / 16, column 8 c + 2 (lane % 4) + u where
// e % 16 = 2 c + u). It grows with e.
__device__ __forceinline__ unsigned col_of(unsigned e) { return e / 16 * 64 + e % 16 / 2 * 8 + e % 2; }

// Inserts (v, i), a pair not in the list, into a list kept in (value desc,
// index asc) order. Every entry is compared with it at once, then each is
// kept, replaced or shifted down: a few selects deep, where a chain of
// compare-and-swaps is KMAX steps deep.
__device__ __forceinline__ void insert_wide(float (&tv)[KMAX], int (&ti)[KMAX], float v, int i) {
  bool ahead[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) ahead[j] = better(tv[j], ti[j], v, i);
#pragma unroll
  for (int j = KMAX - 1; j > 0; --j) {
    tv[j] = ahead[j] ? tv[j] : ahead[j - 1] ? v : tv[j - 1];
    ti[j] = ahead[j] ? ti[j] : ahead[j - 1] ? i : ti[j - 1];
  }
  tv[0] = ahead[0] ? tv[0] : v;
  ti[0] = ahead[0] ? ti[0] : i;
}

// e^x through the MUFU's ex2, subnormal results flushed to 0: a term under
// 2^-126 of a sum whose largest term is 1 moves nothing, and __expf spends 4
// more instructions a value keeping them.
__device__ __forceinline__ float exp_ftz(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
#else
  return expf(x);
#endif
}

__device__ __forceinline__ int quad_sum(int x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

// Pair (x, xi) ahead of (y, yi) in the list order; equal pairs (only empty
// ones, (-inf, INT_MAX)) by the order of their slots, `first` when x's slot
// comes first.
__device__ __forceinline__ int ahead_of(float x, int xi, float y, int yi, bool first) {
  return better(x, xi, y, yi) || (first && x == y && xi == yi);
}

// The ktop-th (<= 8) of the 8 pairs that a quad's lanes give, each its two
// best of a row's tile, (a1, n1) before (a2, n2): 8 actual pairs of the row,
// so at least ktop of its pairs are at or ahead of it. The 8 ranks are 0..7
// and one lane holds rank ktop - 1; every lane of the quad returns it.
__device__ __forceinline__ void quad_kth(float a1, int n1, float a2, int n2, int ktop, float& kv,
                                         int& ki) {
  const int q = threadIdx.x % 4;
  int r1 = 0, r2 = 1;
#pragma unroll
  for (int d = 1; d < 4; ++d) {
    const float b1 = __shfl_xor_sync(FULL, a1, d), b2 = __shfl_xor_sync(FULL, a2, d);
    const int m1 = __shfl_xor_sync(FULL, n1, d), m2 = __shfl_xor_sync(FULL, n2, d);
    const bool first = (q ^ d) < q;
    r1 += ahead_of(b1, m1, a1, n1, first) + ahead_of(b2, m2, a1, n1, first);
    r2 += ahead_of(b1, m1, a2, n2, first) + ahead_of(b2, m2, a2, n2, first);
  }
  int has = r1 == ktop - 1 || r2 == ktop - 1;
  kv = r1 == ktop - 1 ? a1 : a2;
  ki = r1 == ktop - 1 ? n1 : n2;
#pragma unroll
  for (int d = 1; d < 4; d *= 2) {
    const float ov = __shfl_xor_sync(FULL, kv, d);
    const int oi = __shfl_xor_sync(FULL, ki, d), oh = __shfl_xor_sync(FULL, has, d);
    kv = has ? kv : ov;
    ki = has ? ki : oi;
    has |= oh;
  }
}

// The bias of this thread's columns of the tile at col0 in wgmma's layout
// (sub-tile sub, column 8 c + 2 (lane % 4) + u at b[sub][2 c + u]); -inf at
// n >= N, which masks those columns out of max, sum and top-k.
template <int NSUB>
__device__ __forceinline__ void load_bias(const float* __restrict__ bias, int col0, int N,
                                          float (&b)[NSUB][16]) {
  const int q = threadIdx.x % 4;
#pragma unroll
  for (int sub = 0; sub < NSUB; ++sub)
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int n = col0 + sub * 64 + 8 * (e / 2) + 2 * q + e % 2;
      b[sub][e] = n < N ? bias[n] : -INFINITY;
    }
}

// Folds a finished tile into this thread's rows: acc in wgmma's layout for
// MT row tiles of NSUB 64-column sub-tiles from col0 (thread row 2 mt + h
// holds acc[mt * NSUB + sub][4 c + 2 h + u] at column sub * 64 + 8 c +
// 2 (lane % 4) + u: value e = 16 sub + 2 c + u of the row), b its bias
// (load_bias). Per row: the tile's max, one rescale and one exponential a
// value; then filter, then merge.
//
// Filter: a bitmask of the values above the row's ktop-th value. Exact for
// any input: a value below it has ktop better ones in the list, and one
// equal to it loses the tie, since the tile's columns come after all of the
// list's. Where a quad's survivors exceed HEAVY (the list is empty at a split's
// first tile, or the tile is a run of records), the tile is filtered again
// by the better of the list's ktop-th pair and the ktop-th of the 8 pairs
// that are its lanes' two best (quad_kth, one past it so that it passes),
// pair by pair, so ties keep only what the lower index can still win.
//
// Merge: where any lane of the warp has a survivor, each lane stores its
// row's values in `scratch` (VALS floats a thread) and the quad's 4 masks
// go to every lane of the quad; each lane reads the quad's survivors in one
// order and inserts them into its copy of the list (insert_wide), so the 4
// copies stay equal. The loop runs as often as the warp's busiest quad has
// survivors, not its busiest lane's values. Masked columns (-inf) never
// pass.
template <int MT, int NSUB>
__device__ __forceinline__ void select_tile(const float (&acc)[MT * NSUB][32],
                                            const float (&b)[NSUB][16], int col0, int ktop,
                                            float* scratch, Rows<2 * MT>& rows) {
  constexpr int VALS = 16 * NSUB;  // values of a row in this thread
  constexpr int CH = VALS / 4;     // their 16-byte chunks
  static_assert(VALS <= 32, "one mask bit a value");
  const int q = threadIdx.x % 4, lane = threadIdx.x % 32;
  const int base = col0 + 2 * q;  // column of value e: base + col_of(e)
  // value e of thread row r (= 2 mt + h)
  auto value = [&](int r, int e) {
    return acc[r / 2 * NSUB + e / 16][4 * (e % 16 / 2) + 2 * (r % 2) + e % 2] + b[e / 16][e % 16];
  };
  // every row's (max, sum) and filter first, in straight-line code; then
  // the merges, which branch
  uint32_t cands[2 * MT];
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
    float v[VALS];
#pragma unroll
    for (int e = 0; e < VALS; ++e) v[e] = value(r, e);
    float mx4[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};  // 4 independent chains
#pragma unroll
    for (int e = 0; e < VALS; ++e) mx4[e % 4] = fmaxf(mx4[e % 4], v[e]);
    const float mx = fmaxf(fmaxf(mx4[0], mx4[1]), fmaxf(mx4[2], mx4[3]));
    const float nm = fmaxf(rows.m[r], mx);  // -inf while every column so far was masked
    const float ref = nm == -INFINITY ? 0.f : nm;
    float sum4[4] = {rows.s[r] * exp_ftz(rows.m[r] - ref), 0.f, 0.f, 0.f};  // one rescale a tile
#pragma unroll
    for (int e = 0; e < VALS; ++e) sum4[e % 4] += exp_ftz(v[e] - ref);
    rows.s[r] = (sum4[0] + sum4[1]) + (sum4[2] + sum4[3]);
    rows.m[r] = nm;
    cands[r] = 0;
#pragma unroll
    for (int e = 0; e < VALS; ++e) cands[r] |= (uint32_t)(v[e] > rows.kth[r]) << e;
  }
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
    float v[VALS];
#pragma unroll
    for (int e = 0; e < VALS; ++e) v[e] = value(r, e);
    uint32_t cand = cands[r];
    if (__any_sync(FULL, quad_sum(__popc(cand)) > HEAVY)) {
      float a1 = -INFINITY, a2 = -INFINITY;
      int e1 = 0, e2 = 0;
#pragma unroll
      for (int e = 0; e < VALS; ++e) {  // strict: the lower column keeps a tie
        const bool gt1 = v[e] > a1, gt2 = v[e] > a2;
        a2 = gt1 ? a1 : gt2 ? v[e] : a2;
        e2 = gt1 ? e1 : gt2 ? e : e2;
        a1 = gt1 ? v[e] : a1;
        e1 = gt1 ? e : e1;
      }
      float kv;
      int ki;
      quad_kth(a1, a1 == -INFINITY ? INT_MAX : base + col_of(e1), a2,
               a2 == -INFINITY ? INT_MAX : base + col_of(e2), ktop, kv, ki);
      ki += ki != INT_MAX;  // so that the pair itself passes
      float lv = rows.tv[r][0];
      int li = rows.ti[r][0];
#pragma unroll
      for (int j = 1; j < KMAX; ++j) {
        lv = j == ktop - 1 ? rows.tv[r][j] : lv;
        li = j == ktop - 1 ? rows.ti[r][j] : li;
      }
      if (better(lv, li, kv, ki)) kv = lv, ki = li;
      const int lim = ki - base;
      cand = 0;
#pragma unroll
      for (int e = 0; e < VALS; ++e)
        cand |= (uint32_t)((v[e] > kv) | ((v[e] == kv) & ((int)col_of(e) < lim)) & (v[e] != -INFINITY))
                << e;
    }
    if (__any_sync(FULL, cand != 0)) {
      // the warp's values chunk-major ([16-byte chunk][lane]): a quarter
      // warp's stores fill 128 consecutive bytes
      float* const warp = scratch + threadIdx.x / 32 * 32 * VALS;
#pragma unroll
      for (int c = 0; c < CH; ++c)
        reinterpret_cast<float4*>(warp)[c * 32 + lane] =
            make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
      __syncwarp();
      uint64_t w0 = 0, w1 = 0;  // bit VALS j + e of (w1, w0): value e of lane j of the quad
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint64_t m = (uint64_t)__shfl_sync(FULL, cand, (lane & ~3) | j) << (j * VALS % 64);
        if (j * VALS < 64) w0 |= m;
        else w1 |= m;
      }
      const unsigned qlane = lane & ~3u;
      while (w0 | w1) {
        const bool high = w0 == 0;
        const uint64_t word = high ? w1 : w0;
        const unsigned bit = __ffsll((long long)word) - 1 + (high ? 64 : 0);
        if (high) w1 = word & (word - 1);
        else w0 = word & (word - 1);
        const unsigned j = bit / VALS, c = bit % VALS;
        insert_wide(rows.tv[r], rows.ti[r], warp[(c / 4 * 32 + qlane + j) * 4 + c % 4],
                    col0 + 2 * j + col_of(c));
      }
      __syncwarp();  // the quad's reads, before the next row's stores
      float kv = rows.tv[r][0];
#pragma unroll
      for (int j = 1; j < KMAX; ++j) kv = j == ktop - 1 ? rows.tv[r][j] : kv;
      rows.kth[r] = kv;
    }
  }
}

// End of a split: merges the (max, sum) of the 4 lanes of each quad (they
// share rows in wgmma's layout, and hold the rows' lists alike) into lane
// q = 0, which writes the split's entry of each of its rows below M. Thread
// row 2 mt + h is global row rowp + 64 mt + 8 h.
template <int MT>
__device__ __forceinline__ void write_split(Rows<2 * MT>& rows, int rowp, int M, int split,
                                            int splits, const Parts& out) {
  const int q = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
#pragma unroll
    for (int off = 2; off >= 1; off /= 2) {
      const float om = __shfl_down_sync(FULL, rows.m[r], off);
      const float os = __shfl_down_sync(FULL, rows.s[r], off);
      if (q < off) lse_merge(rows.m[r], rows.s[r], om, os);
    }
    const int row = rowp + 64 * (r / 2) + 8 * (r % 2);
    if (q == 0 && row < M) {
      const int64_t base = (int64_t)row * splits + split;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        out.v[base * KMAX + j] = rows.tv[r][j];
        out.i[base * KMAX + j] = rows.ti[r][j];
      }
      out.m[base] = rows.m[r];
      out.s[base] = rows.s[r];
    }
  }
}

// Rounds rows row0 .. row0 + ROWS - 1 of x to bf16 (__float2bfloat16_rn, as
// the plain version's x.to(bf16)) into ks swizzled [ROWS, 64] A slabs at a
// (slab s at a + s * ROWS * 128); rows >= M and k >= K as 0. vec: x's base
// and row stride are 16-byte aligned, so whole 8-element chunks load as
// 16-byte words. Every thread of the block calls it.
template <typename XT, int ROWS, int THREADS>
__device__ __forceinline__ void load_x_resident(const XT* __restrict__ x, int M, int K, int row0,
                                                int ks, bool vec, uint8_t* a) {
  const int per_row = ks * 8;  // 16-byte chunks of a row of A
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * per_row; e += THREADS) {
    const int r = e / per_row, c = e % per_row;
    const int gm = row0 + r, gk = c * 8;
    const XT* src = x + (int64_t)gm * K + gk;
    uint4 h;
    if (vec && gm < M && gk + 8 <= K) {
      if constexpr (sizeof(XT) == 2) {
        h = *reinterpret_cast<const uint4*>(src);
      } else {
        const float4 lo = reinterpret_cast<const float4*>(src)[0];
        const float4 hi = reinterpret_cast<const float4*>(src)[1];
        h = make_uint4(tc::pack_bf16x2(lo.x, lo.y), tc::pack_bf16x2(lo.z, lo.w),
                       tc::pack_bf16x2(hi.x, hi.y), tc::pack_bf16x2(hi.z, hi.w));
      }
    } else {
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = gm < M && gk + i < K ? load_f32(src + i) : 0.f;
      h = make_uint4(tc::pack_bf16x2(f[0], f[1]), tc::pack_bf16x2(f[2], f[3]),
                     tc::pack_bf16x2(f[4], f[5]), tc::pack_bf16x2(f[6], f[7]));
    }
    *reinterpret_cast<uint4*>(a + (c / 8) * ROWS * 128 + tc::swz(r, c % 8)) = h;
  }
}

// Copy stages of the generator's ring: A is resident, not in the ring, so
// a stage is free once its slab is dequantized.
constexpr int GEN_STAGES = tc::AHEAD + 1;

// Dynamic shared memory of a generator configuration: [B x2][packed x
// STAGES][scale, offset x STAGES][table][lut][an mbarrier per stage],
// padded to 1024, then ks resident A slabs of [rows, 64] bf16, + 1024 for
// aligning the base.
constexpr int gen_fixed_bytes(bool lut, int bits, int bn) {
  return (2 * bn * tc::BK * 2 + GEN_STAGES * tc::w_stage_bytes(bits, bn) +
          tc::BK * tc::table_entries(lut, bits) * 2 + (lut ? 4 << bits : 0) + 8 * GEN_STAGES +
          1023) / 1024 * 1024;
}
constexpr int gen_smem_bytes(int rows, bool lut, int bits, int bn, int ks) {
  return gen_fixed_bytes(lut, bits, bn) + ks * rows * tc::BK * 2 + 1024;
}

// Shapes and shared-memory layout of one generator configuration: WG
// warpgroups, each with MT row tiles of 64, BN (a multiple of 64) columns
// a vocab tile.
template <bool LUT, int BITS, int BN, int WG, int MT>
struct Gen : tc::WSide<LUT, BITS, BN, WG * tc::WG_THREADS> {
  using W = tc::WSide<LUT, BITS, BN, WG * tc::WG_THREADS>;
  static constexpr int ROWS = WG * MT * tc::BM;
  static constexpr int STAGES = GEN_STAGES;
  static constexpr int A_SLAB = ROWS * tc::BK * 2;
  static constexpr int B_OFF = 0;
  static constexpr int P_OFF = B_OFF + 2 * W::B_BYTES;
  static constexpr int SO_OFF = P_OFF + STAGES * W::P_BYTES;
  static constexpr int TABLE_OFF = SO_OFF + STAGES * W::SO_BYTES;
  static constexpr int LUT_OFF = TABLE_OFF + W::TABLE_BYTES;
  static constexpr int BAR_OFF = LUT_OFF + W::LUT_BYTES;
  static constexpr int A_OFF = gen_fixed_bytes(LUT, BITS, BN);
  static_assert(BN % 64 == 0, "vocab tiles are whole m64n64 sub-tiles");
  static_assert(BAR_OFF + 8 * STAGES <= A_OFF && A_OFF % 1024 == 0, "layout and size disagree");
  static_assert(W::THREADS * W::BN <= 2 * W::B_BYTES, "select_tile's scratch fits in the B tiles");
  static constexpr int smem(int ks) { return gen_smem_bytes(ROWS, LUT, BITS, BN, ks); }
};

template <typename XT, bool LUT, int BITS, int BN, int WG, int MT>
__global__ void __launch_bounds__(WG * tc::WG_THREADS)
    topk_tc_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ packed,
                   const float* __restrict__ scale, const float* __restrict__ offset,
                   const float* __restrict__ points, const float* __restrict__ bias, int M,
                   int K, int N, int64_t row_bytes, int tiles_per_split, int splits, int ktop,
                   bool tma, bool vec, const __grid_constant__ tc::Maps maps, Parts out) {
  using G = Gen<LUT, BITS, BN, WG, MT>;
  using W = typename G::W;
  extern __shared__ uint8_t dyn[];
  uint8_t* smem = dyn + ((1024 - (tc::smem_addr(dyn) & 1023)) & 1023);
  uint8_t* const b_tiles = smem + G::B_OFF;
  uint8_t* const a_tiles = smem + G::A_OFF;
  __nv_bfloat16* const table = reinterpret_cast<__nv_bfloat16*>(smem + G::TABLE_OFF);
  float* const lut = reinterpret_cast<float*>(smem + G::LUT_OFF);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + G::BAR_OFF);  // slab landed
  auto p_stage = [&](int st) { return smem + G::P_OFF + st * W::P_BYTES; };
  auto so_stage = [&](int st) { return reinterpret_cast<float*>(smem + G::SO_OFF + st * W::SO_BYTES); };
  const int tid = threadIdx.x;
  const int ks = (K + tc::BK - 1) / tc::BK;
  const int row0 = blockIdx.x * G::ROWS;
  const int t0 = blockIdx.y * tiles_per_split;
  const int nt = min((N + BN - 1) / BN - t0, tiles_per_split);
  const int total = nt * ks;  // slabs of the split's weight stream

  if constexpr (LUT) load_lut(points, BITS, lut);
#pragma unroll
  for (int i = 0; i < G::STAGES; ++i) tc::mbar_init(tid == 0, &full[i], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  // slab i of the stream: k slab i % ks of vocab tile t0 + i / ks
  auto load = [&](int i) {
    const int st = i % G::STAGES;
    tc::mbar_expect_tx(tma && tid == 0, &full[st], W::P_BYTES + W::SO_BYTES);
    tc::load_w_slab<W>(tma, &maps, packed, scale, offset, K, row_bytes, (t0 + i / ks) * BN,
                       (i % ks) * tc::BK, p_stage(st), so_stage(st), &full[st]);
  };
#pragma unroll
  for (int i = 0; i < tc::AHEAD; ++i) {
    if (i < total) load(i);
    tc::cp_async_commit();
  }
  load_x_resident<XT, G::ROWS, W::THREADS>(x, M, K, row0, ks, vec, a_tiles);

  const int wg = tid / tc::WG_THREADS;
  Rows<2 * MT> rows;
  float acc[MT * W::NSUB][32];
#pragma unroll
  for (int t = 0; t < MT * W::NSUB; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[t][i] = 0.f;
  int i = 0;
  for (int t = t0; t < t0 + nt; ++t) {
    const int col0 = t * BN;
    const tc::WTask<W> task(tid, col0, N);
    float b[W::NSUB][16];
    load_bias<W::NSUB>(bias, col0, N, b);
    for (int s = 0; s < ks; ++s, ++i) {
      const int st = i % G::STAGES;
      tc::cp_async_wait<tc::AHEAD - 1>();  // this thread's copies of slab i have landed
      if (tma) tc::mbar_wait(&full[st], (i / G::STAGES) & 1);  // or the TMA's
      __syncthreads();  // everyone's have; wgmma i - 2 and the transform of i - 1 are done
      if (i + tc::AHEAD < total) load(i + tc::AHEAD);
      tc::cp_async_commit();
      uint8_t* const bt = b_tiles + (i & 1) * W::B_BYTES;
      tc::transform_b<W>(task, p_stage(st), so_stage(st), lut, table, bt);
      tc::fence_proxy_async();  // B (and, at the first slab, A) before wgmma reads them
      __syncthreads();
      const uint64_t da = tc::desc_sw128(a_tiles + s * G::A_SLAB + wg * MT * tc::BM * 128);
      const uint64_t db = tc::desc_sw128(bt);
      tc::wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < tc::BK / 16; ++k16) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int sub = 0; sub < W::NSUB; ++sub)
            tc::wgmma_n64(acc[mt * W::NSUB + sub], da + 2 * k16 + mt * (tc::BM * 128 >> 4),
                          db + 2 * k16 + sub * (64 * 128 >> 4), s > 0 || k16 > 0);
        }
      }
      tc::wgmma_commit();
      tc::wgmma_wait<1>();
    }
    tc::wgmma_wait<0>();
#pragma unroll
    for (int u = 0; u < MT * W::NSUB; ++u)
#pragma unroll
      for (int e = 0; e < 32; ++e) tc::fence_operand(acc[u][e]);
    __syncthreads();  // every warpgroup's products are done: the B tiles are scratch until the next dequant
    select_tile<MT, W::NSUB>(acc, b, col0, ktop, reinterpret_cast<float*>(b_tiles), rows);
  }
  const int lane = tid % 32, warp = (tid % tc::WG_THREADS) / 32;
  write_split<MT>(rows, row0 + tc::BM * MT * wg + 16 * warp + lane / 4, M, blockIdx.y, splits,
                  out);
}

// x too large to stay resident: one warpgroup on 64 rows; each vocab tile
// streams x and the weights through tc::tile_mma_tc (threads copy, no TMA).
template <typename XT, bool LUT, int BITS>
__global__ void __launch_bounds__(tc::WG_THREADS)
    topk_tc_stream_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ packed,
                          const float* __restrict__ scale, const float* __restrict__ offset,
                          const float* __restrict__ points, const float* __restrict__ bias,
                          int M, int K, int N, int64_t row_bytes, int tiles_per_split,
                          int splits, int ktop, Parts out) {
  using T = tc::Tile<XT, LUT, BITS, 64, 1, 1>;
  static_assert(T::THREADS * 64 <= 2 * T::B_BYTES, "select_tile's scratch fits in the B tiles");
  extern __shared__ uint8_t dyn[];
  uint8_t* smem = dyn + ((1024 - (tc::smem_addr(dyn) & 1023)) & 1023);
  if constexpr (LUT) load_lut(points, BITS, reinterpret_cast<float*>(smem + T::LUT_OFF));
  const int row0 = blockIdx.x * tc::BM;
  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min((N + 63) / 64, t0 + tiles_per_split);
  Rows<2> rows;
  float acc[1][32];
  for (int t = t0; t < t1; ++t) {
    float b[1][16];
    load_bias<1>(bias, t * 64, N, b);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[0][e] = 0.f;
    tc::tile_mma_tc<XT, LUT, BITS, 64, 1, 1>(x, M, K, packed, scale, offset, row_bytes, N, row0,
                                             t * 64, false, nullptr, acc, smem);
    __syncthreads();  // every warp's products are done: the B tiles are scratch until the next dequant
    select_tile<1, 1>(acc, b, t * 64, ktop, reinterpret_cast<float*>(smem + T::B_OFF), rows);
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  write_split<1>(rows, row0 + 16 * warp + lane / 4, M, blockIdx.y, splits, out);
}

// ------------------------------------------------------------------ pass 2

// One warp per row: each lane folds a strided share of the row's splits
// into its own list and (max, sum), then 5 butterfly rounds merge the
// lanes' (disjoint) shares. Only a list's first k entries can reach the
// result, and a list is sorted, so a round inserts at most the partner's
// first k entries and stops at the first that does not enter: the first k
// of every list stay exact.
__global__ void __launch_bounds__(MERGE_THREADS)
    topk_merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                      const float* __restrict__ part_m, const float* __restrict__ part_s,
                      int M, int splits, int k, float* __restrict__ out_v,
                      int* __restrict__ out_i, float* __restrict__ out_lse) {
  const int row = blockIdx.x * (MERGE_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;  // the whole warp
  const int64_t base = (int64_t)row * splits;
  float tv[KMAX];
  int ti[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    tv[j] = -INFINITY;
    ti[j] = INT_MAX;
  }
  for (int e = lane; e < splits * KMAX; e += 32)
    insert(tv, ti, part_v[base * KMAX + e], part_i[base * KMAX + e]);
  float m = -INFINITY, s = 0.f;
  for (int e = lane; e < splits; e += 32) lse_merge(m, s, part_m[base + e], part_s[base + e]);
#pragma unroll
  for (int off = 16; off >= 1; off /= 2) {
    float ov[KMAX];
    int oi[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      ov[j] = __shfl_xor_sync(0xffffffffu, tv[j], off);
      oi[j] = __shfl_xor_sync(0xffffffffu, ti[j], off);
    }
    const float om = __shfl_xor_sync(0xffffffffu, m, off);
    const float os = __shfl_xor_sync(0xffffffffu, s, off);
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j >= k || !better(ov[j], oi[j], tv[KMAX - 1], ti[KMAX - 1])) break;
      insert(tv, ti, ov[j], oi[j]);
    }
    lse_merge(m, s, om, os);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        out_v[(int64_t)row * k + j] = tv[j];
        out_i[(int64_t)row * k + j] = ti[j];
      }
    }
    out_lse[row] = m + logf(s);
  }
}

// ---------------------------------------------------------------- host side

// What a call needs, from the C entry points.
struct Args {
  const void *x, *packed, *scale, *offset, *points, *bias;
  int M, K, N;
  int64_t row_bytes;
  int tiles_per_split, splits, k;
  Parts out;
  cudaStream_t stream;
};

// plan[] of qdt_topk_fused_plan
enum { P_ROWS, P_BN, P_STAGES, P_TPS, P_SPLITS, P_BLOCKS, P_SMEM, P_PER_SM, P_RESIDENT, P_N };

// Splits a vocab of ntiles tiles into about `wanted` splits of whole tiles,
// none of them empty.
static void split_vocab(int ntiles, int row_tiles, int wanted, int* plan) {
  const int s = max(1, min(ntiles, wanted));
  const int tps = (ntiles + s - 1) / s;
  plan[P_TPS] = tps;
  plan[P_SPLITS] = (ntiles + tps - 1) / tps;
  plan[P_BLOCKS] = row_tiles * plan[P_SPLITS];
}

// Tensor-core configurations (warpgroups, row tiles of 64 each, columns a
// vocab tile), measured at the serving shape on an H100 (PERF.md): two
// warpgroups on 128 rows with 128-column vocab tiles won; 256 rows (two
// row tiles a warpgroup) spill at 255 registers.
struct GenShape {
  int wg, mt, bn;
};
constexpr GenShape GEN_SHAPES[] = {{2, 1, 128}, {1, 1, 64}};
constexpr int NGEN = sizeof(GEN_SHAPES) / sizeof(GEN_SHAPES[0]);

// The first configuration whose resident x fits in shared memory and whose
// rows do not exceed M rounded up to 64 (else the smallest that fits); -1
// when none fits (the streamed-x instance).
static int pick_gen(int M, int K, bool lut, int bits) {
  const int ks = (K + tc::BK - 1) / tc::BK;
  const int mr = (M + tc::BM - 1) / tc::BM * tc::BM;
  int pick = -1, rows_min = INT_MAX;
  for (int i = 0; i < NGEN; ++i) {
    const GenShape& sh = GEN_SHAPES[i];
    const int rows = sh.wg * sh.mt * tc::BM;
    if (gen_smem_bytes(rows, lut, bits, sh.bn, ks) > tc::SMEM_MAX) continue;
    if (rows <= mr) return i;
    if (rows < rows_min) pick = i, rows_min = rows;
  }
  return pick;
}

// Raises a kernel's dynamic shared memory limit to 227 KB (once per device:
// see tc::once_per_device).
template <class Kern>
static cudaError_t allow_smem(Kern kern) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       tc::SMEM_MAX);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
}

// Fills a tensor-core plan: one wave of blocks over the SMs.
template <class Kern>
static cudaError_t tc_plan(Kern kern, int threads, int smem, int rows, int bn, int stages,
                           bool resident, const Args& a, int* plan) {
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  const int row_tiles = (a.M + rows - 1) / rows;
  plan[P_ROWS] = rows, plan[P_BN] = bn, plan[P_STAGES] = stages;
  plan[P_SMEM] = smem, plan[P_PER_SM] = per_sm, plan[P_RESIDENT] = resident;
  split_vocab((a.N + bn - 1) / bn, row_tiles, tc::sm_count() * max(per_sm, 1) / row_tiles, plan);
  return e;
}

// Launches one resident-x instance, or (plan != null) only describes it.
template <typename XT, bool LUT, int BITS, int BN, int WG, int MT>
static cudaError_t run_gen(const Args& a, int* plan) {
  using G = Gen<LUT, BITS, BN, WG, MT>;
  auto kern = topk_tc_kernel<XT, LUT, BITS, BN, WG, MT>;
  static std::atomic<int> attr_state[tc::MAX_DEVICES];  // per device, as attributes are
  const cudaError_t attr = tc::once_per_device(attr_state, [&] { return allow_smem(kern); });
  if (attr != cudaSuccess) return attr;
  const int smem = G::smem((a.K + tc::BK - 1) / tc::BK);
  if (plan) return tc_plan(kern, G::THREADS, smem, G::ROWS, BN, G::STAGES, true, a, plan);
  // TMA needs 16-byte aligned bases (the wrapper checks them) and row
  // strides: K * 4 bytes for scale and offset
  const bool tma = a.K % 4 == 0;
  const bool vec = reinterpret_cast<uintptr_t>(a.x) % 16 == 0 && a.K * sizeof(XT) % 16 == 0;
  tc::Maps maps{};
  if (tma) {
    const cudaError_t e =
        tc::weight_maps(&maps, a.packed, a.scale, a.offset, a.K, a.row_bytes, BITS, G::PB);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((a.M + G::ROWS - 1) / G::ROWS, a.splits);
  kern<<<grid, G::THREADS, smem, a.stream>>>(
      static_cast<const XT*>(a.x), static_cast<const uint8_t*>(a.packed),
      static_cast<const float*>(a.scale), static_cast<const float*>(a.offset),
      static_cast<const float*>(a.points), static_cast<const float*>(a.bias), a.M, a.K, a.N,
      a.row_bytes, a.tiles_per_split, a.splits, a.k, tma, vec, maps, a.out);
  return cudaGetLastError();
}

// The streamed-x instance (K too large for x to stay resident).
template <typename XT, bool LUT, int BITS>
static cudaError_t run_stream(const Args& a, int* plan) {
  using T = tc::Tile<XT, LUT, BITS, 64, 1, 1>;
  auto kern = topk_tc_stream_kernel<XT, LUT, BITS>;
  static std::atomic<int> attr_state[tc::MAX_DEVICES];  // per device, as attributes are
  const cudaError_t attr = tc::once_per_device(attr_state, [&] { return allow_smem(kern); });
  if (attr != cudaSuccess) return attr;
  if (plan) return tc_plan(kern, T::THREADS, T::SMEM, T::ROWS, 64, T::STAGES, false, a, plan);
  dim3 grid((a.M + T::ROWS - 1) / T::ROWS, a.splits);
  kern<<<grid, T::THREADS, T::SMEM, a.stream>>>(
      static_cast<const XT*>(a.x), static_cast<const uint8_t*>(a.packed),
      static_cast<const float*>(a.scale), static_cast<const float*>(a.offset),
      static_cast<const float*>(a.points), static_cast<const float*>(a.bias), a.M, a.K, a.N,
      a.row_bytes, a.tiles_per_split, a.splits, a.k, a.out);
  return cudaGetLastError();
}

template <typename XT, bool LUT, int BITS, int I = 0>
static cudaError_t run_gen_shape(int which, const Args& a, int* plan) {
  if constexpr (I < NGEN) {
    constexpr GenShape sh = GEN_SHAPES[I];
    if (which == I) return run_gen<XT, LUT, BITS, sh.bn, sh.wg, sh.mt>(a, plan);
    return run_gen_shape<XT, LUT, BITS, I + 1>(which, a, plan);
  } else {
    return run_stream<XT, LUT, BITS>(a, plan);  // which == -1
  }
}

template <typename XT>
static cudaError_t run_tc(int bits, const Args& a, int* plan) {
  const bool lut = a.points != nullptr;
  const int w = pick_gen(a.M, a.K, lut, bits);
  switch (bits * 2 + lut) {
    case 4: return run_gen_shape<XT, false, 2>(w, a, plan);
    case 5: return run_gen_shape<XT, true, 2>(w, a, plan);
    case 8: return run_gen_shape<XT, false, 4>(w, a, plan);
    case 9: return run_gen_shape<XT, true, 4>(w, a, plan);
    case 16: return run_gen_shape<XT, false, 8>(w, a, plan);
    case 17: return run_gen_shape<XT, true, 8>(w, a, plan);
    default: return cudaErrorInvalidValue;
  }
}

// f32 compute: the CUDA-core pass 1, its LUT instance when points are given.
template <typename XT>
static cudaError_t run_f32(int bits, const Args& a) {
  dim3 grid((a.M + BM - 1) / BM, a.splits);
  auto kern = a.points ? topk_partial_kernel<XT, true> : topk_partial_kernel<XT, false>;
  kern<<<grid, THREADS, 0, a.stream>>>(
      static_cast<const XT*>(a.x), static_cast<const uint8_t*>(a.packed),
      static_cast<const float*>(a.scale), static_cast<const float*>(a.offset),
      static_cast<const float*>(a.points), static_cast<const float*>(a.bias), a.M, a.K, a.N,
      bits, a.row_bytes, a.tiles_per_split, a.splits, a.out);
  return cudaGetLastError();
}

// The CUDA-core pass 1's split: enough (64-row tile) x split blocks to fill
// the card a few times over (4 x 132).
static void f32_plan(const Args& a, int* plan) {
  const int row_tiles = (a.M + BM - 1) / BM;
  constexpr int target = 4 * 132;
  plan[P_ROWS] = BM, plan[P_BN] = BN, plan[P_STAGES] = 1;
  plan[P_SMEM] = 0, plan[P_PER_SM] = 0, plan[P_RESIDENT] = 0;
  split_vocab((a.N + BN - 1) / BN, row_tiles, (target + row_tiles - 1) / row_tiles, plan);
}

}  // namespace qdt

// x: [M, K] f32 or bf16 (x_bf16); compute_bf16 selects the compute type (1:
// tensor cores, 0: f32 on CUDA cores); packed/scale/offset/points as in
// qdt_dequant_matmul (packed, scale and offset 16-byte aligned at bf16);
// bias: f32 [N] (required); scratch part_v/part_i [M, splits, 8] and
// part_m/part_s [M, splits]; outputs out_v f32 [M, k], out_i int32 [M, k],
// out_lse f32 [M]. Vocab tile t (plan's BN columns) belongs to split
// t / tiles_per_split; qdt_topk_fused_plan gives both. Returns the CUDA
// error of the launches, 0 on success.
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
  const Parts parts{static_cast<float*>(part_v), static_cast<int*>(part_i),
                    static_cast<float*>(part_m), static_cast<float*>(part_s)};
  const Args a{x, packed, scale, offset, points, bias, M, K, N, (int64_t)npad * bits / 8,
               tiles_per_split, splits, k, parts, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (compute_bf16)
    err = x_bf16 ? run_tc<__nv_bfloat16>(bits, a, nullptr) : run_tc<float>(bits, a, nullptr);
  else
    err = x_bf16 ? run_f32<__nv_bfloat16>(bits, a) : run_f32<float>(bits, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int rows_per_block = MERGE_THREADS / 32;
  topk_merge_kernel<<<(M + rows_per_block - 1) / rows_per_block, MERGE_THREADS, 0, a.stream>>>(
      parts.v, parts.i, parts.m, parts.s, M, splits, k, static_cast<float*>(out_v),
      static_cast<int*>(out_i), static_cast<float*>(out_lse));
  return static_cast<int>(cudaGetLastError());
}

// The plan qdt_topk_fused uses for these arguments: plan[0..8] = rows per
// block, columns per vocab tile, copy stages, tiles per split, splits,
// blocks, dynamic shared memory bytes (0: static only), resident blocks
// per SM (0: not computed), x resident in shared memory (1) or streamed.
// Returns the CUDA error of the occupancy query.
extern "C" int qdt_topk_fused_plan(int M, int K, int N, int x_bf16, int compute_bf16, int lut,
                                   int bits, int* plan) {
  using namespace qdt;
  Args a{};
  a.M = M, a.K = K, a.N = N;
  a.points = lut ? plan : nullptr;  // only tested for null
  if (!compute_bf16) {
    f32_plan(a, plan);
    return 0;
  }
  const cudaError_t err = x_bf16 ? run_tc<__nv_bfloat16>(bits, a, plan) : run_tc<float>(bits, a, plan);
  return static_cast<int>(err);
}
