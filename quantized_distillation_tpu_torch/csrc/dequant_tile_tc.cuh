// Tensor-core tile loop of the packed-weight kernels (Hopper, sm_90a): one
// (64 * MT * WG) x BN output tile of x[M, K] @ dequant(W)[K, N] with bf16
// operands on wgmma and f32 accumulators in registers. The packed layout
// and the rounding are dequant_tile.cuh's; tile_mma there stays the f32
// loop.
//
// WG warpgroups (128 threads each) run a block; warpgroup g multiplies MT
// row tiles of 64 (rows 64 MT g ..) by the whole B tile, so the weights a
// block dequantizes serve 64 * MT * WG rows. For each 64-deep K slab:
//  1. copy, asynchronously, into a ring of STAGES slabs, AHEAD (2) of them
//     in flight beyond the one in use: the x slab [64 * MT * WG rows, 64 k],
//     the packed bytes the tile's columns need [64 k, PB bytes], and the
//     slab's scale and offset (s[j, k0:k0+64], o[j, k0:k0+64]: a tile lies
//     inside one 256-column bucket j, so one pair serves a whole k row of
//     it). One thread asks the TMA for all four boxes, which complete on the
//     stage's mbarrier; where x's row stride rules the TMA out, all threads
//     copy instead (cp.async, or plain loads for bf16 x). Rows >= M and
//     k >= K read as 0. bf16 x lands directly in the swizzled layout wgmma
//     reads; f32 x lands row major and is rounded to bf16
//     (__float2bfloat16_rn, as the plain version's x.to(bf16)) into a
//     separate A tile.
//  2. dequantize, shared to shared, all threads (transform_b): each weight
//     bf16(__fadd_rn(__fmul_rn(v, s[k]), o[k])), v the level (made a float
//     exactly with the 2^23 trick: no int-to-float conversion) or
//     lut[level]. With a 2- or 4-bit codebook a slab has only 64 x 2^bits
//     distinct weights: each warp computes the table rows of its own k
//     chunks and looks each weight up. Columns >= N read as 0, as in
//     tile_mma. A thread takes CPT adjacent columns (one 8- to 32-bit load
//     per k row) and stores them rotated by its lane, so that the 16-byte
//     stores of a quarter warp fall in distinct banks. Tiles are K-major in
//     the 128-byte swizzled layout wgmma reads (16-byte chunk c of row r
//     stored at chunk c ^ (r % 8)); then fence.proxy.async and a barrier,
//     because wgmma reads through the async proxy and would not see the
//     plain stores (nor cp.async's) otherwise.
//  3. multiply: 4 wgmma.m64nNk16 per 64 columns (N = 64, or 32 for
//     BN = 32), issued asynchronously. B tiles are double-buffered, so slab
//     s + 1 is dequantized while slab s's products run; wgmma.wait_group 1
//     before the next slab keeps the buffers being overwritten free.
//
// The weight side (WSide: the slab copy load_w_slab, the per-tile thread
// task WTask and transform_b) is shared with the fused generator
// (topk_fused.cu), which keeps x resident in shared memory and streams only
// weights through the same ring.
//
// The products of two bf16 values are exact in f32; only the order of the
// f32 sum differs from the plain version.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include <atomic>

#include "dequant_tile.cuh"

namespace qdt {
namespace tc {

constexpr int BM = 64;     // rows of one warpgroup: one wgmma M
constexpr int BK = 64;     // K slab: one 128-byte swizzle row of bf16
constexpr int WG_THREADS = 128;
constexpr int AHEAD = 2;   // slabs copied ahead of the one in use (3 gained nothing)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16- and 4-byte asynchronous copies; `valid` bytes are read and the rest of
// the destination is zero-filled (valid = 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarrier and TMA (cp.async.bulk.tensor) for the x slab.
__device__ __forceinline__ void mbar_init(bool pred, uint64_t* bar, int count) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.init.shared::cta.b64 [%0], %1;\n}\n" ::"r"(smem_addr(bar)), "r"(count),
      "r"((int)pred) : "memory");
}
// The single-thread operations below are predicated inside the asm rather
// than branched around, which keeps the code around wgmma uniform.
__device__ __forceinline__ void mbar_expect_tx(bool pred, uint64_t* bar, int bytes) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(smem_addr(bar)),
      "r"(bytes), "r"((int)pred) : "memory");
}
// Waits for phase `parity` of `bar`. (No bounded spin with a trap: a trap
// in the function makes ptxas serialize every wgmma, warning C7518.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ void tma_load_2d(bool pred, void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
      "@p cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n}\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar)),
      "r"((int)pred) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads of an accumulator across a wait.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Byte offset of 16-byte chunk `c` of row `r` in a [rows, 64] bf16 tile
// stored with the 128-byte swizzle (the tile starts 1024-byte aligned).
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// wgmma descriptor of a K-major, 128-byte-swizzled tile: start address,
// leading offset 16 B (unused for this layout), stride 1024 B between
// 8-row groups, layout type 1 (128-byte swizzle). Adding 2 to it advances
// the start by 32 bytes: the next 16 k.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint64_t a = smem_addr(tile);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

#define QDT_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define QDT_F16(i) QDT_F4(i), QDT_F4(i + 4), QDT_F4(i + 8), QDT_F4(i + 12)

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], both operands K-major in shared
// memory; scale_d = 0 overwrites d instead of adding to it.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db,
                                          int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : QDT_F16(0), QDT_F16(16)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 32] (+)= A[64 x 16] B[16 x 32].
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db,
                                          int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : QDT_F16(0)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef QDT_F16
#undef QDT_F4

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The float value of an integer level 0 <= v < 2^23, exactly, without an
// int-to-float conversion: 2^23 + v as bits, minus 2^23.
__device__ __forceinline__ float level_to_float(uint32_t v) {
  return __fsub_rn(__uint_as_float(0x4B000000u | v), 8388608.f);
}

// TMA descriptors of a call's operands: x [M, K] with a [ROWS, 64] box
// (128-byte swizzle for bf16; unused by the generator), packed [K,
// row_bytes] with a [64, PB] box, scale and offset [Npad/256, K] with a
// [1, 64] box.
struct Maps {
  CUtensorMap x, packed, scale, offset;
};

// Packed bytes per k row that a BN-column tile needs: a bucket row holds
// 32 * bits bytes, each with the fields of columns 32 * bits apart.
constexpr int packed_row_bytes(int bits, int bn) { return bn < 32 * bits ? bn : 32 * bits; }
// Entries per k row of a codebook's weight table (2 and 4 bits; none at 8
// bits or on the uniform grid, whose weights are computed directly).
constexpr int table_entries(bool lut, int bits) { return lut && bits <= 4 ? 1 << bits : 0; }
// bf16 x is copied straight into the swizzled A layout and read there by
// wgmma; f32 x is rounded into a separate, double-buffered A tile.
constexpr bool a_in_ring(int x_size) { return x_size == 2; }
// Copy stages for AHEAD slabs in flight: a stage that wgmma reads (A in
// the ring) is free only once the wgmma of two slabs back has completed, so
// it needs one stage more.
constexpr int stages_for(int x_size) { return AHEAD + (a_in_ring(x_size) ? 2 : 1); }
// Shared memory a block may have on an H100 (227 KB).
constexpr int SMEM_MAX = 232448;
// Shared memory of the weight side of a ring stage: packed bytes, then 64
// scales and 64 offsets.
constexpr int w_stage_bytes(int bits, int bn) { return BK * packed_row_bytes(bits, bn) + 2 * BK * 4; }

// Dynamic shared memory of a tile configuration: [A x2 (f32 x only)][B x2]
// [x x STAGES][packed x STAGES][scale, offset x STAGES][table][lut: 2^bits
// points][an mbarrier per stage], + 1024 for aligning the base.
constexpr int smem_bytes(int rows, int x_size, bool lut, int bits, int bn, int stages) {
  return (a_in_ring(x_size) ? 0 : 2 * rows * BK * 2) + 2 * bn * BK * 2 +
         stages * (rows * BK * x_size + w_stage_bytes(bits, bn)) +
         BK * table_entries(lut, bits) * 2 + (lut ? 4 << bits : 0) + 8 * stages + 1024;
}

// The weight side of a tile configuration: BN columns (32, 64 or 128,
// dividing the 256-column bucket, so a tile never straddles one) of a
// 64-deep slab, dequantized by THREADS threads.
template <bool LUT, int BITS_, int BN_, int THREADS_>
struct WSide {
  static constexpr int BITS = BITS_;
  static constexpr int BN = BN_;
  static constexpr int THREADS = THREADS_;
  static constexpr int PLANE = 32 * BITS;  // bytes of a bucket row's plane
  static constexpr int PB = packed_row_bytes(BITS, BN);
  static constexpr int NSUB = BN >= 64 ? BN / 64 : 1;  // wgmma instructions per k16 and row tile
  static constexpr int NREG = BN >= 64 ? 32 : 16;      // accumulators per instruction
  static constexpr int L = table_entries(LUT, BITS);
  static constexpr bool IS_LUT = LUT;
  // B transform: CPT adjacent columns x one 8-deep k chunk per task, PASSES tasks a thread
  static constexpr int CPT = BN * 8 / THREADS >= 4 ? 4 : BN * 8 / THREADS;
  static constexpr int GROUPS = BN / CPT;  // column groups of a k chunk
  static constexpr int PASSES = BN * 8 / (THREADS * CPT);
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int P_BYTES = BK * PB;
  static constexpr int SO_BYTES = 2 * BK * 4;
  static constexpr int TABLE_BYTES = BK * L * 2;
  static constexpr int LUT_BYTES = LUT ? 4 << BITS : 0;
  static_assert(CPT >= 1 && PASSES >= 1 && GROUPS <= 32 && 32 % GROUPS == 0,
                "a k chunk's threads must lie in one warp");
};

// Shapes and shared-memory layout of one tile configuration of the
// dequant-matmul. Each of the WG warpgroups multiplies MT row tiles of 64.
template <typename XT, bool LUT, int BITS, int BN, int WG, int MT>
struct Tile : WSide<LUT, BITS, BN, WG * WG_THREADS> {
  using W = WSide<LUT, BITS, BN, WG * WG_THREADS>;
  static constexpr int ROWS = WG * MT * BM;
  static constexpr bool A_IN_RING = a_in_ring(sizeof(XT));
  static constexpr int STAGES = stages_for(sizeof(XT));
  static constexpr int A_BYTES = ROWS * BK * 2;
  static constexpr int X_BYTES = ROWS * BK * (int)sizeof(XT);
  static constexpr int B_OFF = A_IN_RING ? 0 : 2 * A_BYTES;
  static constexpr int X_OFF = B_OFF + 2 * W::B_BYTES;
  static constexpr int P_OFF = X_OFF + STAGES * X_BYTES;
  static constexpr int SO_OFF = P_OFF + STAGES * W::P_BYTES;
  static constexpr int TABLE_OFF = SO_OFF + STAGES * W::SO_BYTES;
  static constexpr int LUT_OFF = TABLE_OFF + W::TABLE_BYTES;
  static constexpr int BAR_OFF = LUT_OFF + W::LUT_BYTES;
  static constexpr int SMEM = smem_bytes(ROWS, sizeof(XT), LUT, BITS, BN, STAGES);
  static_assert(BAR_OFF + 8 * STAGES + 1024 == SMEM, "layout and size disagree");
};

// CPT adjacent bytes of a packed row as one word.
template <int CPT>
__device__ __forceinline__ uint32_t load_bytes(const uint8_t* p) {
  if constexpr (CPT == 4) return *reinterpret_cast<const uint32_t*>(p);
  else if constexpr (CPT == 2) return *reinterpret_cast<const uint16_t*>(p);
  else return *p;
}

// One thread's share of the B transform of the tile starting at column
// col0: CPT adjacent columns n0 .. n0 + CPT - 1 (adjacent bytes of a packed
// row, one field) in the k chunks q0 + p * (THREADS / GROUPS).
template <class W>
struct WTask {
  int q0, lb;
  int sh[W::CPT], row_of[W::CPT];
  uint32_t keep[W::CPT];
  __device__ __forceinline__ WTask(int tid, int col0, int N) {
    const int cb = col0 % BUCKET;  // tile's first column in its bucket
    const int n0 = (tid % W::GROUPS) * W::CPT;
    q0 = tid / W::GROUPS;
    const int c0 = cb + n0;  // first column in the bucket
    lb = c0 % W::PLANE - cb % W::PLANE;
    // slot b holds column n0 + (b + rot) % CPT: rotating by lane keeps the
    // 16-byte stores of a quarter warp on distinct banks
    const int rot = (tid / (8 / W::CPT)) % W::CPT;
#pragma unroll
    for (int b = 0; b < W::CPT; ++b) {
      const int cc = (b + rot) % W::CPT;
      sh[b] = 8 * cc + (c0 / W::PLANE) * W::BITS;
      row_of[b] = n0 + cc;
      keep[b] = col0 + n0 + cc < N ? 0xFFFFFFFFu : 0u;
    }
  }
};

// Copies the weights of the 64-deep slab at k0 of the tile starting at
// column col0 into a ring stage: ps [64, PB] packed bytes, so 64 scales then
// 64 offsets. With `tma`, one thread asks the TMA for the three boxes, which
// complete on `bar` (the caller has announced their bytes); else every
// thread copies with cp.async, zero-filling k >= K (the caller commits).
template <class W>
__device__ __forceinline__ void load_w_slab(bool tma, const Maps* maps,
                                            const uint8_t* __restrict__ packed,
                                            const float* __restrict__ scale,
                                            const float* __restrict__ offset, int K,
                                            int64_t row_bytes, int col0, int k0, uint8_t* ps,
                                            float* so, uint64_t* bar) {
  const int tid = threadIdx.x;
  const int j = col0 / BUCKET;  // the tile's bucket: its scale and offset row
  const int64_t pstart = (int64_t)j * W::PLANE + (col0 % BUCKET) % W::PLANE;  // first byte
  if (tma) {
    const bool lead = tid == 0;  // the thread that asks the TMA
    tma_load_2d(lead, ps, &maps->packed, (int)pstart, k0, bar);
    tma_load_2d(lead, so, &maps->scale, k0, j, bar);
    tma_load_2d(lead, so + BK, &maps->offset, k0, j, bar);
    return;
  }
  constexpr int PPR = W::PB / 16;
#pragma unroll
  for (int e = tid; e < BK * PPR; e += W::THREADS) {
    const int kk = e / PPR, q = e % PPR;
    const int gk = k0 + kk;
    const bool ok = gk < K;
    cp_async16(ps + kk * W::PB + q * 16,
               ok ? packed + (int64_t)gk * row_bytes + pstart + q * 16 : packed, ok ? 16 : 0);
  }
  for (int e = tid; e < 2 * BK; e += W::THREADS) {  // so[0:64] scale, so[64:128] offset
    const int gk = k0 + e % BK;
    const float* src = e < BK ? scale : offset;
    const bool ok = gk < K;
    cp_async4(so + e, ok ? src + (int64_t)j * K + gk : src, ok ? 4 : 0);
  }
}

// Dequantizes a landed stage (ps, so) into the swizzled bf16 B tile bt, as
// `task` divides it; with LUT, lut holds the 2^BITS points (load_lut) and
// table is scratch for 2/4-bit codebooks. Every thread of the block calls it.
template <class W>
__device__ __forceinline__ void transform_b(const WTask<W>& task, const uint8_t* ps,
                                            const float* so, const float* lut,
                                            __nv_bfloat16* table, uint8_t* bt) {
  constexpr int MASK = (1 << W::BITS) - 1;
  constexpr int THREADS = W::THREADS;
  const int tid = threadIdx.x;
  if constexpr (W::L > 0) {
    // Each k chunk belongs to one warp's threads, so a warp builds the
    // table rows of its own chunks and only a warp barrier is needed.
    constexpr int QW = 32 / W::GROUPS;  // chunks of a warp in one pass
    const int lane = tid % 32, qw0 = (tid - lane) / W::GROUPS;
#pragma unroll
    for (int p = 0; p < W::PASSES; ++p)
#pragma unroll
      for (int e = lane; e < QW * 8 * W::L; e += 32) {
        const int kk = (qw0 + e / (8 * W::L) + p * (THREADS / W::GROUPS)) * 8 +
                       e % (8 * W::L) / W::L;
        const int lv = e % W::L;
        table[kk * W::L + lv] =
            __float2bfloat16_rn(__fadd_rn(__fmul_rn(lut[lv], so[kk]), so[BK + kk]));
      }
    __syncwarp();
  }
  uint32_t words[W::PASSES][8];
#pragma unroll
  for (int p = 0; p < W::PASSES; ++p)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int q = task.q0 + p * (THREADS / W::GROUPS);
      words[p][kk] = load_bytes<W::CPT>(ps + (q * 8 + kk) * W::PB + task.lb);
    }
#pragma unroll
  for (int p = 0; p < W::PASSES; ++p) {
    const int q = task.q0 + p * (THREADS / W::GROUPS);
    uint32_t h[W::CPT][4];
    if constexpr (W::L > 0) {
      const uint16_t* tab = reinterpret_cast<const uint16_t*>(table) + q * 8 * W::L;
#pragma unroll
      for (int b = 0; b < W::CPT; ++b)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t lo = tab[(2 * i) * W::L + ((words[p][2 * i] >> task.sh[b]) & MASK)];
          const uint32_t hi =
              tab[(2 * i + 1) * W::L + ((words[p][2 * i + 1] >> task.sh[b]) & MASK)];
          h[b][i] = (lo | (hi << 16)) & task.keep[b];
        }
    } else {
      float s8[8], o8[8];
#pragma unroll
      for (int i = 0; i < 8; i += 4) {
        const float4 sv = *reinterpret_cast<const float4*>(so + q * 8 + i);
        const float4 ov = *reinterpret_cast<const float4*>(so + BK + q * 8 + i);
        s8[i] = sv.x, s8[i + 1] = sv.y, s8[i + 2] = sv.z, s8[i + 3] = sv.w;
        o8[i] = ov.x, o8[i + 1] = ov.y, o8[i + 2] = ov.z, o8[i + 3] = ov.w;
      }
#pragma unroll
      for (int b = 0; b < W::CPT; ++b)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float w[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const uint32_t level = (words[p][2 * i + u] >> task.sh[b]) & MASK;
            const float v = W::IS_LUT ? lut[level] : level_to_float(level);
            w[u] = __fadd_rn(__fmul_rn(v, s8[2 * i + u]), o8[2 * i + u]);
          }
          h[b][i] = pack_bf16x2(w[0], w[1]) & task.keep[b];
        }
    }
#pragma unroll
    for (int b = 0; b < W::CPT; ++b)
      *reinterpret_cast<uint4*>(bt + swz(task.row_of[b], q)) =
          make_uint4(h[b][0], h[b][1], h[b][2], h[b][3]);
  }
}

// acc[mt * NSUB + sub][i] += x[row0 + 64 * (MT * warpgroup + mt) + ., :]
// @ w[:, col0 + sub*64 + .] in wgmma's accumulator layout (thread t of its
// warpgroup: rows 16*(t/32) + (t%32)/4 and +8, columns 8*(i/4) + 2*(t%4)
// and +1). `smem`
// is 1024-byte aligned and holds Tile::SMEM - 1024 bytes; with LUT, its
// bytes from Tile::LUT_OFF hold the 2^BITS points (load_lut). `tma`: the
// operands' bases and row strides allow TMA and `maps` describes them; one
// thread then copies a whole slab. Else (x's row stride K is not a multiple
// of 16 bytes) the threads copy it: f32 x 4 bytes at a time, bf16 x element
// by element, the packed bytes 16 and scale and offset 4 at a time. Every
// thread of the block calls it.
template <typename XT, bool LUT, int BITS, int BN, int WG, int MT>
__device__ __forceinline__ void tile_mma_tc(
    const XT* __restrict__ x, int M, int K, const uint8_t* __restrict__ packed,
    const float* __restrict__ scale, const float* __restrict__ offset, int64_t row_bytes,
    int N, int row0, int col0, bool tma, const Maps* maps,
    float (&acc)[MT * Tile<XT, LUT, BITS, BN, WG, MT>::NSUB]
                [Tile<XT, LUT, BITS, BN, WG, MT>::NREG],
    uint8_t* smem) {
  using T = Tile<XT, LUT, BITS, BN, WG, MT>;
  using W = typename T::W;
  constexpr int THREADS = W::THREADS;
  constexpr int STAGES = T::STAGES;
  const int tid = threadIdx.x;
  uint8_t* const a_tiles = smem;
  uint8_t* const b_tiles = smem + T::B_OFF;
  __nv_bfloat16* const table = reinterpret_cast<__nv_bfloat16*>(smem + T::TABLE_OFF);
  const float* const lut = reinterpret_cast<const float*>(smem + T::LUT_OFF);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + T::BAR_OFF);  // slab landed
  auto x_stage = [&](int st) { return smem + T::X_OFF + st * T::X_BYTES; };
  auto p_stage = [&](int st) { return smem + T::P_OFF + st * W::P_BYTES; };
  auto so_stage = [&](int st) { return reinterpret_cast<float*>(smem + T::SO_OFF + st * W::SO_BYTES); };
  const WTask<W> task(tid, col0, N);

  // Copy slab s into stage st. x: bf16 into the swizzled A layout, f32 row
  // major.
  auto load_slab = [&](int s, int st) {
    uint8_t* xs = x_stage(st);
    const int k0 = s * BK;
    if (tma) {  // one thread asks the TMA for the whole slab
      const bool one = tid == 0;
      mbar_expect_tx(one, &full[st], T::X_BYTES + W::P_BYTES + W::SO_BYTES);
      tma_load_2d(one, xs, &maps->x, k0, row0, &full[st]);
    } else if constexpr (T::A_IN_RING) {
#pragma unroll
      for (int e = tid; e < T::ROWS * 8; e += THREADS) {
        const int r = e / 8, q = e % 8;
        const int gm = row0 + r, gk = k0 + q * 8;
        uint32_t h[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok0 = gm < M && gk + 2 * i < K, ok1 = gm < M && gk + 2 * i + 1 < K;
          const __nv_bfloat16 z = __float2bfloat16_rn(0.f);
          __nv_bfloat162 pair;
          pair.x = ok0 ? x[(int64_t)gm * K + gk + 2 * i] : z;
          pair.y = ok1 ? x[(int64_t)gm * K + gk + 2 * i + 1] : z;
          h[i] = *reinterpret_cast<const uint32_t*>(&pair);
        }
        *reinterpret_cast<uint4*>(xs + swz(r, q)) = make_uint4(h[0], h[1], h[2], h[3]);
      }
    } else {
      for (int e = tid; e < T::ROWS * BK; e += THREADS) {
        const int r = e / BK, kk = e % BK;
        const int gm = row0 + r, gk = k0 + kk;
        const bool ok = gm < M && gk < K;
        cp_async4(xs + e * 4, ok ? x + (int64_t)gm * K + gk : x, ok ? 4 : 0);
      }
    }
    load_w_slab<W>(tma, maps, packed, scale, offset, K, row_bytes, col0, k0, p_stage(st),
                   so_stage(st), &full[st]);
  };

  // f32 x rounded to bf16 into the A tile
  auto transform_a = [&](int st, int buf) {
    const float* xs = reinterpret_cast<const float*>(x_stage(st));
    uint8_t* at = a_tiles + buf * T::A_BYTES;
#pragma unroll
    for (int e = tid; e < T::ROWS * 8; e += THREADS) {
      const int r = e / 8, q = e % 8;
      const float4 lo = *reinterpret_cast<const float4*>(xs + r * BK + q * 8);
      const float4 hi = *reinterpret_cast<const float4*>(xs + r * BK + q * 8 + 4);
      *reinterpret_cast<uint4*>(at + swz(r, q)) =
          make_uint4(pack_bf16x2(lo.x, lo.y), pack_bf16x2(lo.z, lo.w),
                     pack_bf16x2(hi.x, hi.y), pack_bf16x2(hi.z, hi.w));
    }
  };

  const int wg = tid / WG_THREADS;
  const int S = (K + BK - 1) / BK;
#pragma unroll
  for (int i = 0; i < STAGES; ++i) mbar_init(tid == 0, &full[i], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < S) load_slab(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < S; ++s) {
    const int st = s % STAGES;
    cp_async_wait<AHEAD - 1>();  // this thread's copies of slab s have landed
    if (tma) mbar_wait(&full[st], (s / STAGES) & 1);  // or the TMA's
    __syncthreads();  // everyone's have; wgmma s - 2 and the transforms of s - 1 are done
    if (s + AHEAD < S) load_slab(s + AHEAD, (s + AHEAD) % STAGES);
    cp_async_commit();
    if constexpr (!T::A_IN_RING) transform_a(st, s & 1);
    transform_b<W>(task, p_stage(st), so_stage(st), lut, table, b_tiles + (s & 1) * W::B_BYTES);
    fence_proxy_async();  // the generic-proxy writes of this slab, before wgmma reads them
    __syncthreads();
    const uint8_t* a = T::A_IN_RING ? x_stage(st) : a_tiles + (s & 1) * T::A_BYTES;
    const uint64_t da = desc_sw128(a + wg * MT * BM * 128);
    const uint64_t db = desc_sw128(b_tiles + (s & 1) * W::B_BYTES);
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < BK / 16; ++k16) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int sub = 0; sub < W::NSUB; ++sub) {
          const uint64_t dam = da + 2 * k16 + mt * (BM * 128 >> 4);
          if constexpr (BN == 32)
            wgmma_n32(acc[mt * W::NSUB + sub], dam, db + 2 * k16);
          else
            wgmma_n64(acc[mt * W::NSUB + sub], dam, db + 2 * k16 + sub * (64 * 128 >> 4));
        }
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < MT * W::NSUB; ++t)
#pragma unroll
    for (int i = 0; i < W::NREG; ++i) fence_operand(acc[t][i]);
}

// ------------------------------------------------------------ host side

// cuTensorMapEncodeTiled, looked up through the runtime (no link to libcuda).
static inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// A 2D TMA descriptor: `dims` and `box` innermost first, `stride` the
// bytes between rows. Elements outside the tensor read as 0.
static inline cudaError_t tensor_map(CUtensorMap* map, CUtensorMapDataType type,
                                     const void* base, cuuint64_t inner, cuuint64_t rows,
                                     cuuint64_t stride, cuuint32_t box_inner,
                                     cuuint32_t box_rows, CUtensorMapSwizzle swizzle) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, rows};
  const cuuint64_t strides[1] = {stride};
  const cuuint32_t box[2] = {box_inner, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The weight maps (packed, scale, offset) of a call whose tiles need PB
// packed bytes per k row; the caller has checked that the bases are 16-byte
// aligned and K a multiple of 4 (the scale rows' stride).
static inline cudaError_t weight_maps(Maps* maps, const void* packed, const void* scale,
                                      const void* offset, int K, int64_t row_bytes, int bits,
                                      int pb) {
  const cuuint64_t nb = row_bytes / (32 * bits);  // buckets: scale/offset rows
  cudaError_t e = tensor_map(&maps->packed, CU_TENSOR_MAP_DATA_TYPE_UINT8, packed, row_bytes, K,
                             row_bytes, pb, BK, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e == cudaSuccess)
    e = tensor_map(&maps->scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scale, K, nb,
                   (cuuint64_t)K * 4, BK, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e == cudaSuccess)
    e = tensor_map(&maps->offset, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, offset, K, nb,
                   (cuuint64_t)K * 4, BK, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
  return e;
}

// Per-device state. A kernel's function attributes and the SM count belong
// to a device, and one process may drive any card (a rank that owns cuda:1),
// so each is kept per device: the current one at the call.
constexpr int MAX_DEVICES = 64;

// Runs set() once per device and keeps its cudaError_t; `state` is one
// static array per kernel instance (0: not run yet, else the error + 1).
template <class F>
static inline cudaError_t once_per_device(std::atomic<int>* state, F set) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return set();
  int s = state[dev].load(std::memory_order_acquire);
  if (s == 0) {
    s = static_cast<int>(set()) + 1;
    state[dev].store(s, std::memory_order_release);
  }
  return static_cast<cudaError_t>(s - 1);
}

// The current device's SM count, read once per device.
static inline int sm_count() {
  static std::atomic<int> counts[MAX_DEVICES];
  int dev = 0;
  cudaGetDevice(&dev);
  const auto read = [dev] {
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 132;
  };
  if (dev < 0 || dev >= MAX_DEVICES) return read();
  int n = counts[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    n = read();
    counts[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

}  // namespace tc
}  // namespace qdt
