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
// gather. Here the LUT variant loads the points into shared memory once per
// block and looks each level up there, which adds no pass over the weights.
//
// What bounds it on an H100: at the decode step's shapes (M = 1280 rows;
// lstm_0 [768, 1024], lstm_1 [512, 1024], attn_out [512, 256]) the work is
// 0.34-2.0 GFLOP against 4.0-7.6 MB of traffic, mostly the f32 output:
// 264, 196 and 84 operations per byte, all below the ~295 at which bf16
// tensor cores, not device memory, would be the limit. So bytes bound it
// (1.2-2.3 us each). What it takes beyond that is on the SM: every weight
// must be unpacked and dequantized before a tensor core can use it, and
// shared memory carries the copies, the dequantized tile and wgmma's reads.
//
// bf16 compute (the serving path) runs on the tensor cores through the
// tile loop tc::tile_mma_tc (dequant_tile_tc.cuh): one thread asks the TMA
// for each 64-deep slab (x in the swizzled layout wgmma reads, the packed
// bytes, the slab's scale and offset), two slabs ahead of the one in use;
// all threads dequantize the slab's weights once per block into a swizzled
// bf16 tile (shifts and masks, bits a template parameter; a codebook's
// 2^bits values per k row come from a small table), and wgmma.m64nNk16
// multiplies it while the next slab is dequantized. A block is two
// warpgroups of two 64-row tiles each sharing one 64-column B tile (the
// lstm matrices: 80 blocks of 256 x 64), or one warpgroup on 64 rows where
// larger tiles would leave most SMs idle (attn_out: 80 blocks of 64 x 64;
// see pick_shape). The dequantized weight never exists in device memory.
//
// f32 compute stays on the CUDA cores (dequant_matmul_kernel over
// tile_mma): the tensor cores have no exact f32 mode, and TF32 would round
// the operands to 10-bit mantissas and break the f32 contract the f32 token
// parity checks rest on.
//
// Rounding: the plain PyTorch version dequant_matmul_reference (see
// dequant_tile.cuh). Any K (the last slab is zero-filled), any M, any N.
// x may have any alignment: where its base or row stride (K) rules out the
// TMA, the threads copy the slab themselves (f32 x 4 bytes at a time, bf16
// x element by element), in the same kernel. The packed bytes, scale and
// offset must be 16-byte aligned; the wrapper checks that and raises.

#include "dequant_tile.cuh"
#include "dequant_tile_tc.cuh"

namespace qdt {

template <typename XT, bool LUT>
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
  tile_mma<XT, LUT>(x, M, K, packed, scale, offset, lut, bits, row_bytes, N, row0,
                    col0, acc, As, Bs);
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

template <typename XT, bool LUT, int BITS, int TBN, int WG, int MT>
__global__ void __launch_bounds__(WG * tc::WG_THREADS)
    dequant_matmul_tc_kernel(const XT* __restrict__ x,
                             const uint8_t* __restrict__ packed,
                             const float* __restrict__ scale,
                             const float* __restrict__ offset,
                             const float* __restrict__ points,
                             const float* __restrict__ bias,
                             float* __restrict__ out, int M, int K, int N,
                             int64_t row_bytes, bool tma,
                             const __grid_constant__ tc::Maps maps) {
  using T = tc::Tile<XT, LUT, BITS, TBN, WG, MT>;
  extern __shared__ uint8_t dyn[];
  uint8_t* smem = dyn + ((1024 - (tc::smem_addr(dyn) & 1023)) & 1023);
  if constexpr (LUT) load_lut(points, BITS, reinterpret_cast<float*>(smem + T::LUT_OFF));
  const int row0 = blockIdx.y * T::ROWS;
  const int col0 = blockIdx.x * TBN;
  float acc[MT * T::NSUB][T::NREG];
#pragma unroll
  for (int t = 0; t < MT * T::NSUB; ++t)
#pragma unroll
    for (int i = 0; i < T::NREG; ++i) acc[t][i] = 0.f;
  tc::tile_mma_tc<XT, LUT, BITS, TBN, WG, MT>(x, M, K, packed, scale, offset, row_bytes, N, row0,
                                          col0, tma, &maps, acc, smem);
  // accumulator i of row tile mt of a thread: row 64*(MT*warpgroup + mt) +
  // 16*warp + lane/4 (+8 for i%4 >= 2), column 8*(i/4) + 2*(lane%4) (+1 for
  // odd i)
  const int wg = threadIdx.x / tc::WG_THREADS;
  const int warp = (threadIdx.x % tc::WG_THREADS) / 32, lane = threadIdx.x % 32;
  const bool pairs = (N % 2) == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = row0 + tc::BM * (MT * wg + mt) + 16 * warp + lane / 4;
#pragma unroll
    for (int sub = 0; sub < T::NSUB; ++sub) {
#pragma unroll
      for (int i = 0; i < T::NREG; i += 4) {
        const int n = col0 + sub * 64 + (i / 4) * 8 + 2 * (lane % 4);
        const float b0 = bias && n < N ? bias[n] : 0.f;
        const float b1 = bias && n + 1 < N ? bias[n + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = r0 + 8 * h;
          if (m >= M || n >= N) continue;
          float v0 = acc[mt * T::NSUB + sub][i + 2 * h], v1 = acc[mt * T::NSUB + sub][i + 2 * h + 1];
          if (bias) {
            v0 += b0;
            v1 += b1;
          }
          float* o = out + (int64_t)m * N + n;
          if (pairs) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            o[0] = v0;
            if (n + 1 < N) o[1] = v1;
          }
        }
      }
    }
  }
}

// Tile shape of the tensor-core kernel: the first of SHAPES that fits in
// shared memory and launches at least half a block per SM. Measured at the decode shapes on an H100
// (PERF.md): two warpgroups of two 64-row tiles each (256 rows) sharing one
// dequantized 64-column B tile won for the lstm matrices (80 blocks): each
// weight is unpacked once per 256 rows. For attn_out (N = 256), 80 blocks of
// 64 x 64 beat 160 of 64 x 32 (half the x traffic, fewer unpacks) and
// larger tiles (too few blocks). 128-column tiles lost at every shape.
struct Shape {
  int wg, mt, bn;  // warpgroups, row tiles of 64 each, columns
};
constexpr Shape SHAPES[] = {{2, 2, 64}, {1, 1, 64}, {1, 1, 32}};
constexpr int NSHAPES = sizeof(SHAPES) / sizeof(SHAPES[0]);

static int pick_shape(int M, int N, int x_size, bool lut, int bits) {
  int last = -1;
  for (int i = 0; i < NSHAPES; ++i) {
    const Shape& sh = SHAPES[i];
    const int rows = sh.wg * sh.mt * tc::BM;
    if (tc::smem_bytes(rows, x_size, lut, bits, sh.bn, tc::stages_for(x_size)) > tc::SMEM_MAX)
      continue;  // f32 x at 256 rows
    const int64_t blocks = (int64_t)((M + rows - 1) / rows) * ((N + sh.bn - 1) / sh.bn);
    if (2 * blocks >= tc::sm_count()) return i;
    last = i;
  }
  return last;
}

// Launch one tensor-core instance, or (plan != null) only describe it:
// plan[0..5] = rows and columns per tile, copy stages, blocks, dynamic
// shared memory bytes, resident blocks per SM.
template <typename XT, bool LUT, int BITS, int TBN, int WG, int MT>
static cudaError_t run_tc(const void* x, const void* packed, const void* scale,
                          const void* offset, const void* points, const void* bias, void* out,
                          int M, int K, int N, int64_t row_bytes, cudaStream_t stream,
                          int* plan) {
  using T = tc::Tile<XT, LUT, BITS, TBN, WG, MT>;
  auto kern = dequant_matmul_tc_kernel<XT, LUT, BITS, TBN, WG, MT>;
  static std::atomic<int> attr_state[tc::MAX_DEVICES];  // per device, as attributes are
  const cudaError_t attr = tc::once_per_device(attr_state, [&] {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::SMEM);
    if (e == cudaSuccess)  // as much shared memory as the SM has, for 2 blocks an SM
      e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  });
  if (attr != cudaSuccess) return attr;
  dim3 grid((N + TBN - 1) / TBN, (M + T::ROWS - 1) / T::ROWS);
  if (plan) {
    int per_sm = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, T::THREADS, T::SMEM);
    plan[0] = T::ROWS, plan[1] = TBN, plan[2] = T::STAGES;
    plan[3] = grid.x * grid.y, plan[4] = T::SMEM, plan[5] = per_sm;
    return e;
  }
  // TMA needs 16-byte aligned bases (the wrapper checks the packed
  // tensors') and row strides: K * sizeof(x) and K * 4 for scale/offset
  const bool tma = reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % (16 / sizeof(XT)) == 0;
  tc::Maps maps{};
  if (tma) {
    const bool bf16 = sizeof(XT) == 2;
    cudaError_t e = tc::tensor_map(
        &maps.x, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, K,
        M, (cuuint64_t)K * sizeof(XT), tc::BK, T::ROWS,
        bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e == cudaSuccess) e = tc::weight_maps(&maps, packed, scale, offset, K, row_bytes, BITS, T::PB);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale), static_cast<const float*>(offset),
      static_cast<const float*>(points), static_cast<const float*>(bias),
      static_cast<float*>(out), M, K, N, row_bytes, tma, maps);
  return cudaGetLastError();
}

#define QDT_TC_ARGS x, packed, scale, offset, points, bias, out, M, K, N, row_bytes, s, plan

template <typename XT, bool LUT, int BITS, int I = 0>
static cudaError_t run_tc_shape(int which, const void* x, const void* packed, const void* scale,
                                const void* offset, const void* points, const void* bias,
                                void* out, int M, int K, int N, int64_t row_bytes,
                                cudaStream_t s, int* plan) {
  if constexpr (I < NSHAPES) {
    constexpr Shape sh = SHAPES[I];
    // a shape that does not fit (pick_shape never picks it) is not compiled
    if constexpr (tc::Tile<XT, LUT, BITS, sh.bn, sh.wg, sh.mt>::SMEM <= tc::SMEM_MAX)
      if (which == I) return run_tc<XT, LUT, BITS, sh.bn, sh.wg, sh.mt>(QDT_TC_ARGS);
    return run_tc_shape<XT, LUT, BITS, I + 1>(which, QDT_TC_ARGS);
  } else {
    return cudaErrorInvalidValue;
  }
}

template <typename XT>
static cudaError_t run_tc_variant(int bits, const void* x, const void* packed, const void* scale,
                                  const void* offset, const void* points, const void* bias,
                                  void* out, int M, int K, int N, int64_t row_bytes,
                                  cudaStream_t s, int* plan) {
  const int w = pick_shape(M, N, sizeof(XT), points != nullptr, bits);
  switch (bits * 2 + (points != nullptr)) {
    case 4: return run_tc_shape<XT, false, 2>(w, QDT_TC_ARGS);
    case 5: return run_tc_shape<XT, true, 2>(w, QDT_TC_ARGS);
    case 8: return run_tc_shape<XT, false, 4>(w, QDT_TC_ARGS);
    case 9: return run_tc_shape<XT, true, 4>(w, QDT_TC_ARGS);
    case 16: return run_tc_shape<XT, false, 8>(w, QDT_TC_ARGS);
    case 17: return run_tc_shape<XT, true, 8>(w, QDT_TC_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

#undef QDT_TC_ARGS

// f32 compute: the CUDA-core kernel, its LUT instance when points are given.
template <typename XT>
static void launch(const void* x, const void* packed, const void* scale,
                   const void* offset, const void* points, const void* bias,
                   void* out, int M, int K, int N, int bits, int64_t row_bytes,
                   cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  auto kern = points ? dequant_matmul_kernel<XT, true> : dequant_matmul_kernel<XT, false>;
  kern<<<grid, THREADS, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale), static_cast<const float*>(offset),
      static_cast<const float*>(points), static_cast<const float*>(bias),
      static_cast<float*>(out), M, K, N, bits, row_bytes);
}

}  // namespace qdt

// x: [M, K] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); compute_bf16 selects the
// compute type (1: tensor cores, 0: f32 on CUDA cores); packed: uint8
// [K, npad*bits/8], 16-byte aligned; scale/offset: f32 [npad/256, K];
// points: f32 [2^bits] codebook (LUT variant) or null (uniform grid); bias:
// f32 [N] or null; out: f32 [M, N].
// Returns the CUDA error of the launch (or of raising the kernel's shared
// memory limit), 0 on success.
extern "C" int qdt_dequant_matmul(const void* x, int x_bf16, int compute_bf16,
                                  const void* packed, const void* scale,
                                  const void* offset, const void* points,
                                  const void* bias, void* out, int M, int K,
                                  int N, int npad, int bits, void* stream) {
  using namespace qdt;
  const int64_t row_bytes = (int64_t)npad * bits / 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (compute_bf16) {
    const cudaError_t err =
        x_bf16 ? run_tc_variant<__nv_bfloat16>(bits, x, packed, scale, offset, points, bias, out, M, K, N, row_bytes, s, nullptr)
               : run_tc_variant<float>(bits, x, packed, scale, offset, points, bias, out, M, K, N, row_bytes, s, nullptr);
    return static_cast<int>(err);
  }
  if (x_bf16)
    launch<__nv_bfloat16>(x, packed, scale, offset, points, bias, out, M, K, N, bits, row_bytes, s);
  else
    launch<float>(x, packed, scale, offset, points, bias, out, M, K, N, bits, row_bytes, s);
  return static_cast<int>(cudaGetLastError());
}

// The tile plan qdt_dequant_matmul uses for these arguments, for reports:
// plan[0..5] = rows per tile, columns per tile, copy stages, blocks,
// dynamic shared memory bytes (0: static only), resident blocks per SM
// (0: not computed). Returns the CUDA error of the occupancy query.
extern "C" int qdt_dequant_matmul_plan(int M, int K, int N, int x_bf16, int compute_bf16,
                                       int lut, int bits, int* plan) {
  using namespace qdt;
  if (!compute_bf16) {
    plan[0] = BM, plan[1] = BN, plan[2] = 1;
    plan[3] = ((N + BN - 1) / BN) * ((M + BM - 1) / BM);
    plan[4] = plan[5] = 0;
    return 0;
  }
  const void* pts = lut ? plan : nullptr;  // only tested for null
  const cudaError_t err =
      x_bf16 ? run_tc_variant<__nv_bfloat16>(bits, nullptr, nullptr, nullptr, nullptr, pts, nullptr, nullptr, M, K, N, 0, nullptr, plan)
             : run_tc_variant<float>(bits, nullptr, nullptr, nullptr, nullptr, pts, nullptr, nullptr, M, K, N, 0, nullptr, plan);
  return static_cast<int>(err);
}
