// Bucketed fake-quant for the STE train step: each row (bucket) of an
// [n_buckets, bucket_size] f32 matrix is scaled into [0, 1] by its own
// min/max (linear) or abs-max, snapped to the grid k/s (s = 2^bits - 1,
// round half to even) and scaled back.
//
// Replaces the TPU kernel _fq_kernel of
// quantized_distillation_tpu/kernels/fake_quant.py:39 (launched by
// fake_quant_buckets_pallas there), which reads a [row_tile, bucket_size]
// block into VMEM, reduces it across lanes and writes it back once.
//
// What bounds it on an H100: bytes. It reads every weight once and writes
// it once (8 bytes per weight) and does ~8 float operations per weight, so
// at the train step's shape (105,984 buckets x 256: every quantizable leaf
// of student_medium) the bound is 217 MB / 3.35 TB/s = 0.065 ms; the
// operations would take a twentieth of that on the CUDA cores. The design
// keeps it to one pass over device memory: one warp per bucket, each lane
// loading bucket_size/32 floats as float4s, neighbouring lanes on
// neighbouring addresses; min and max by warp shuffles; then the warp reads
// its bucket again (an L1 hit: the warp just read those 1 KB) to quantize
// and store it. Eight warps, eight buckets, a block; the warps of a ragged
// last block whose bucket does not exist leave at once.
//
// Numerics: every operation is rounded on its own (__fsub_rn, __fdiv_rn,
// __fmul_rn, __fadd_rn; rintf rounds half to even like torch.round), and
// 1/s comes from the host as an f32, so nvcc's default -fmad=true cannot
// contract (q * inv_s) * scale + off into an FMA. For finite inputs the
// result equals the plain PyTorch version (fake_quant_buckets_reference)
// bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace qdt {

constexpr int WARP = 32;
constexpr int WARPS_PER_BLOCK = 8;

__device__ __forceinline__ float fake_quant_one(float x, float off, float scale,
                                                float s, float inv_s) {
  float q = rintf(__fmul_rn(__fdiv_rn(__fsub_rn(x, off), scale), s));
  q = fminf(fmaxf(q, 0.f), s);
  return __fadd_rn(__fmul_rn(__fmul_rn(q, inv_s), scale), off);
}

__global__ void __launch_bounds__(WARP * WARPS_PER_BLOCK)
    fake_quant_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                      int n_buckets, int vecs, float s, float inv_s,
                      int absmax) {
  const int64_t bucket =
      (int64_t)blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  if (bucket >= n_buckets) return;  // the whole warp leaves together
  const float4* xb = x + bucket * vecs;
  float4* ob = out + bucket * vecs;

  float lo = INFINITY, hi = -INFINITY;
#pragma unroll 4
  for (int v = lane; v < vecs; v += WARP) {
    const float4 t = xb[v];
    if (absmax) {
      hi = fmaxf(hi, fmaxf(fmaxf(fabsf(t.x), fabsf(t.y)),
                           fmaxf(fabsf(t.z), fabsf(t.w))));
    } else {
      lo = fminf(lo, fminf(fminf(t.x, t.y), fminf(t.z, t.w)));
      hi = fmaxf(hi, fmaxf(fmaxf(t.x, t.y), fmaxf(t.z, t.w)));
    }
  }
#pragma unroll
  for (int o = WARP / 2; o >= 1; o /= 2) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  float scale, off;
  if (absmax) {  // hi is the abs-max here
    scale = hi > 0.f ? __fmul_rn(2.f, hi) : 1.f;
    off = -hi;
  } else {
    const float rng = __fsub_rn(hi, lo);
    scale = rng > 0.f ? rng : 1.f;  // a constant bucket comes back unchanged
    off = lo;
  }

#pragma unroll 4
  for (int v = lane; v < vecs; v += WARP) {
    float4 t = xb[v];
    t.x = fake_quant_one(t.x, off, scale, s, inv_s);
    t.y = fake_quant_one(t.y, off, scale, s, inv_s);
    t.z = fake_quant_one(t.z, off, scale, s, inv_s);
    t.w = fake_quant_one(t.w, off, scale, s, inv_s);
    ob[v] = t;
  }
}

}  // namespace qdt

// x, out: f32 [n_buckets, bucket_size], contiguous, 16-byte aligned;
// bucket_size a multiple of 128; s = 2^bits - 1, inv_s = f32(1 / s);
// absmax: 0 linear (min/max) scaling, 1 abs-max scaling.
// Returns cudaGetLastError() after the launch.
extern "C" int qdt_fake_quant(const void* x, void* out, int n_buckets,
                              int bucket_size, float s, float inv_s,
                              int absmax, void* stream) {
  using namespace qdt;
  const int blocks = (n_buckets + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  fake_quant_kernel<<<blocks, WARP * WARPS_PER_BLOCK, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(out), n_buckets,
      bucket_size / 4, s, inv_s, absmax);
  return static_cast<int>(cudaGetLastError());
}
