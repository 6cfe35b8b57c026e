// Beam combine and beam advance: per sentence, the top-k of its candidate
// scores with jax.lax.top_k's order (values descending, equal values by
// ascending position), in one warp.
//
// Replaces the TPU kernel _combine_kernel of
// quantized_distillation_tpu/kernels/beam_combine.py (launched by
// beam_combine_topk there), which pads each row to 128 lanes with -1e30 and
// overwrites each winner with that sentinel.
//
// Two entry points share the warp's selection (select_next):
// - qdt_beam_combine, the counterpart of the JAX public function: the
//   top-k of [B, n <= 128] candidate scores and the winners' tokens.
// - qdt_beam_advance, the serving main path's form: one decode step's whole
//   beam advance from the fused generator's per-beam (vals, idx, lse), i.e.
//   the candidate scores (logp = vals - lse; a finished beam's single EOS
//   continuation at zero added score; cand = score + logp, the plain
//   version's two f32 roundings in its order), the per-sentence top-K, and
//   the bookkeeping the plain beam core does after it: parent and token,
//   finished and lengths gathered by parent, row t of the sym / parent
//   histories written in place, EOS and length tracking, and the flat row
//   b * K + parent each new beam reads its decoder state from. The
//   continuous-batching engine's form takes two more operands from device
//   memory, so a captured CUDA graph can replay it step after step: the
//   history row `pos` (the ring position, which advances inside the graph)
//   in place of `t`, and an `active` flag per sentence. An inactive
//   sentence keeps its scores, flags, lengths and last tokens as they were
//   and gets the identity flat row; its history row holds the stepped
//   values, which no extraction reads (the JAX engine's merge in one_step).
//
// What bounds them on an H100: at the serving shape (256 sentences x 5
// beams x 5 candidates) the advance moves ~0.1 MB and does a few thousand
// compares, so launch latency bounds it, far above both the byte and the
// operation bound. Around the combine the eager beam core launched ~30
// small PyTorch kernels a step for the same bookkeeping; the advance does
// all of it in the one launch. The design keeps to one warp per sentence
// and no shared memory: each lane holds up to PER candidates in registers,
// K rounds of a warp-shuffle argmax over (value, -position). A winner is
// marked with a taken flag instead of being overwritten with a sentinel,
// and lanes past n hold no candidate at all, so no input value (-inf or
// anything below a sentinel) can lose to padding. In the advance, lane k <
// K reads beam k's old score, finished flag and length once and shares them
// by shuffle; lane j < K then writes new beam j only, so reading and
// writing the beam state in place cannot race. For finite inputs the
// result is the TPU kernel's.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace qdt {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int COMBINE_PER_LANE = 4;  // combine: n <= 128 candidates per row
constexpr int ADVANCE_PER_LANE = 2;  // advance: K * kc <= 64 per sentence
constexpr int ROWS_PER_BLOCK = 4;
constexpr float NEG_INF = -1e9f;  // the beam core's NEG_INF

__device__ __forceinline__ bool better(float v1, int p1, float v2, int p2) {
  return v1 > v2 || (v1 == v2 && p1 < p2);
}

// One round of the warp's selection. Lane `lane` holds the candidates at
// positions lane + WARP * s; live[s] says the one in slot s exists and is
// not taken yet. Every lane gets the best live candidate (value, position)
// in lax.top_k order, and its owner marks it taken. bp == INT_MAX: none is
// left.
template <int PER>
__device__ __forceinline__ void select_next(const float (&v)[PER], bool (&live)[PER],
                                            int lane, float& bv, int& bp) {
  bv = 0.f;
  bp = INT_MAX;  // INT_MAX: this lane has no live candidate
#pragma unroll
  for (int s = 0; s < PER; ++s) {
    const int p = lane + WARP * s;
    if (live[s] && (bp == INT_MAX || better(v[s], p, bv, bp))) {
      bv = v[s];
      bp = p;
    }
  }
#pragma unroll
  for (int off = WARP / 2; off >= 1; off /= 2) {
    const float ov = __shfl_xor_sync(FULL, bv, off);
    const int op = __shfl_xor_sync(FULL, bp, off);
    if (op != INT_MAX && (bp == INT_MAX || better(ov, op, bv, bp))) {
      bv = ov;
      bp = op;
    }
  }
  // every lane now holds the same winner; its owner marks it taken
#pragma unroll
  for (int s = 0; s < PER; ++s)
    if (bp == lane + WARP * s) live[s] = false;
}

__global__ void __launch_bounds__(WARP * ROWS_PER_BLOCK)
    beam_combine_kernel(const float* __restrict__ cand,
                        const int* __restrict__ tok, int B, int n, int k,
                        float* __restrict__ out_v, int* __restrict__ out_pos,
                        int* __restrict__ out_tok) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  if (row >= B) return;  // the whole warp leaves together
  float v[COMBINE_PER_LANE];
  bool live[COMBINE_PER_LANE];
#pragma unroll
  for (int s = 0; s < COMBINE_PER_LANE; ++s) {
    const int p = lane + WARP * s;
    live[s] = p < n;
    v[s] = live[s] ? cand[(int64_t)row * n + p] : 0.f;
  }
  for (int j = 0; j < k; ++j) {
    float bv;
    int bp;
    select_next(v, live, lane, bv, bp);
    if (lane == 0) {
      const int64_t o = (int64_t)row * k + j;
      out_v[o] = bv;
      out_pos[o] = bp;
      out_tok[o] = tok[(int64_t)row * n + bp];
    }
  }
}

__global__ void __launch_bounds__(WARP * ROWS_PER_BLOCK)
    beam_advance_kernel(const float* __restrict__ vals,
                        const int* __restrict__ idx,
                        const float* __restrict__ lse, float* scores,
                        uint8_t* finished, int* lengths, int64_t* last_token,
                        int* __restrict__ sym, int8_t* __restrict__ parent,
                        int64_t* __restrict__ flat_row,
                        const int* __restrict__ pos,
                        const uint8_t* __restrict__ active, int B, int K,
                        int kc, int t, int eos, int pad) {
  const int b = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  if (b >= B) return;  // the whole warp leaves together
  const bool stepping = active == nullptr || active[b] != 0;
  const int n = K * kc;
  const int64_t beam0 = (int64_t)b * K;

  // the sentence's old beam state, beam k in lane k, read before any write
  float score = 0.f;
  int fin = 0, len = 0;
  if (lane < K) {
    score = scores[beam0 + lane];
    fin = finished[beam0 + lane] != 0;
    len = lengths[beam0 + lane];
  }

  // candidate scores, position p = beam * kc + slot in lane p % WARP
  float v[ADVANCE_PER_LANE];
  int tok[ADVANCE_PER_LANE];
  bool live[ADVANCE_PER_LANE];
#pragma unroll
  for (int s = 0; s < ADVANCE_PER_LANE; ++s) {
    const int p = lane + WARP * s;
    live[s] = p < n;
    const int beam = live[s] ? p / kc : 0;
    const float beam_score = __shfl_sync(FULL, score, beam);
    const int beam_fin = __shfl_sync(FULL, fin, beam);
    float logp = 0.f;
    tok[s] = 0;
    if (live[s]) {
      logp = vals[beam0 * kc + p] - lse[beam0 + beam];
      tok[s] = idx[beam0 * kc + p];
      if (beam_fin) {  // a single EOS continuation at zero added score
        logp = p % kc == 0 ? 0.f : NEG_INF;
        tok[s] = eos;
      }
    }
    v[s] = beam_score + logp;
  }

  // K rounds; lane j keeps round j's winner
  float my_v = 0.f;
  int my_p = 0;
  for (int j = 0; j < K; ++j) {
    float bv;
    int bp;
    select_next(v, live, lane, bv, bp);
    if (lane == j) {
      my_v = bv;
      my_p = bp;
    }
  }
  int my_tok = 0;
#pragma unroll
  for (int s = 0; s < ADVANCE_PER_LANE; ++s) {
    const int from = __shfl_sync(FULL, tok[s], my_p % WARP);
    if (my_p / WARP == s) my_tok = from;
  }
  const int par = my_p / kc;
  const int par_fin = __shfl_sync(FULL, fin, par);
  const int par_len = __shfl_sync(FULL, len, par);
  if (lane < K) {
    const int64_t row = beam0 + lane;
    const int64_t hist = (int64_t)(pos == nullptr ? t : *pos) * B * K + row;
    const int done = par_fin || my_tok == eos;
    sym[hist] = par_fin ? pad : my_tok;
    parent[hist] = static_cast<int8_t>(par);
    if (stepping) {
      scores[row] = my_v;
      finished[row] = static_cast<uint8_t>(done);
      lengths[row] = par_len + (done ? 0 : 1);
      last_token[row] = my_tok;
    }
    flat_row[row] = stepping ? beam0 + par : row;
  }
}

}  // namespace qdt

// cand: f32 [B, n]; tok: int32 [B, n]; outputs f32 / int32 / int32 [B, k].
// Requires 1 <= k <= n <= 128. Returns cudaGetLastError() after the launch.
extern "C" int qdt_beam_combine(const void* cand, const void* tok, int B, int n,
                                int k, void* out_v, void* out_pos,
                                void* out_tok, void* stream) {
  using namespace qdt;
  const int blocks = (B + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  beam_combine_kernel<<<blocks, WARP * ROWS_PER_BLOCK, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cand), static_cast<const int*>(tok), B, n, k,
      static_cast<float*>(out_v), static_cast<int*>(out_pos),
      static_cast<int*>(out_tok));
  return static_cast<int>(cudaGetLastError());
}

// vals: f32 [B*K, kc]; idx: int32 [B*K, kc]; lse: f32 [B*K]; in place:
// scores f32, finished bool (one byte), lengths int32, last_token int64, all
// [B, K]; row t of sym int32 / parent int8 [T, B*K]; out: flat_row int64
// [B*K]. pos: null, or int32 [1] on the device, the history row read in
// place of t; active: null (every sentence steps), or bool (one byte) [B].
// Requires 1 <= K <= 32, 1 <= K * kc <= 64, 0 <= t (or *pos) < T. Returns
// cudaGetLastError() after the launch.
extern "C" int qdt_beam_advance(const void* vals, const void* idx,
                                const void* lse, void* scores, void* finished,
                                void* lengths, void* last_token, void* sym,
                                void* parent, void* flat_row, const void* pos,
                                const void* active, int B, int K, int kc,
                                int t, int eos, int pad, void* stream) {
  using namespace qdt;
  const int blocks = (B + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  beam_advance_kernel<<<blocks, WARP * ROWS_PER_BLOCK, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(idx),
      static_cast<const float*>(lse), static_cast<float*>(scores),
      static_cast<uint8_t*>(finished), static_cast<int*>(lengths),
      static_cast<int64_t*>(last_token), static_cast<int*>(sym),
      static_cast<int8_t*>(parent), static_cast<int64_t*>(flat_row),
      static_cast<const int*>(pos), static_cast<const uint8_t*>(active), B, K,
      kc, t, eos, pad);
  return static_cast<int>(cudaGetLastError());
}
