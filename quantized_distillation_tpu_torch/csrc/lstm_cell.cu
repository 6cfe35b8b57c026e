// The LSTM cell's pointwise step, forward and backward, one launch each:
// everything of flax's OptimizedLSTMCell after the recurrent product
// hw = h @ wh (which stays a torch.matmul, as do its gradients).
//
// No TPU kernel is replaced: the JAX package leaves the cell's pointwise
// work to XLA, which fuses it into the scan of each LSTM. On the card the
// same work was 11 elementwise kernels a cell step forward and 15 more in
// autograd's backward (its muls, sigmoid and tanh backwards, the add and
// the cat of the four gates), each a launch of a few microseconds over a
// few hundred KB, in train step graphs of 3,700-12,000 kernels whose launch
// paces the step (models/seq2seq.py::lstm_gates runs every time step of
// every layer of student and teacher).
//
// qdt_lstm_cell_forward: for each row r and hidden unit u of width W,
//   z_k = (hw[r, kW + u] + b[kW + u]) + xw[r, kW + u]  for the gates k = i, f, g, o
//   c'  = sigmoid(z_f) c + sigmoid(z_i) tanh(z_g),  h' = sigmoid(z_o) tanh(c')
//   and, where autograd will need them, saved[r] = [i | f | g | o | tanh(c')]
//   (the activated gates), a [B, 5W] buffer.
// qdt_lstm_cell_backward: from dh' and dc' (either may be null: zero) and
//   the saved buffer, dz [B, 4W] in i, f, g, o order (the gradient of hw and
//   of xw; its column sums are the bias's) and dc [B, W] (may be null).
//
// What bounds it on an H100: neither bytes nor operations. At the cells'
// shapes a call moves 0.3-3 MB (~0.1-1 us at 3.35 TB/s) and does ~100
// operations a unit; what it removes is 10 launches forward and 14
// backward, each a graph node the host has to launch. The design is the
// plainest that reads each byte once: one thread a (row, 4 units), float4
// loads of the four gate columns u, W + u, 2W + u, 3W + u, neighbouring
// threads on neighbouring units, where W % 4 == 0 and every pointer and row
// stride allows it; one thread a (row, unit) otherwise (the LM teacher's
// W = 650). The per-step input xw is read through its row stride, so the
// slice xw[:, t] of a [B, T, 4W] product needs no copy; the incoming
// gradients likewise (a stack's backward hands out strided slices).
//
// Numerics: the composite's f32 operations in its order, each rounded on
// its own (__fadd_rn, __fmul_rn, __fdiv_rn: nvcc contracts nothing into an
// FMA), sigmoid as 1 / (1 + expf(-z)) and tanhf, as PyTorch's CUDA kernels
// compute them, no fast-math intrinsic. The backward is autograd's:
// sigmoid_backward g (1 - y) y, tanh_backward g (1 - y y), where PyTorch's
// kernels (nvcc's default -fmad=true on the card; the CPU build likewise)
// compute 1 - y y as one FMA, which __fmaf_rn writes out; the gradient of
// c' is dc' + tanh_backward(dh' o, tanh(c')).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace qdt {

// ---------------------------------------------------------- cell arithmetic
// tests/test_torch_lstm_cell_emulated.py compiles this part for the host with
// g++ (CUDA's keywords and rounding intrinsics stood in) and holds it to the
// PyTorch composite.

struct Gates4 {
  float i, f, g, o;
};

struct CellOut {
  float i, f, g, o;  // the activated gates: sigmoid, sigmoid, tanh, sigmoid
  float c, tc, h;    // c', tanh(c'), h'
};

struct CellGrad {
  float zi, zf, zg, zo;  // the gradient of z, gate by gate
  float c;               // the gradient of c
};

__device__ __forceinline__ float lstm_sigmoid(float z) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-z)));
}

__device__ __forceinline__ float lstm_z(float hw, float b, float xw) {
  return __fadd_rn(__fadd_rn(hw, b), xw);
}

__device__ __forceinline__ CellOut lstm_cell_forward(Gates4 hw, Gates4 b, Gates4 xw, float c) {
  CellOut o;
  o.i = lstm_sigmoid(lstm_z(hw.i, b.i, xw.i));
  o.f = lstm_sigmoid(lstm_z(hw.f, b.f, xw.f));
  o.g = tanhf(lstm_z(hw.g, b.g, xw.g));
  o.o = lstm_sigmoid(lstm_z(hw.o, b.o, xw.o));
  o.c = __fadd_rn(__fmul_rn(o.f, c), __fmul_rn(o.i, o.g));
  o.tc = tanhf(o.c);
  o.h = __fmul_rn(o.o, o.tc);
  return o;
}

// autograd's sigmoid_backward(g, y) and tanh_backward(g, y)
__device__ __forceinline__ float sigmoid_grad(float g, float y) {
  return __fmul_rn(__fmul_rn(g, __fsub_rn(1.f, y)), y);
}

__device__ __forceinline__ float tanh_grad(float g, float y) {
  return __fmul_rn(g, __fmaf_rn(-y, y, 1.f));
}

// s: the saved activations (s.c unused), c: the cell's input c, dh and dc:
// the gradients of h' and c'
__device__ __forceinline__ CellGrad lstm_cell_backward(CellOut s, float c, float dh, float dc) {
  const float dct = __fadd_rn(dc, tanh_grad(__fmul_rn(dh, s.o), s.tc));
  CellGrad d;
  d.zi = sigmoid_grad(__fmul_rn(dct, s.g), s.i);
  d.zf = sigmoid_grad(__fmul_rn(dct, c), s.f);
  d.zg = tanh_grad(__fmul_rn(dct, s.i), s.g);
  d.zo = sigmoid_grad(__fmul_rn(dh, s.tc), s.o);
  d.c = __fmul_rn(dct, s.f);
  return d;
}

// ------------------------------------------------------------------ kernels

constexpr int THREADS = 128;

// V consecutive floats: a float4 where V == 4
template <int V>
struct Vec {
  float x[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load(const float* p) {
  Vec<V> v;
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v.x[0] = t.x;
    v.x[1] = t.y;
    v.x[2] = t.z;
    v.x[3] = t.w;
  } else {
    v.x[0] = __ldg(p);
  }
  return v;
}

template <int V>
__device__ __forceinline__ Vec<V> load_or_zero(const float* p) {
  if (p) return load<V>(p);
  Vec<V> v;
#pragma unroll
  for (int k = 0; k < V; ++k) v.x[k] = 0.f;
  return v;
}

template <int V>
__device__ __forceinline__ void store(float* p, const Vec<V>& v) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v.x[0], v.x[1], v.x[2], v.x[3]);
  else
    *p = v.x[0];
}

struct FwdArgs {
  const float *hw, *b, *xw, *c;
  long long s_hw, s_xw, s_c;  // row strides, in floats
  float *c_out, *h_out;       // [B, W]
  float* saved;               // [B, 5W] or null
  int rows, width;
};

struct BwdArgs {
  const float *dh, *dc, *saved, *c;  // dh, dc may be null
  long long s_dh, s_dc, s_c;
  float* dz;     // [B, 4W]
  float* dc_in;  // [B, W] or null
  int rows, width;
};

// (row, first unit) of this thread, or false past the last
template <int V>
__device__ __forceinline__ bool unit_of(int rows, int width, int& r, int& u) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int per_row = width / V;
  if (t >= (long long)rows * per_row) return false;
  r = (int)(t / per_row);
  u = (int)(t % per_row) * V;
  return true;
}

template <int V>
__global__ void __launch_bounds__(THREADS) lstm_cell_fwd_kernel(FwdArgs a) {
  int r, u;
  if (!unit_of<V>(a.rows, a.width, r, u)) return;
  const int w = a.width;
  const float* hw = a.hw + r * a.s_hw + u;
  const float* xw = a.xw + r * a.s_xw + u;
  const float* b = a.b + u;
  Vec<V> hv[4], xv[4], bv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    hv[k] = load<V>(hw + k * w);
    xv[k] = load<V>(xw + k * w);
    bv[k] = load<V>(b + k * w);
  }
  const Vec<V> c = load<V>(a.c + r * a.s_c + u);
  Vec<V> out[7];  // i, f, g, o, c', tanh(c'), h'
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const CellOut o = lstm_cell_forward({hv[0].x[e], hv[1].x[e], hv[2].x[e], hv[3].x[e]},
                                        {bv[0].x[e], bv[1].x[e], bv[2].x[e], bv[3].x[e]},
                                        {xv[0].x[e], xv[1].x[e], xv[2].x[e], xv[3].x[e]},
                                        c.x[e]);
    out[0].x[e] = o.i;
    out[1].x[e] = o.f;
    out[2].x[e] = o.g;
    out[3].x[e] = o.o;
    out[4].x[e] = o.c;
    out[5].x[e] = o.tc;
    out[6].x[e] = o.h;
  }
  const long long row = (long long)r * w + u;
  store<V>(a.c_out + row, out[4]);
  store<V>(a.h_out + row, out[6]);
  if (a.saved) {
    float* s = a.saved + (long long)r * 5 * w + u;
#pragma unroll
    for (int k = 0; k < 4; ++k) store<V>(s + k * w, out[k]);
    store<V>(s + 4 * w, out[5]);
  }
}

template <int V>
__global__ void __launch_bounds__(THREADS) lstm_cell_bwd_kernel(BwdArgs a) {
  int r, u;
  if (!unit_of<V>(a.rows, a.width, r, u)) return;
  const int w = a.width;
  const float* s = a.saved + (long long)r * 5 * w + u;
  Vec<V> sv[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) sv[k] = load<V>(s + k * w);
  const Vec<V> c = load<V>(a.c + r * a.s_c + u);
  const Vec<V> dh = load_or_zero<V>(a.dh ? a.dh + r * a.s_dh + u : nullptr);
  const Vec<V> dc = load_or_zero<V>(a.dc ? a.dc + r * a.s_dc + u : nullptr);
  Vec<V> dz[4], dcv;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    CellOut o;
    o.i = sv[0].x[e];
    o.f = sv[1].x[e];
    o.g = sv[2].x[e];
    o.o = sv[3].x[e];
    o.c = 0.f;
    o.tc = sv[4].x[e];
    o.h = 0.f;
    const CellGrad d = lstm_cell_backward(o, c.x[e], dh.x[e], dc.x[e]);
    dz[0].x[e] = d.zi;
    dz[1].x[e] = d.zf;
    dz[2].x[e] = d.zg;
    dz[3].x[e] = d.zo;
    dcv.x[e] = d.c;
  }
  float* z = a.dz + (long long)r * 4 * w + u;
#pragma unroll
  for (int k = 0; k < 4; ++k) store<V>(z + k * w, dz[k]);
  if (a.dc_in) store<V>(a.dc_in + (long long)r * w + u, dcv);
}

// float4 path: W % 4 == 0, every pointer 16-byte aligned, every row stride
// a multiple of 4 floats
__host__ inline bool vectorizable(int width, std::initializer_list<const void*> ptrs,
                                  std::initializer_list<long long> strides) {
  if (width % 4) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (long long s : strides)
    if (s % 4) return false;
  return true;
}

inline int blocks(int rows, int width, int v) {
  return (int)(((long long)rows * (width / v) + THREADS - 1) / THREADS);
}

}  // namespace qdt

// hw [B, 4W] (row stride s_hw), b [4W], xw [B, 4W] (row stride s_xw), c
// [B, W] (row stride s_c), every row unit-stride; c_out, h_out [B, W] and
// saved [B, 5W] (or null) contiguous. Returns cudaGetLastError().
extern "C" int qdt_lstm_cell_forward(const void* hw, long long s_hw, const void* b,
                                     const void* xw, long long s_xw, const void* c, long long s_c,
                                     void* c_out, void* h_out, void* saved, int rows, int width,
                                     void* stream) {
  using namespace qdt;
  const FwdArgs a{static_cast<const float*>(hw), static_cast<const float*>(b),
                  static_cast<const float*>(xw), static_cast<const float*>(c),
                  s_hw, s_xw, s_c,
                  static_cast<float*>(c_out), static_cast<float*>(h_out),
                  static_cast<float*>(saved), rows, width};
  const auto st = static_cast<cudaStream_t>(stream);
  if (vectorizable(width, {hw, b, xw, c, c_out, h_out, saved}, {s_hw, s_xw, s_c}))
    lstm_cell_fwd_kernel<4><<<blocks(rows, width, 4), THREADS, 0, st>>>(a);
  else
    lstm_cell_fwd_kernel<1><<<blocks(rows, width, 1), THREADS, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// dh, dc [B, W] (row strides s_dh, s_dc; either may be null), saved [B, 5W]
// contiguous, c [B, W] (row stride s_c); dz [B, 4W] and dc_in [B, W] (or
// null) contiguous. Returns cudaGetLastError().
extern "C" int qdt_lstm_cell_backward(const void* dh, long long s_dh, const void* dc,
                                      long long s_dc, const void* saved, const void* c,
                                      long long s_c, void* dz, void* dc_in, int rows, int width,
                                      void* stream) {
  using namespace qdt;
  const BwdArgs a{static_cast<const float*>(dh), static_cast<const float*>(dc),
                  static_cast<const float*>(saved), static_cast<const float*>(c),
                  s_dh, s_dc, s_c, static_cast<float*>(dz), static_cast<float*>(dc_in),
                  rows, width};
  const auto st = static_cast<cudaStream_t>(stream);
  if (vectorizable(width, {dh, dc, saved, c, dz, dc_in}, {s_dh, s_dc, s_c}))
    lstm_cell_bwd_kernel<4><<<blocks(rows, width, 4), THREADS, 0, st>>>(a);
  else
    lstm_cell_bwd_kernel<1><<<blocks(rows, width, 1), THREADS, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
