// Runs the LSTM cell's arithmetic of csrc/lstm_cell.cu (lstm_cell_forward
// and lstm_cell_backward, cut out by the test into lstm_cell_math.inc) on
// the host, compiled with g++ -ffp-contract=off so that, as on the card,
// nothing is contracted into an FMA that the source does not write.
//
//   lstm_cell_emulated forward  <in.f32> <n> <out.f32>
//     in:  hw[4][n], b[4][n], xw[4][n], c[n]  (gate-major: i, f, g, o)
//     out: i, f, g, o, c', tanh(c'), h'       ([7][n])
//   lstm_cell_emulated backward <in.f32> <n> <out.f32>
//     in:  i, f, g, o, tanh(c'), c, dh, dc    ([8][n])
//     out: dz_i, dz_f, dz_g, dz_o, dc_in      ([5][n])
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#define __device__
#define __forceinline__ inline

static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
namespace qdt {
// The card's expf and tanhf are neither the host's libm nor the vectorized
// ones of PyTorch's CPU build: the host stands in with the functions
// rounded from double, and the test holds what each gives to 2 ulps.
static inline float expf(float x) { return (float)std::exp((double)x); }
static inline float tanhf(float x) { return (float)std::tanh((double)x); }

#include "lstm_cell_math.inc"
}

int main(int argc, char** argv) {
  if (argc != 5) {
    std::fprintf(stderr, "usage: %s forward|backward <in.f32> <n> <out.f32>\n", argv[0]);
    return 2;
  }
  const bool forward = std::strcmp(argv[1], "forward") == 0;
  const long n = std::atol(argv[3]);
  const int n_in = forward ? 13 : 8, n_out = forward ? 7 : 5;
  std::vector<float> in(n_in * n), out(n_out * n);
  FILE* f = std::fopen(argv[2], "rb");
  if (!f || std::fread(in.data(), sizeof(float), in.size(), f) != in.size()) return 1;
  std::fclose(f);
  auto at = [&](int k, long e) { return in[k * n + e]; };
  for (long e = 0; e < n; ++e) {
    if (forward) {
      const qdt::CellOut o = qdt::lstm_cell_forward(
          {at(0, e), at(1, e), at(2, e), at(3, e)}, {at(4, e), at(5, e), at(6, e), at(7, e)},
          {at(8, e), at(9, e), at(10, e), at(11, e)}, at(12, e));
      const float v[7] = {o.i, o.f, o.g, o.o, o.c, o.tc, o.h};
      for (int k = 0; k < 7; ++k) out[k * n + e] = v[k];
    } else {
      qdt::CellOut s{at(0, e), at(1, e), at(2, e), at(3, e), 0.f, at(4, e), 0.f};
      const qdt::CellGrad d = qdt::lstm_cell_backward(s, at(5, e), at(6, e), at(7, e));
      const float v[5] = {d.zi, d.zf, d.zg, d.zo, d.c};
      for (int k = 0; k < 5; ++k) out[k * n + e] = v[k];
    }
  }
  f = std::fopen(argv[4], "wb");
  if (!f || std::fwrite(out.data(), sizeof(float), out.size(), f) != out.size()) return 1;
  std::fclose(f);
  return 0;
}
