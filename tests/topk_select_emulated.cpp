// Runs the tensor-core generator's selection stage (select_tile and
// write_split of csrc/topk_fused.cu, cut out by the test into
// topk_select.inc) on one warp emulated on the host, over the splits of a
// [16, ncols] logits matrix: the 16 rows one warp of a wgmma tile holds.
//
//   topk_select_emulated <logits.f32> <nsub> <ncols> <N> <ktop> <tiles_per_split> <out>
//
// writes, per split and row, the split's KMAX values (f32), indices (i32),
// max and sum (f32), in the layout of the kernel's Parts.
#include <cstdio>
#include <cstdlib>

#include "warp_emulation.h"

namespace qdt {
#include "topk_select.inc"
}

template <int NSUB>
static void run(const std::vector<float>& logits, int ncols, int n_valid, int ktop, int tps,
                qdt::Parts out, int splits) {
  constexpr int BN = 64 * NSUB;
  const int ntiles = ncols / BN;
  std::vector<float> bias(ncols, 0.f);
  std::vector<float> scratch(32 * 16 * NSUB);
  warp_emulation::run_warp([&](int lane) {
    const int q = lane % 4;
    for (int sp = 0; sp < splits; ++sp) {
      qdt::Rows<2> rows;
      for (int t = sp * tps; t < ntiles && t < (sp + 1) * tps; ++t) {
        const int col0 = t * BN;
        float acc[NSUB][32];
        for (int sub = 0; sub < NSUB; ++sub)
          for (int c = 0; c < 8; ++c)
            for (int h = 0; h < 2; ++h)
              for (int u = 0; u < 2; ++u)
                acc[sub][4 * c + 2 * h + u] =
                    logits[(size_t)(lane / 4 + 8 * h) * ncols + col0 + sub * 64 + 8 * c + 2 * q + u];
        float b[NSUB][16];
        qdt::load_bias<NSUB>(bias.data(), col0, n_valid, b);
        qdt::select_tile<1, NSUB>(acc, b, col0, ktop, scratch.data(), rows);
        __syncwarp();  // the kernel's barrier before the next tile reuses the scratch
      }
      qdt::write_split<1>(rows, lane / 4, 16, sp, splits, out);
    }
  });
}

int main(int argc, char** argv) {
  if (argc != 8) {
    std::fprintf(stderr, "usage: %s logits nsub ncols N ktop tiles_per_split out\n", argv[0]);
    return 2;
  }
  const int nsub = std::atoi(argv[2]), ncols = std::atoi(argv[3]), n_valid = std::atoi(argv[4]);
  const int ktop = std::atoi(argv[5]), tps = std::atoi(argv[6]);
  std::vector<float> logits((size_t)16 * ncols);
  FILE* f = std::fopen(argv[1], "rb");
  if (!f || std::fread(logits.data(), 4, logits.size(), f) != logits.size()) return 3;
  std::fclose(f);
  const int ntiles = ncols / (64 * nsub);
  const int splits = (ntiles + tps - 1) / tps;
  std::vector<float> v(16 * splits * qdt::KMAX), m(16 * splits), s(16 * splits);
  std::vector<int> i(16 * splits * qdt::KMAX);
  const qdt::Parts out{v.data(), i.data(), m.data(), s.data()};
  if (nsub == 1)
    run<1>(logits, ncols, n_valid, ktop, tps, out, splits);
  else
    run<2>(logits, ncols, n_valid, ktop, tps, out, splits);
  FILE* g = std::fopen(argv[7], "wb");
  if (!g) return 4;
  std::fwrite(v.data(), 4, v.size(), g);
  std::fwrite(i.data(), 4, i.size(), g);
  std::fwrite(m.data(), 4, m.size(), g);
  std::fwrite(s.data(), 4, s.size(), g);
  std::fclose(g);
  return 0;
}
