// One CUDA warp emulated by 32 std::threads on the host, for CPU tests of
// device code that uses warp intrinsics: each lane runs the same function,
// and every shuffle, vote and __syncwarp meets at a barrier of the 32. Only
// code whose shuffles and votes sit in warp-uniform control flow (as CUDA
// requires with a full mask) can run this way.
#pragma once

#include <barrier>
#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __forceinline__ inline

struct Dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local Dim3 threadIdx;

struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

namespace warp_emulation {
inline std::barrier<>* bar = nullptr;
inline uint64_t slots[32];

template <typename T>
T exchange(T v, int src) {
  static_assert(sizeof(T) <= 8, "one 8-byte slot a lane");
  const int lane = threadIdx.x % 32;
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  slots[lane] = bits;
  bar->arrive_and_wait();
  const uint64_t got = slots[src];
  bar->arrive_and_wait();
  T out;
  std::memcpy(&out, &got, sizeof(T));
  return out;
}

// Runs fn(lane) on 32 threads, threadIdx.x = lane.
inline void run_warp(const std::function<void(int)>& fn) {
  std::barrier<> b(32);
  bar = &b;
  std::vector<std::thread> lanes;
  for (int l = 0; l < 32; ++l)
    lanes.emplace_back([&, l] {
      threadIdx.x = l;
      fn(l);
    });
  for (auto& t : lanes) t.join();
  bar = nullptr;
}
}  // namespace warp_emulation

template <typename T>
T __shfl_sync(unsigned, T v, int src) {
  return warp_emulation::exchange(v, src & 31);
}
template <typename T>
T __shfl_xor_sync(unsigned, T v, int d) {
  return warp_emulation::exchange(v, (threadIdx.x % 32) ^ d);
}
template <typename T>
T __shfl_down_sync(unsigned, T v, int d) {
  const int lane = threadIdx.x % 32;
  const T got = warp_emulation::exchange(v, lane + d < 32 ? lane + d : lane);
  return got;
}
inline int __any_sync(unsigned, int pred) {
  const int lane = threadIdx.x % 32;
  warp_emulation::slots[lane] = pred != 0;
  warp_emulation::bar->arrive_and_wait();
  int any = 0;
  for (int l = 0; l < 32; ++l) any |= warp_emulation::slots[l] != 0;
  warp_emulation::bar->arrive_and_wait();
  return any;
}
inline void __syncwarp() { warp_emulation::bar->arrive_and_wait(); }
inline int __popc(uint32_t x) { return __builtin_popcount(x); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
inline float __expf(float x) { return std::exp(x); }
