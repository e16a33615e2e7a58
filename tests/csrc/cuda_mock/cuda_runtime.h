// A CPU stand-in for the CUDA runtime features sapling_tpu_torch/csrc/sw.cu
// uses, so that its kernels compile with g++ and run on host memory
// (tests/test_torch_sw_cu_on_cpu.py). Every thread of a block is a
// std::thread; the warp-synchronous intrinsics meet at a std::barrier per
// warp. Blocks run one after another; a kernel launch returns when it is
// done. Not a model of the card's speed or memory, only of its semantics.
#pragma once
#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)

using std::max;
using std::min;

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline int cudaGetLastError() { return 0; }
template <class F>
int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }

struct MockDim { int x; };
inline thread_local MockDim threadIdx, blockIdx, blockDim;

struct MockWarp {
  std::barrier<> bar{32};
  int vals[32];
};
inline thread_local MockWarp* mock_warp;
inline thread_local int mock_lane;
inline thread_local int32_t* mock_smem;

// every lane posts v, then reads lane src's (its own when `own`)
inline int mock_exchange(int v, int src, bool own) {
  mock_warp->vals[mock_lane] = v;
  mock_warp->bar.arrive_and_wait();
  const int r = own ? v : mock_warp->vals[src];
  mock_warp->bar.arrive_and_wait();
  return r;
}
inline int __shfl_up_sync(unsigned, int v, int d, int width = 32) {
  const int src = mock_lane - d;
  return mock_exchange(v, src, src < (mock_lane & ~(width - 1)));
}
inline int __shfl_xor_sync(unsigned, int v, int m, int = 32) {
  return mock_exchange(v, mock_lane ^ m, false);
}
inline int __reduce_max_sync(unsigned, int v) {
  mock_warp->vals[mock_lane] = v;
  mock_warp->bar.arrive_and_wait();
  int r = v;
  for (int i = 0; i < 32; ++i) r = std::max(r, mock_warp->vals[i]);
  mock_warp->bar.arrive_and_wait();
  return r;
}
inline void __syncwarp() { mock_warp->bar.arrive_and_wait(); }

// DPX (sm_90): max/min with ReLU, 3-way max, add then max
inline int __vimax_s32_relu(int a, int b) { return std::max({a, b, 0}); }
inline int __vimax3_s32(int a, int b, int c) { return std::max({a, b, c}); }
inline int __vimax3_s32_relu(int a, int b, int c) {
  return std::max({a, b, c, 0});
}
inline int __viaddmax_s32(int a, int b, int c) { return std::max(a + b, c); }

// kernel<<<blocks, threads, smem, stream>>>(args) is rewritten by the test
// into mock_launch(blocks, threads, smem, [=] { kernel(args); })
inline void mock_launch(int blocks, int threads, size_t smem,
                        const std::function<void()>& kernel) {
  std::vector<int32_t> shared(smem / 4 + 1);
  for (int b = 0; b < blocks; ++b) {
    std::vector<std::unique_ptr<MockWarp>> warps;
    for (int w = 0; w < threads / 32; ++w)
      warps.push_back(std::make_unique<MockWarp>());
    std::vector<std::thread> lanes;
    for (int t = 0; t < threads; ++t)
      lanes.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim.x = threads;
        mock_warp = warps[t / 32].get();
        mock_lane = t % 32;
        mock_smem = shared.data();
        kernel();
      });
    for (auto& lane : lanes) lane.join();
  }
}
