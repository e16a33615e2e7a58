// A CPU stand-in for the CUDA runtime features that the sources in
// sapling_tpu_torch/csrc/ use, so that their kernels compile with g++ and
// run on host memory (tests/test_torch_sw_cu_on_cpu.py,
// tests/test_torch_query_cu_on_cpu.py,
// tests/test_torch_nn_predict_cu_on_cpu.py). Every thread of a block is a
// std::thread; the warp-synchronous intrinsics meet at a std::barrier per
// warp, __syncthreads at one per block. Blocks run one after another, so
// shared memory is one buffer that each block takes over in turn; a kernel
// launch returns when it is done. Not a model of the card's speed or
// memory, only of its semantics.
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
#define __host__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __grid_constant__

using std::max;
using std::min;

typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaErrorInvalidConfiguration = 9;
inline int cudaGetLastError() { return 0; }

// the device: MOCK_SMS multiprocessors that hold one block each, so a
// persistent grid is MOCK_SMS blocks and its loops wrap
constexpr int MOCK_SMS = 2;
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = MOCK_SMS;
  return cudaSuccess;
}
template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <typename F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* blocks, F, int, size_t) {
  *blocks = 1;
  return cudaSuccess;
}

struct MockDim { int x; };
inline thread_local MockDim threadIdx, blockIdx, blockDim, gridDim;

// the dynamic shared memory of the running block: the test rewrites each
// `extern __shared__ T name[];` into a pointer to it
inline std::vector<unsigned char> mock_smem;
inline unsigned char* mock_dynamic_smem() { return mock_smem.data(); }
inline thread_local std::barrier<>* mock_block;
inline void __syncthreads() { mock_block->arrive_and_wait(); }

struct MockWarp {
  std::barrier<> bar{32};
  int vals[32];
  long long wide[32];
};
inline thread_local MockWarp* mock_warp;
inline thread_local int mock_lane;

// every lane posts v, then reads lane src's (its own when `own`)
inline int mock_exchange(int v, int src, bool own) {
  mock_warp->vals[mock_lane] = v;
  mock_warp->bar.arrive_and_wait();
  const int r = own ? v : mock_warp->vals[src];
  mock_warp->bar.arrive_and_wait();
  return r;
}
inline long long mock_exchange(long long v, int src, bool own) {
  mock_warp->wide[mock_lane] = v;
  mock_warp->bar.arrive_and_wait();
  const long long r = own ? v : mock_warp->wide[src];
  mock_warp->bar.arrive_and_wait();
  return r;
}
template <typename T>
inline T __shfl_up_sync(unsigned, T v, int d, int width = 32) {
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
inline int __shfl_sync(unsigned, int v, int src, int = 32) {
  return mock_exchange(v, src, false);
}
// whether every lane's p holds
inline bool __all_sync(unsigned, bool p) {
  mock_warp->vals[mock_lane] = p;
  mock_warp->bar.arrive_and_wait();
  bool all = true;
  for (int i = 0; i < 32; ++i) all = all && mock_warp->vals[i];
  mock_warp->bar.arrive_and_wait();
  return all;
}

// DPX (sm_90): max/min with ReLU, 3-way max, add then max
inline int __vimax_s32_relu(int a, int b) { return std::max({a, b, 0}); }
inline int __vimax3_s32(int a, int b, int c) { return std::max({a, b, c}); }
inline int __vimax3_s32_relu(int a, int b, int c) {
  return std::max({a, b, c, 0});
}
inline int __viaddmax_s32(int a, int b, int c) { return std::max(a + b, c); }

// the 16-byte vector types of vector_types.h that the sources load and store
struct alignas(16) longlong2 {
  long long x, y;
};
inline longlong2 make_longlong2(long long x, long long y) { return {x, y}; }
struct alignas(16) double2 {
  double x, y;
};

// read-only loads, leading zeros (of 0: the width, as on the card), and an
// atomic add and max that the lanes of a block, all running at once, may
// share
template <typename T>
inline T __ldg(const T* p) { return *p; }
// the evict-first (streaming) load and store: a plain load and store here,
// where there is no cache to keep
template <typename T>
inline T __ldcs(const T* p) { return *p; }
template <typename T>
inline void __stcs(T* p, T v) { *p = v; }
inline int __clz(int x) {
  return x ? __builtin_clz((unsigned)x) : 32;
}
inline int __clzll(long long x) {
  return x ? __builtin_clzll((unsigned long long)x) : 64;
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicMax(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (old < v && !__atomic_compare_exchange_n(p, &old, v, false,
                                                 __ATOMIC_SEQ_CST,
                                                 __ATOMIC_SEQ_CST)) {
  }
  return old;
}

// fp64 arithmetic rounded to nearest, one IEEE operation each, and the
// rounding to float32 (the tests build a source that uses them with
// -ffp-contract=off, so that g++ fuses no multiply and add either)
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline float __double2float_rn(double a) { return (float)a; }

// kernel<<<blocks, threads, smem, stream>>>(args) is rewritten by the test
// into mock_launch(blocks, threads, smem, [=] { kernel(args); })
inline void mock_launch(int blocks, int threads, size_t smem,
                        const std::function<void()>& kernel) {
  mock_smem.assign(smem, 0xA5);   // not zero: the card does not clear it
  for (int b = 0; b < blocks; ++b) {
    std::vector<std::unique_ptr<MockWarp>> warps;
    for (int w = 0; w < threads / 32; ++w)
      warps.push_back(std::make_unique<MockWarp>());
    std::barrier<> block(threads);
    std::vector<std::thread> lanes;
    for (int t = 0; t < threads; ++t)
      lanes.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim.x = threads;
        gridDim.x = blocks;
        mock_block = &block;
        mock_warp = warps[t / 32].get();
        mock_lane = t % 32;
        kernel();
      });
    for (auto& lane : lanes) lane.join();
  }
}
