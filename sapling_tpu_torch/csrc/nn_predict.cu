// The NN predictor's rank prediction for Hopper (sm_90a), one thread a
// lane.
//
// Replaces the XLA program of sapling_tpu/models/serve.py::
// NNServing.predict_ranks (:63) and computes exactly what the port's plain
// version computes (sapling_tpu_torch/ops/nn_predict_cuda.py nn_predict),
// bit for bit on every lane: x / x_max in float64, rounded to float32; the
// chunk c = searchsorted(xb, xs, right) - 1, clamped to [0, C-1]; the
// chunk's 1 -> s -> 1 MLP in float64 (h_j = relu(xs * w1[c,0,j] +
// b1[c,j]), res = h_0 w2[c,0,0] + h_1 w2[c,1,0] + ... in that order, +
// b2[c,0]); rows = (xs64 * line_m + line_c) - (res * res_ptp + res_min);
// rounded half to even, clamped to [0, n-1], as int64.
//
// Every product and sum is an _rn intrinsic: nvcc contracts a * b + c into
// one FMA by default, which rounds once where the plain version's separate
// multiply and add (one torch op each) round twice, and a rank off by one
// breaks the audit's windows. The division is __ddiv_rn, as the plain
// version divides by a tensor (never by a reciprocal).
//
// What bounds it: fp64 operations, at about 5 s + 13 a lane (s multiplies,
// adds and ReLUs for the hidden units, s multiplies and s - 1 adds for the
// sum, the conversions, the division, the un-scaling, the rounding and the
// clamp) on 64 fp64 lanes an SM, a little longer than its 16 bytes at
// 3.35 TB/s. What it meets first: a lane reads its chunk's 3 s + 1
// parameters, and the lanes of a warp belong to random chunks, so in the
// parameters' [C, s] layout each of a warp's loads touches up to 32 cache
// lines: read so, 1M lanes at C = 64, s = 16 took 0.172 ms on an NVIDIA
// H100 80GB HBM3 at 700 W, 31x the bound (PERF.md). The design: persistent
// blocks, each staging the parameters once in shared memory, transposed to
// [s][C] (and b2, xb), so that a warp's load of unit j reads one row of C
// doubles (bank conflicts only between chunks 16 apart): 0.044 ms there,
// in turns with the other; the lanes are a grid-stride loop in the
// caller's order. Where the parameters pass kSharedLimit bytes the kernel
// reads them from global memory in their own layout instead.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr size_t kSharedLimit = 96 * 1024;   // staged parameters, bytes

struct NNArgs {
  const int64_t* x;     // [B] adjusted k-mers
  const float* xb;      // [C] first scaled x of each chunk, ascending
  const double* w1;     // [C, 1, s]
  const double* b1;     // [C, s]
  const double* w2;     // [C, s, 1]
  const double* b2;     // [C, 1]
  int64_t* out;         // [B] predicted ranks
  int64_t B, n;
  int C, s;
  double x_max, line_m, line_c, res_ptp, res_min;
};

// the dynamic shared memory of a block
__device__ __forceinline__ unsigned char* shared_bytes() {
  extern __shared__ __align__(16) unsigned char smem[];
  return smem;
}

// the bytes of the staged parameters: w1, b1, w2 as [s][C], b2 [C], xb [C]
size_t shared_bytes_for(int C, int s) {
  return (size_t)C * (3 * s + 1) * sizeof(double) + (size_t)C * sizeof(float);
}

// The parameters as a lane reads them: element (c, j) of w1, b1 and w2 at
// c * cs + j * js, from shared memory (SHARED) or through the read-only
// cache.
template <bool SHARED>
struct Params {
  const float* xb;
  const double *w1, *b1, *w2, *b2;
  int64_t cs, js;

  template <typename T>
  __device__ __forceinline__ T ld(const T* p) const {
    if constexpr (SHARED)
      return *p;
    else
      return __ldg(p);
  }
};

template <bool SHARED>
__device__ __forceinline__ int64_t predict_lane(const NNArgs& a,
                                                const Params<SHARED>& p,
                                                int64_t x) {
  const double xs64 = __ddiv_rn((double)x, a.x_max);
  const float xs = __double2float_rn(xs64);
  // searchsorted(xb, xs, right=True): the count of boundaries <= xs
  int lo = 0, hi = a.C;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (p.ld(p.xb + mid) <= xs)
      lo = mid + 1;
    else
      hi = mid;
  }
  const int64_t c = lo == 0 ? 0 : lo - 1;   // lo <= C: c <= C - 1
  const double xd = (double)xs;
  double res = 0.0;
  for (int j = 0; j < a.s; ++j) {
    const int64_t at = c * p.cs + j * p.js;
    double h = __dadd_rn(__dmul_rn(xd, p.ld(p.w1 + at)), p.ld(p.b1 + at));
    h = h < 0.0 ? 0.0 : h;
    const double prod = __dmul_rn(h, p.ld(p.w2 + at));
    res = j == 0 ? prod : __dadd_rn(res, prod);
  }
  res = __dadd_rn(res, p.ld(p.b2 + c));
  const double rows =
      __dsub_rn(__dadd_rn(__dmul_rn(xs64, a.line_m), a.line_c),
                __dadd_rn(__dmul_rn(res, a.res_ptp), a.res_min));
  double r = rint(rows);
  const double top = (double)(a.n - 1);
  r = r < 0.0 ? 0.0 : (r > top ? top : r);
  return (int64_t)r;
}

template <bool SHARED>
__global__ void __launch_bounds__(kThreads)
    nn_predict_kernel(const __grid_constant__ NNArgs a) {
  Params<SHARED> p;
  if constexpr (SHARED) {
    const int C = a.C, s = a.s;
    double* w1 = reinterpret_cast<double*>(shared_bytes());
    double* b1 = w1 + (int64_t)s * C;
    double* w2 = b1 + (int64_t)s * C;
    double* b2 = w2 + (int64_t)s * C;
    float* xb = reinterpret_cast<float*>(b2 + C);
    for (int64_t i = threadIdx.x; i < (int64_t)C * s; i += blockDim.x) {
      const int64_t c = i / s, j = i - c * s;
      w1[j * C + c] = __ldg(a.w1 + i);
      b1[j * C + c] = __ldg(a.b1 + i);
      w2[j * C + c] = __ldg(a.w2 + i);
    }
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      b2[c] = __ldg(a.b2 + c);
      xb[c] = __ldg(a.xb + c);
    }
    __syncthreads();
    p = Params<SHARED>{xb, w1, b1, w2, b2, 1, C};
  } else {
    p = Params<SHARED>{a.xb, a.w1, a.b1, a.w2, a.b2, a.s, 1};
  }
  for (int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x; b < a.B;
       b += (int64_t)gridDim.x * kThreads)
    a.out[b] = predict_lane(a, p, a.x[b]);
}

// nn_predict_kernel<SHARED> on no more blocks than fit on the card at once
// (each stages the parameters once and loops over the lanes). The blocks an
// SM holds are found on a device's first call with a staged size, where
// the kernel is also allowed that shared memory, and kept for the next
// call with that size.
template <bool SHARED>
int launch(const NNArgs& a, size_t smem, cudaStream_t stream) {
  static std::atomic<uint64_t> resident[64];   // smem << 32 | blocks
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidValue;
  uint64_t held = resident[dev].load(std::memory_order_relaxed);
  if ((held >> 32) != smem || (uint32_t)held == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(nn_predict_kernel<SHARED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, nn_predict_kernel<SHARED>, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    held = (uint64_t)smem << 32 | (uint32_t)(per_sm * sms);
    resident[dev].store(held, std::memory_order_relaxed);
  }
  int64_t grid = (uint32_t)held;
  const int64_t needed = (a.B + kThreads - 1) / kThreads;
  if (needed < grid) grid = needed;
  nn_predict_kernel<SHARED><<<(int)grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes); returns a cudaError_t, 0 = launched.
// x and out are int64 [B], xb float32 [C], the parameters float64 and
// contiguous, hidden_layers == 1.
extern "C" int nn_predict_launch(const void* x, const void* xb,
                                 const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* out,
                                 long long B, long long n, int C, int s,
                                 double x_max, double line_m, double line_c,
                                 double res_ptp, double res_min,
                                 void* stream) {
  if (B <= 0) return 0;
  if (C < 1 || s < 1) return (int)cudaErrorInvalidValue;
  NNArgs a{static_cast<const int64_t*>(x), static_cast<const float*>(xb),
           static_cast<const double*>(w1), static_cast<const double*>(b1),
           static_cast<const double*>(w2), static_cast<const double*>(b2),
           static_cast<int64_t*>(out), B, n, C, s, x_max, line_m, line_c,
           res_ptp, res_min};
  auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = shared_bytes_for(C, s);
  return smem <= kSharedLimit ? launch<true>(a, smem, st)
                              : launch<false>(a, 0, st);
}
