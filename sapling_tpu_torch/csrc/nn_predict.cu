// The NN predictor's rank prediction for Hopper (sm_90a): persistent
// blocks, each grouping a tile of lanes by chunk before the MLP.
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
// parameters, and the lanes of a warp in the caller's order belong to
// 20-30 random chunks, whose loads collide in shared memory's banks.
//
// The design: persistent blocks stage the parameters once in shared
// memory, each chunk's row of w1, b1 and w2 padded (row_of) so that a
// 16-byte load reads two units and the rows of neighbouring chunks start
// in other banks. A block then takes tiles of kTile consecutive lanes and,
// before the MLP, groups each by chunk: (a) each thread loads its lanes'
// x, all at once, and routes them (x / x_max, and the chunk search, only
// among the boundaries of xs's cell of a kCells table) into registers;
// (b) each lane counts itself in a shared histogram of chunks, whose old
// value gives it its place in its chunk (one atomicAdd for a warp whose
// lanes share a chunk); (c) one warp scans the counts, each rounded up to
// a multiple of kAlign, so that a chunk's run of slots starts at a
// quarter-warp, and marks the padding empty; (d) each lane's xs64 and
// chunk are scattered to their place in chunk order.
// Thread t then takes slots t, t + kThreads, ... of that order, so a
// warp's lanes share a few neighbouring chunks and its parameter loads
// are broadcasts that do not collide; it runs the same per-lane chain
// from the shared xs64 and writes the rank back into the slot, and each
// lane's rank is read from its slot into the caller's order and stored
// coalesced. Which thread computes a lane is all that changes, so every
// rank stays bit-identical. Four barriers a tile: the histogram is
// cleared for the next tile during the MLP. Where the parameters pass
// kSharedLimit bytes the kernel reads them from global memory in their
// own [C][s] layout instead, grouped the same way. Past kBins chunks, a
// bin holds 2^shift neighbouring chunks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 768;                   // lanes a block groups at once
constexpr int kPer = kTile / kThreads;       // lanes a thread routes
constexpr int kBins = 1024;                  // histogram bins, at most
constexpr int kCells = 256;   // the chunk search's table: cells of [0, 1)
constexpr int kAlign = 4;   // a bin's run of slots starts at a multiple
                            // of it, so that quarter-warps share a chunk
constexpr size_t kSharedLimit = 96 * 1024;   // staged parameters, bytes
static_assert(kTile % kThreads == 0 && (kAlign & (kAlign - 1)) == 0,
              "tile, align");

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
  int shift, bins;      // a lane's bin is its chunk >> shift, < bins
  int align, slots;     // a bin's run starts at a multiple of align, in
                        // a tile's slots (kTile + (align - 1) * bins)
  double x_max, line_m, line_c, res_ptp, res_min;
};

// the dynamic shared memory of a block
__device__ __forceinline__ unsigned char* shared_bytes() {
  extern __shared__ __align__(16) unsigned char smem[];
  return smem;
}

// a chunk's row of w1, b1 or w2 in shared memory: s doubles, padded to an
// even count (16-byte pairs) and 2 more, so that neighbouring chunks' rows
// start 4 banks apart
__host__ __device__ inline int row_of(int s) { return (s + 1) / 2 * 2 + 2; }

// the bytes of the staged parameters: w1, b1, w2 as [C][row_of(s)], b2
// [C], xb [C]
size_t shared_bytes_for(int C, int s) {
  return (size_t)C * (3 * row_of(s) + 1) * sizeof(double) +
         (size_t)C * sizeof(float);
}

// A block's shared memory, in bytes from its start: the tile's xs64 in
// chunk order (later its ranks), the staged parameters (SHARED only; at a
// multiple of 16 bytes, for their 16-byte loads), the tile's chunks in
// chunk order (-1: an empty slot), the histogram, the slots the scan
// filled, the chunk search's table, xb (SHARED only).
struct Layout {
  size_t params, chunk, hist, filled, table, xb, total;
};
__host__ __device__ inline Layout layout_for(bool shared, int C, int s,
                                             int bins, int slots) {
  Layout l;
  l.params = ((size_t)slots * sizeof(double) + 15) & ~(size_t)15;
  l.chunk = l.params +
            (shared ? (size_t)C * (3 * row_of(s) + 1) * sizeof(double) : 0);
  l.hist = l.chunk + (size_t)slots * sizeof(int);
  l.filled = l.hist + (size_t)bins * sizeof(int);
  l.table = l.filled + sizeof(int);
  l.xb = l.table + (kCells + 2) * sizeof(int);
  l.total = l.xb + (shared ? (size_t)C * sizeof(float) : 0);
  return l;
}

// The parameters as a lane reads them: element (c, j) of w1, b1 and w2 at
// c * row + j, from shared memory (SHARED: row_of(s)) or through the
// read-only cache (row = s).
template <bool SHARED>
struct Params {
  const float* xb;
  const double *w1, *b1, *w2, *b2;
  int row;

  template <typename T>
  __device__ __forceinline__ T ld(const T* p) const {
    if constexpr (SHARED)
      return *p;
    else
      return __ldg(p);
  }
};

// the count of boundaries xb <= xs among xb[lo, hi), plus lo
template <bool SHARED>
__device__ __forceinline__ int count_le(const Params<SHARED>& p, int lo,
                                        int hi, float xs) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (p.ld(p.xb + mid) <= xs)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// searchsorted(xb, xs, right=True) - 1, clamped to [0, C-1], searched
// only among the boundaries of xs's cell: table[g] counts the boundaries
// <= g / kCells (g <= kCells; table[kCells + 1] = C), and xs * kCells is
// exact, so g / kCells <= xs < (g + 1) / kCells puts the count in
// [table[g], table[g + 1]] (xs >= 1: [table[kCells], C]; below 0 or NaN:
// [0, table[1]])
template <bool SHARED>
__device__ __forceinline__ int chunk_of(const Params<SHARED>& p,
                                        const int* table, float xs) {
  const float cell = xs * kCells;
  const int g = cell >= kCells ? kCells : (cell > 0.0f ? (int)cell : 0);
  const int lo = count_le(p, cell >= 0.0f ? table[g] : 0, table[g + 1], xs);
  return lo == 0 ? 0 : lo - 1;   // lo <= C: c <= C - 1
}

// the rank of a lane routed to xs64 and chunk c; S > 0: s == S
template <bool SHARED, int S>
__device__ __forceinline__ int64_t predict_lane(const NNArgs& a,
                                                const Params<SHARED>& p,
                                                double xs64, int c) {
  const int s = S > 0 ? S : a.s;
  const double xd = (double)__double2float_rn(xs64);
  const int base = c * p.row;
  double res = 0.0;
  // hidden unit j: relu(xd * w1 + b1) * w2, added to res (the first is res)
  auto unit = [&](int j, double w1, double b1, double w2) {
    double h = __dadd_rn(__dmul_rn(xd, w1), b1);
    h = h < 0.0 ? 0.0 : h;
    const double prod = __dmul_rn(h, w2);
    res = j == 0 ? prod : __dadd_rn(res, prod);
  };
  if constexpr (SHARED) {
    // two units a load of 16 bytes
#pragma unroll 8
    for (int j = 0; j < s; j += 2) {
      const double2 w1 = *reinterpret_cast<const double2*>(p.w1 + base + j);
      const double2 b1 = *reinterpret_cast<const double2*>(p.b1 + base + j);
      const double2 w2 = *reinterpret_cast<const double2*>(p.w2 + base + j);
      unit(j, w1.x, b1.x, w2.x);
      if (j + 1 < s) unit(j + 1, w1.y, b1.y, w2.y);
    }
  } else {
#pragma unroll 16
    for (int j = 0; j < s; ++j)
      unit(j, __ldg(p.w1 + base + j), __ldg(p.b1 + base + j),
           __ldg(p.w2 + base + j));
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

template <bool SHARED, int S>
__global__ void __launch_bounds__(kThreads)
    nn_predict_kernel(const __grid_constant__ NNArgs a) {
  const int C = a.C, s = a.s, tid = threadIdx.x, lane = tid & 31;
  const Layout l = layout_for(SHARED, C, s, a.bins, a.slots);
  unsigned char* sm = shared_bytes();
  double* tile_xs = reinterpret_cast<double*>(sm);
  int64_t* tile_rank = reinterpret_cast<int64_t*>(sm);   // after the MLP
  int* tile_c = reinterpret_cast<int*>(sm + l.chunk);
  int* hist = reinterpret_cast<int*>(sm + l.hist);
  int* filled = reinterpret_cast<int*>(sm + l.filled);
  int* table = reinterpret_cast<int*>(sm + l.table);

  Params<SHARED> p;
  if constexpr (SHARED) {
    const int row = row_of(s);
    double* w1 = reinterpret_cast<double*>(sm + l.params);
    double* b1 = w1 + row * C;
    double* w2 = b1 + row * C;
    double* b2 = w2 + row * C;
    float* xb = reinterpret_cast<float*>(sm + l.xb);
    for (int i = tid; i < C * s; i += kThreads) {
      const int c = i / s, at = c * row + (i - c * s);
      w1[at] = __ldg(a.w1 + i);
      b1[at] = __ldg(a.b1 + i);
      w2[at] = __ldg(a.w2 + i);
    }
    for (int c = tid; c < C; c += kThreads) {
      b2[c] = __ldg(a.b2 + c);
      xb[c] = __ldg(a.xb + c);
    }
    p = Params<SHARED>{xb, w1, b1, w2, b2, row};
  } else {
    p = Params<SHARED>{a.xb, a.w1, a.b1, a.w2, a.b2, s};
  }
  __syncthreads();
  for (int g = tid; g <= kCells + 1; g += kThreads)
    table[g] = g > kCells ? C : count_le(p, 0, C, (float)g / kCells);
  for (int b = tid; b < a.bins; b += kThreads) hist[b] = 0;
  __syncthreads();

  const int64_t tiles = (a.B + kTile - 1) / kTile;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t first = t * kTile;
    const int in_tile =
        a.B - first < kTile ? (int)(a.B - first) : kTile;

    // (a) route this thread's lanes, every load issued before the first
    // is used (the lanes past the tile route x = 0), (b) count them by
    // bin: a lane's place in its bin is what its atomicAdd found there,
    // or, where the warp's lanes share one bin (sorted x), the warp's one
    // atomicAdd plus the lane's rank
    int64_t x[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      x[k] = k * kThreads + tid < in_tile ? a.x[first + k * kThreads + tid]
                                          : 0;
    double xs64[kPer];
    int chunk[kPer], place[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      xs64[k] = __ddiv_rn((double)x[k], a.x_max);
      chunk[k] = chunk_of(p, table, __double2float_rn(xs64[k]));
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int bin =
          k * kThreads + tid < in_tile ? chunk[k] >> a.shift : -1;
      if (__all_sync(0xffffffffu, bin == __shfl_sync(0xffffffffu, bin, 0))) {
        const int at = bin >= 0 && lane == 0 ? atomicAdd(hist + bin, 32) : 0;
        place[k] = __shfl_sync(0xffffffffu, at, 0) + lane;
      } else {
        place[k] = bin >= 0 ? atomicAdd(hist + bin, 1) : 0;
      }
    }
    __syncthreads();

    // (c) one warp scans the bins' counts, each rounded up to a multiple
    // of align, into each bin's first slot (a lane's run of bins, then
    // across the warp), marks the slots that pad a bin empty, and keeps
    // the slots filled
    if (tid < 32) {
      const int round_up = -a.align;
      const int per = (a.bins + 31) / 32;
      const int lo = lane * per < a.bins ? lane * per : a.bins;
      const int hi = lo + per < a.bins ? lo + per : a.bins;
      int sum = 0;
      for (int b = lo; b < hi; ++b)
        sum += (hist[b] + a.align - 1) & round_up;
      int run = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, run, d);
        if (lane >= d) run += v;
      }
      run -= sum;
      for (int b = lo; b < hi; ++b) {
        const int count = hist[b], next = run + ((count + a.align - 1) &
                                                 round_up);
        hist[b] = run;
        for (int i = run + count; i < next; ++i) tile_c[i] = -1;
        run = next;
      }
      if (lane == 31) *filled = run;
    }
    __syncthreads();

    // (d) scatter each lane to its slot in bin order
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k * kThreads + tid < in_tile) {
        place[k] += hist[chunk[k] >> a.shift];
        tile_xs[place[k]] = xs64[k];
        tile_c[place[k]] = chunk[k];
      }
    }
    __syncthreads();

    // the MLP in bin order; a slot's rank replaces its xs64. The
    // histogram is cleared for the next tile meanwhile.
    for (int b = tid; b < a.bins; b += kThreads) hist[b] = 0;
#pragma unroll 1
    for (int i = tid; i < *filled; i += kThreads) {
      const int c = tile_c[i];
      if (c >= 0) tile_rank[i] = predict_lane<SHARED, S>(a, p, tile_xs[i], c);
    }
    __syncthreads();

    // each lane's rank back in the caller's order, stored coalesced
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = k * kThreads + tid;
      if (i < in_tile) a.out[first + i] = tile_rank[place[k]];
    }
  }
}

// nn_predict_kernel<SHARED, S> on no more blocks than fit on the card at
// once (each stages the parameters once and loops over the tiles). The
// blocks an SM holds are found on a device's first call with a shared
// size, where the kernel is also allowed that shared memory, and kept for
// the next call with that size.
template <bool SHARED, int S>
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
      e = cudaFuncSetAttribute(nn_predict_kernel<SHARED, S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, nn_predict_kernel<SHARED, S>, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    held = (uint64_t)smem << 32 | (uint32_t)(per_sm * sms);
    resident[dev].store(held, std::memory_order_relaxed);
  }
  int64_t grid = (uint32_t)held;
  const int64_t needed = (a.B + kTile - 1) / kTile;
  if (needed < grid) grid = needed;
  nn_predict_kernel<SHARED, S><<<(int)grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool SHARED>
int launch_width(const NNArgs& a, cudaStream_t stream) {
  const size_t smem = layout_for(SHARED, a.C, a.s, a.bins, a.slots).total;
  return a.s == 16 ? launch<SHARED, 16>(a, smem, stream)
                   : launch<SHARED, 0>(a, smem, stream);
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
  if (C < 1 || s < 1 || (int64_t)C * s > INT32_MAX / 2)
    return (int)cudaErrorInvalidValue;
  int shift = 0;
  while (((C - 1) >> shift) >= kBins) ++shift;
  const int bins = ((C - 1) >> shift) + 1;
  // padding to align takes at most twice a tile's slots
  int align = kAlign;
  while (align > 1 && (align - 1) * bins > 2 * kTile) align >>= 1;
  NNArgs a{static_cast<const int64_t*>(x), static_cast<const float*>(xb),
           static_cast<const double*>(w1), static_cast<const double*>(b1),
           static_cast<const double*>(w2), static_cast<const double*>(b2),
           static_cast<int64_t*>(out), B, n, C, s, shift, bins, align,
           kTile + (align - 1) * bins, x_max, line_m, line_c, res_ptp,
           res_min};
  auto st = static_cast<cudaStream_t>(stream);
  return shared_bytes_for(C, s) <= kSharedLimit ? launch_width<true>(a, st)
                                                : launch_width<false>(a, st);
}
