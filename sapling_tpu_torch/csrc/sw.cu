// Batched affine-gap local Smith-Waterman pass for Hopper (sm_90a).
//
// Replaces sapling_tpu/ops/sw_pallas.py::_kernel (both its full mode and
// its score_only mode) and computes exactly what it computes: the
// sapling_tpu_torch.ops.sw.sw_pass semantics, bit for bit (SSE pad rows
// up to pad_to, terminate, score2/ref_end2 with second_inclusive).
//
// What bounds it: int32 ALU and warp-shuffle work per DP cell. Each pair
// reads W + R bytes of codes and writes 20 bytes, against W*R cells of
// ~20 integer operations, so device memory traffic is negligible.
//
// Why one warp per (query, ref-window) pair: the column sweep carries H and
// E down the query rows, and the only in-column dependency is the vertical
// gap F. With the decayed-running-max factorization (ops/sw.py docstring)
// F is a prefix max over the rows, which a warp computes with five
// __shfl_up_sync steps and no shared memory or barriers. Each lane owns
// ROWS consecutive query rows in registers (ROWS = ceil(W/32), W <= 1024),
// takes its diagonal input H[j-1] from the lane above with one shuffle, and
// the column maxima are warp reductions. A pair never synchronises with any
// other, so thousands of independent warps keep all SMs busy. The only
// per-pair memory is the row of column maxima score2 needs after the sweep,
// kept in shared memory (R ints per warp).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -(1 << 30);
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// One warp scores one pair. out is [5, B] (full) or [1, B] (score_only):
// score, ref_end, read_end, score2, ref_end2.
template <int ROWS, bool SCORE_ONLY>
__global__ void sw_pass_kernel(const int8_t* __restrict__ query,
                               const int8_t* __restrict__ ref,
                               const int32_t* __restrict__ qlen,
                               const int32_t* __restrict__ rlen,
                               const int32_t* __restrict__ term,
                               int32_t* __restrict__ out, int B, int W, int R,
                               int wpad, int match, int mismatch, int gap_open,
                               int gap_extend, int mask_len, int pad_to,
                               int second_inclusive) {
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pair = blockIdx.x * (blockDim.x >> 5) + warp;
  if (pair >= B) return;  // uniform per warp: every shuffle below is full

  const int ql = qlen[pair];
  const int rl = rlen[pair];
  const int padlen = floor_div(ql + pad_to - 1, pad_to) * pad_to;
  const int row0 = lane * ROWS;
  const int8_t* q = query + (size_t)pair * W;
  const int8_t* rf = ref + (size_t)pair * R;

  int qv[ROWS];
  bool valid[ROWS], live[ROWS];
#pragma unroll
  for (int t = 0; t < ROWS; ++t) {
    const int j = row0 + t;
    const bool exists = j < wpad;  // rows of the pad_to-padded query
    valid[t] = exists && j < ql;
    live[t] = exists && j < padlen;
    qv[t] = (valid[t] && j < W) ? (int)q[j] : 0;
  }

  int h[ROWS], e[ROWS], best_col[ROWS];
#pragma unroll
  for (int t = 0; t < ROWS; ++t) {
    h[t] = 0;
    e[t] = kNeg;
    best_col[t] = 0;
  }
  int best = 0, best_ref = -1, lane_best = 0;
  const int tm = SCORE_ONLY ? 0 : term[pair];
  int32_t* colmax = smem + warp * R;
  const int ncol = min(R, rl);  // columns with i < rlen

  int i = 0;
  for (; i < ncol; ++i) {
    const int rb = (int)rf[i];
    // diagonal input H[j-1] of the previous column
    int up = __shfl_up_sync(kFull, h[ROWS - 1], 1);
    if (lane == 0) up = 0;
    int hn[ROWS];
#pragma unroll
    for (int t = 0; t < ROWS; ++t) {
      const int diag = t == 0 ? up : h[t - 1];
      const int sub =
          valid[t] ? ((qv[t] == rb && qv[t] < 4) ? match : -mismatch) : 0;
      const int v = max(max(diag + sub, e[t]), 0);
      hn[t] = live[t] ? v : 0;
    }
    // F[j] = max_{j' <= j}(a[j'] + ge*j') - ge*j, a[j] = H_nof[j-1] - gapO,
    // a[0] = NEG: a local prefix max, then a warp scan of the lane totals
    int up_hn = __shfl_up_sync(kFull, hn[ROWS - 1], 1);
    int loc[ROWS];
#pragma unroll
    for (int t = 0; t < ROWS; ++t) {
      const int j = row0 + t;
      const int a = t == 0 ? (lane == 0 ? kNeg : up_hn - gap_open)
                           : hn[t - 1] - gap_open;
      const int v = a + gap_extend * j;
      loc[t] = t == 0 ? v : max(loc[t - 1], v);
    }
    int tot = loc[ROWS - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, tot, off);
      if (lane >= off) tot = max(tot, o);
    }
    int carry = __shfl_up_sync(kFull, tot, 1);
    if (lane == 0) carry = kNeg;
    int cm_real = -1, cm_pad = -1;
#pragma unroll
    for (int t = 0; t < ROWS; ++t) {
      const int j = row0 + t;
      const int f = max(loc[t], carry) - gap_extend * j;
      const int hv = live[t] ? max(hn[t], f) : 0;
      e[t] = live[t] ? max(e[t] - gap_extend, hv - gap_open) : kNeg;
      h[t] = hv;
      if (SCORE_ONLY) {
        if (valid[t]) lane_best = max(lane_best, hv);
      } else {
        if (valid[t]) cm_real = max(cm_real, hv);
        if (live[t]) cm_pad = max(cm_pad, hv);
      }
    }
    if (!SCORE_ONLY) {
      cm_real = warp_max(cm_real);
      cm_pad = warp_max(cm_pad);
      if (cm_real > best) {  // earliest column attaining the max
        best = cm_real;
        best_ref = i;
#pragma unroll
        for (int t = 0; t < ROWS; ++t) best_col[t] = h[t];
      }
      if (lane == 0) colmax[i] = cm_pad;
      if (cm_pad == tm) {  // terminate after this column (lane stays frozen)
        ++i;
        break;
      }
    }
  }

  if (SCORE_ONLY) {
    const int s = warp_max(lane_best);
    if (lane == 0) out[pair] = s;
    return;
  }

  // read_end: smallest real row attaining the max in the best column
  int first = kBig;
#pragma unroll
  for (int t = 0; t < ROWS; ++t)
    if (valid[t] && best_col[t] == best) first = min(first, row0 + t);
  first = warp_min(first);
  const int read_end = first < kBig ? first : ql - 1;

  // second best: best column max outside [ref_end-mask, ref_end+mask];
  // columns never swept (beyond rlen or after terminate) count as 0
  __syncwarp();
  const int ncomp = i;
  const int lo_edge = max(best_ref - mask_len, 0);
  const int hi_edge = min(best_ref + mask_len, rl);
  int s2 = kNeg, c2 = kBig;
  for (int c = lane; c < R; c += 32) {
    const bool right_ok = second_inclusive ? c >= hi_edge : c > hi_edge;
    const bool eligible = (c < lo_edge || right_ok) && c < rl;
    const int v = (eligible && c < ncomp) ? colmax[c] : 0;
    if (v > s2) {  // ascending c: keeps each lane's first column at its max
      s2 = v;
      c2 = c;
    }
  }
  const int score2 = R > 0 ? warp_max(s2) : 0;
  const int ref_end2 = warp_min(s2 == score2 ? c2 : kBig);
  if (lane == 0) {
    out[pair] = best;
    out[B + pair] = best_ref;
    out[2 * B + pair] = read_end;
    out[3 * B + pair] = score2;
    out[4 * B + pair] = score2 > 0 ? ref_end2 : 0;
  }
}

template <int ROWS>
int launch_rows(bool score_only, const int8_t* q, const int8_t* r,
                const int32_t* ql, const int32_t* rl, const int32_t* tm,
                int32_t* out, int B, int W, int R, int wpad, int match,
                int mismatch, int gap_open, int gap_extend, int mask_len,
                int pad_to, int second_inclusive, cudaStream_t stream) {
  // 4 warps (pairs) per block unless the column-max rows need less
  int warps = 4;
  size_t smem = 0;
  if (!score_only) {
    while (warps > 1 && (size_t)warps * R * 4 > 48 * 1024) warps >>= 1;
    smem = (size_t)warps * R * 4;
  }
  const int blocks = (B + warps - 1) / warps;
  if (score_only) {
    sw_pass_kernel<ROWS, true><<<blocks, warps * 32, 0, stream>>>(
        q, r, ql, rl, tm, out, B, W, R, wpad, match, mismatch, gap_open,
        gap_extend, mask_len, pad_to, second_inclusive);
  } else {
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          sw_pass_kernel<ROWS, false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    sw_pass_kernel<ROWS, false><<<blocks, warps * 32, smem, stream>>>(
        q, r, ql, rl, tm, out, B, W, R, wpad, match, mismatch, gap_open,
        gap_extend, mask_len, pad_to, second_inclusive);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes). Returns a cudaError_t: 0 = launched.
// -1: wpad > 1024 rows (the wrapper checks shapes before calling).
extern "C" int sw_pass_launch(const void* q, const void* r, const void* ql,
                              const void* rl, const void* tm, void* out, int B,
                              int W, int R, int match, int mismatch,
                              int gap_open, int gap_extend, int mask_len,
                              int pad_to, int second_inclusive, int score_only,
                              void* stream) {
  if (B <= 0) return 0;
  const int wpad = (W + pad_to - 1) / pad_to * pad_to;
  const int rows = (wpad + 31) / 32;
  auto* q8 = static_cast<const int8_t*>(q);
  auto* r8 = static_cast<const int8_t*>(r);
  auto* ql32 = static_cast<const int32_t*>(ql);
  auto* rl32 = static_cast<const int32_t*>(rl);
  auto* tm32 = static_cast<const int32_t*>(tm);
  auto* o32 = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool so = score_only != 0;
#define SW_LAUNCH(N)                                                         \
  return launch_rows<N>(so, q8, r8, ql32, rl32, tm32, o32, B, W, R, wpad,    \
                        match, mismatch, gap_open, gap_extend, mask_len,     \
                        pad_to, second_inclusive, st)
  if (rows <= 1) SW_LAUNCH(1);
  if (rows <= 2) SW_LAUNCH(2);
  if (rows <= 4) SW_LAUNCH(4);
  if (rows <= 8) SW_LAUNCH(8);
  if (rows <= 16) SW_LAUNCH(16);
  if (rows <= 32) SW_LAUNCH(32);
#undef SW_LAUNCH
  return -1;
}
