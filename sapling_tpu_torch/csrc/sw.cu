// Batched affine-gap local Smith-Waterman passes for Hopper (sm_90a).
//
// Replace sapling_tpu/ops/sw_pallas.py::_kernel and compute exactly what it
// computes, the sapling_tpu_torch.ops.sw.sw_pass semantics, bit for bit:
//
//   sw_pass_kernel<ROWS>   its full mode (:36): score, ref_end, read_end,
//                          score2/ref_end2 (second_inclusive), SSE pad rows
//                          up to pad_to, terminate;
//   sw_score_kernel<G, S>  its score_only mode (:81): the max of H over the
//                          real cells only.
//
// What bounds both: int32 instructions per DP cell. A pair reads W + R bytes
// of codes and writes 4 or 20 bytes against qlen*rlen cells, so device
// memory traffic is negligible. The recurrence needs 6.5 int32 instructions
// a cell: the substitution (one byte-permute lookup at best), an add-max
// with ReLU and a max for H, H - gapO, one add-max each for E and F, and
// half a 3-way max for the running max. All but the subtract, which can
// issue as an IMAD on the FMA pipe, take the int32 ALU (64 lanes an SM a
// clock; an SM issues 128), so the least time of a pass is
//   sum(qlen * rlen) * 5.5 / (132 SMs * 64 int32 lanes * SM clock),
// about 49 us for 16,384 pairs of ~85 x ~108 cells at 1.98 GHz.
//
// Full mode, one warp per (query, ref-window) pair: the column sweep carries
// H and E down the query rows, and the only in-column dependency is the
// vertical gap F. With the decayed-running-max factorization (ops/sw.py
// docstring) F is a prefix max over the rows, which a warp computes with five
// __shfl_up_sync steps and no shared memory or barriers. Each lane owns ROWS
// consecutive query rows in registers (ROWS = ceil(W/32), W <= 1024), takes
// its diagonal input H[j-1] from the lane above with one shuffle, and the
// column maxima are warp reductions. The only per-pair memory is the row of
// column maxima score2 needs after the sweep, kept in shared memory (R ints
// per warp). Every column costs ~8 shuffles and work on all 32*ROWS rows.
//
// Score-only mode, a row-strip wavefront: its one output, max H over the
// real cells, is fixed by the recurrence, so any order of evaluation gives
// it bit for bit. A group of G lanes (a power of two <= 32) scores one pair;
// lane g owns the S rows [g*S, g*S + S) in registers (H, E, the query code
// and the running max of each row, G*S >= the padded rows) and computes
// column s - g at step s. At the end of a step it hands lane g + 1 its
// bottom row's H, the F into lane g + 1's first row, and the ref base of
// its column: three __shfl_up_sync of width G. Lane g + 1 keeps that H as
// the diagonal input of its next column. Only lane 0 reads the ref (a byte
// a step, loaded a step ahead), so there is no shared memory and no limit on
// R. A lane outside [0, rlen) in its column skips the update; the step count
// is the warp's largest rlen + G - 1, rounded up to even. Only real cells
// count: pad rows lie below every real row, and F and the diagonal flow
// downwards, so they never reach one; pad_to does not change the result
// (rows past W count as code 0 up to the padded width when qlen > W, as in
// sw_pass).
//
// F is the plain recurrence F[j] = max(F[j-1] - gapE, H[j-1] - gapO), with
// F into row 0 at kNeg, the diagonal into row 0 at 0, and H = 0, E = kNeg
// in column -1. It equals sw_pass's decayed running max, which uses H_nof =
// max(diag + sub, E, 0) in place of H: H[j-1] = max(H_nof[j-1], F[j-1]),
// and when H[j-1] came from F, H[j-1] - gapO = F[j-1] - gapO <=
// F[j-1] - gapE because gapO >= gapE (the wrapper enforces it), so the F
// term never wins there. Each cell is then the substitution's compare and
// select, max(diag + sub, E, 0) (an add and a 3-way max with ReLU, which
// sm_90 fuses into one VIADDMNMX.RELU), a max with F for H, one subtract
// (H - gapO, shared by E and F), two __viaddmax_s32 (E, F) and half a
// __vimax3_s32 (the running max takes two columns at once): 7.5 int32
// instructions, all 32-bit (16-bit lanes would need saturating kNeg
// arithmetic to stay exact). A column first computes the F-free part of
// every row from the last column's H, then runs the F chain down the
// strip, so no cell spends a move on keeping the diagonal.

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

// One warp scores one pair. out is [5, B]: score, ref_end, read_end,
// score2, ref_end2.
template <int ROWS>
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
  int best = 0, best_ref = -1;
  const int tm = term[pair];
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
      if (valid[t]) cm_real = max(cm_real, hv);
      if (live[t]) cm_pad = max(cm_pad, hv);
    }
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
int launch_rows(const int8_t* q, const int8_t* r, const int32_t* ql,
                const int32_t* rl, const int32_t* tm, int32_t* out, int B,
                int W, int R, int wpad, int match, int mismatch, int gap_open,
                int gap_extend, int mask_len, int pad_to,
                int second_inclusive, cudaStream_t stream) {
  // 4 warps (pairs) per block unless the column-max rows need less
  int warps = 4;
  while (warps > 1 && (size_t)warps * R * 4 > 48 * 1024) warps >>= 1;
  const size_t smem = (size_t)warps * R * 4;
  const int blocks = (B + warps - 1) / warps;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sw_pass_kernel<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sw_pass_kernel<ROWS><<<blocks, warps * 32, smem, stream>>>(
      q, r, ql, rl, tm, out, B, W, R, wpad, match, mismatch, gap_open,
      gap_extend, mask_len, pad_to, second_inclusive);
  return (int)cudaGetLastError();
}

// ---- score-only: the row-strip wavefront ---------------------------------

constexpr int kScoreThreads = 128;
constexpr int kNoRef = 1000;     // a ref code >= 4 (N): matches no row
constexpr int kNoQuery = 2000;   // the code of a row past qlen

// G lanes score one pair; out is [1, B].
template <int G, int S>
__global__ void __launch_bounds__(kScoreThreads)
    sw_score_kernel(const int8_t* __restrict__ query,
                    const int8_t* __restrict__ ref,
                    const int32_t* __restrict__ qlen,
                    const int32_t* __restrict__ rlen,
                    int32_t* __restrict__ out, int B, int W, int R, int wpad,
                    int match, int mismatch, int gap_open, int gap_extend) {
  const int g = threadIdx.x & (G - 1);
  const int pair = (blockIdx.x * kScoreThreads + threadIdx.x) / G;
  const bool real = pair < B;  // the last warp's spare groups still shuffle
  const int nrows = real ? min(max(qlen[pair], 0), wpad) : 0;
  const int ncol = real ? min(max(rlen[pair], 0), R) : 0;
  const int row0 = g * S;
  const int8_t* q = query + (size_t)pair * W;
  const int8_t* rf = ref + (size_t)pair * R;
  const int nge = -gap_extend;

  // per row: query code, H and E of the last column, running max of H
  int qv[S], h[S], e[S], mx[S];
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const int j = row0 + t;
    qv[t] = j < nrows ? (j < W ? (int)q[j] : 0) : kNoQuery;
    h[t] = 0;
    e[t] = kNeg;
    mx[t] = 0;
  }

  const int nstep = __reduce_max_sync(kFull, ncol > 0 ? ncol + G - 1 : 0);
  // from lane g - 1 at the end of the last step, for this step's column:
  // H of the row above, F into row0, the ref base; and H of the row above
  // in the previous column (this column's diagonal)
  int h_in = 0, f_in = kNeg, rb_in = kNoRef, diag_top = 0;
  int rb_next = kNoRef;
  if (g == 0 && ncol > 0) rb_next = rf[0] < 4 ? (int)rf[0] : kNoRef;
  // steps in pairs: the second of a pair folds both columns' H into the
  // running max (an odd count adds a step past every lane's last column)
  for (int s0 = 0; s0 < nstep; s0 += 2) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int s = s0 + k;
      const int c = s - g;
      int rb = rb_in, f = f_in, diag = diag_top;
      if (g == 0) {  // row 0: diagonal 0, F kNeg; the ref from memory
        rb = rb_next;
        f = kNeg;
        diag = 0;
        if (s + 1 < ncol) {
          const int v = rf[s + 1];
          rb_next = v < 4 ? v : kNoRef;
        }
      }
      diag_top = h_in;
      if (c >= 0 && c < ncol) {
        // first the part of each row's H that F does not reach, from the
        // last column's H before any row is overwritten (no register
        // moves), then the F chain down the strip
        int hn[S];
#pragma unroll
        for (int t = 0; t < S; ++t) {
          const int sub = qv[t] == rb ? match : -mismatch;
          hn[t] = __vimax_s32_relu(diag + sub, e[t]);
          diag = h[t];
        }
#pragma unroll
        for (int t = 0; t < S; ++t) {
          const int hv = max(hn[t], f);
          const int te = hv - gap_open;
          f = __viaddmax_s32(f, nge, te);
          e[t] = __viaddmax_s32(e[t], nge, te);
          if (k == 1) mx[t] = __vimax3_s32(mx[t], h[t], hv);
          h[t] = hv;
        }
      } else if (k == 1) {  // the first step's column, if it had one
#pragma unroll
        for (int t = 0; t < S; ++t) mx[t] = max(mx[t], h[t]);
      }
      if (G > 1) {
        h_in = __shfl_up_sync(kFull, h[S - 1], 1, G);
        f_in = __shfl_up_sync(kFull, f, 1, G);
        rb_in = __shfl_up_sync(kFull, rb, 1, G);
      }
    }
  }

  int best = 0;
#pragma unroll
  for (int t = 0; t < S; ++t)
    if (row0 + t < nrows) best = max(best, mx[t]);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    best = max(best, __shfl_xor_sync(kFull, best, off));
  if (g == 0 && real) out[pair] = best;
}

struct ScoreArgs {
  const int8_t* q;
  const int8_t* r;
  const int32_t* ql;
  const int32_t* rl;
  int32_t* out;
  int B, W, R, wpad, match, mismatch, gap_open, gap_extend;
  cudaStream_t stream;
};

template <int G, int S>
int launch_score(const ScoreArgs& a) {
  const long long threads = (long long)a.B * G;
  const int blocks = (int)((threads + kScoreThreads - 1) / kScoreThreads);
  sw_score_kernel<G, S><<<blocks, kScoreThreads, 0, a.stream>>>(
      a.q, a.r, a.ql, a.rl, a.out, a.B, a.W, a.R, a.wpad, a.match,
      a.mismatch, a.gap_open, a.gap_extend);
  return (int)cudaGetLastError();
}

// the instantiation with S == s among S = S0, S0 + 2, ..., SMAX
template <int G, int S, int SMAX>
int launch_score_s(int s, const ScoreArgs& a) {
  if constexpr (S > SMAX) {
    return -1;
  } else {
    if (s == S) return launch_score<G, S>(a);
    return launch_score_s<G, S + 2, SMAX>(s, a);
  }
}

// G: the smallest power of two (at most 32) with G * 16 >= wpad rows; S:
// the rows a lane then needs, rounded up to even (G = 1: 2..16; G = 2..16:
// 10..16; G = 32: 10..32, W <= 1024).
int launch_score_only(const ScoreArgs& a) {
  int g = 1;
  while (g < 32 && g * 16 < a.wpad) g *= 2;
  int s = max((a.wpad + g - 1) / g, 1);
  s += s & 1;
  switch (g) {
    case 1: return launch_score_s<1, 2, 16>(s, a);
    case 2: return launch_score_s<2, 10, 16>(s, a);
    case 4: return launch_score_s<4, 10, 16>(s, a);
    case 8: return launch_score_s<8, 10, 16>(s, a);
    case 16: return launch_score_s<16, 10, 16>(s, a);
    default: return launch_score_s<32, 10, 32>(s, a);
  }
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
  auto* q8 = static_cast<const int8_t*>(q);
  auto* r8 = static_cast<const int8_t*>(r);
  auto* ql32 = static_cast<const int32_t*>(ql);
  auto* rl32 = static_cast<const int32_t*>(rl);
  auto* o32 = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (score_only) {
    if (wpad > 1024) return -1;
    return launch_score_only({q8, r8, ql32, rl32, o32, B, W, R, wpad, match,
                              mismatch, gap_open, gap_extend, st});
  }
  const int rows = (wpad + 31) / 32;
  auto* tm32 = static_cast<const int32_t*>(tm);
#define SW_LAUNCH(N)                                                         \
  return launch_rows<N>(q8, r8, ql32, rl32, tm32, o32, B, W, R, wpad, match, \
                        mismatch, gap_open, gap_extend, mask_len, pad_to,    \
                        second_inclusive, st)
  if (rows <= 1) SW_LAUNCH(1);
  if (rows <= 2) SW_LAUNCH(2);
  if (rows <= 4) SW_LAUNCH(4);
  if (rows <= 8) SW_LAUNCH(8);
  if (rows <= 16) SW_LAUNCH(16);
  if (rows <= 32) SW_LAUNCH(32);
#undef SW_LAUNCH
  return -1;
}
