// Batched affine-gap local Smith-Waterman passes for Hopper (sm_90a).
//
// Replace sapling_tpu/ops/sw_pallas.py::_kernel and compute exactly what it
// computes, the sapling_tpu_torch.ops.sw.sw_pass semantics, bit for bit.
// One kernel template, sw_kernel<G, S, FULL>, in two modes:
//
//   FULL = false  its score_only mode (:81): the max of H over the real
//                 cells only;
//   FULL = true   its full mode (:36): score, ref_end, read_end and
//                 score2/ref_end2 (second_inclusive), SSE pad rows up to
//                 pad_to, terminate.
//
// What bounds both: int32 instructions per DP cell. A pair reads W + R bytes
// of codes and writes 4 or 20 bytes against qlen*rlen cells, so device
// memory traffic is small (the full mode's column records below add 12
// bytes a column a pair, which stay in the L2 at aligner sizes). The
// recurrence needs 6.5 int32 instructions a cell: the substitution (one
// byte-permute lookup at best), an add-max with ReLU and a max for H,
// H - gapO, one add-max each for E and F, and half a 3-way max for the
// running max. All but the subtract, which can issue as an IMAD on the FMA
// pipe, take the int32 ALU (64 lanes an SM a clock; an SM issues 128), so
// the least time of a pass is
//   sum(qlen * rlen) * 5.5 / (132 SMs * 64 int32 lanes * SM clock),
// about 49 us for 16,384 pairs of ~85 x ~108 cells at 1.98 GHz.
//
// The design, a row-strip wavefront. A group of G lanes (a power of two
// <= 32) sweeps one pair; lane g owns the S rows [g*S, g*S + S) of a tile
// of G*S <= 1024 rows in registers (H, E and the query code of each row)
// and computes column s - g at step s. At the end of a step it hands lane
// g + 1 its bottom row's H, the F into lane g + 1's first row, and the ref
// base of its column: three __shfl_up_sync of width G. Lane g + 1 keeps
// that H as the diagonal input of its next column. Only lane 0 reads the
// ref (a byte a step, loaded a step ahead), so there is no shared memory
// and no limit on R. A lane outside [0, rlen) in its column skips the
// update; the step count is the warp's largest rlen + G - 1, rounded up to
// even.
//
// Row tiles: a pair with more rows than G*S (at G = 32, S = 32: past 1,024
// rows) sweeps tile after tile, each over every column. The last lane of
// tile t writes, for each column, its bottom row's H and the F into the
// next row to a boundary buffer in device memory; lane 0 of tile t + 1
// reads them (a step ahead) in place of the 0 diagonal and kNeg F of row 0.
// Two buffers alternate, so a tile never reads the buffer it writes. A
// pair's tile count comes from its own rows, so the short pairs of a batch
// that holds one long one sweep one tile.
//
// Score-only: its one output, max H over the real cells, is fixed by the
// recurrence, so any order of evaluation gives it bit for bit. Each row
// keeps a running max of H, and each tile's real rows fold into the
// result. Pad rows lie below every real row, and F and the diagonal flow
// downwards, so they never reach one; pad_to does not change the result.
//
// Full mode: every output depends on the order of the columns (ref_end is
// the earliest column at the max, read_end the smallest row in it,
// terminate stops after a column, score2 reads every column's max), and
// the lanes reach a column at different steps. So the sweep decides none
// of them. It records each column's totals, and the order is resolved
// after it:
//   * the column chain: beside H and F, lane g hands lane g + 1 two partial
//     maxima of its column: the real rows' max as a key
//     hv * 1024 + (1023 - row in the tile), whose max also picks the
//     smallest row at the max, and the max over the live (real + pad)
//     rows. Lane G - 1 then holds the column's totals and writes them as
//     its record in a workspace: the key [R, B], then tile and pad max
//     [2, R, B] int32. A later tile's record replaces the key only when its
//     max is larger, so on a tie the earlier tile and its smaller row
//     stay. An int32 key needs H < 2^20 (a row past the real ones keys
//     below every real row's key by kNeg); a pass whose H could reach it
//     (a high match score over long pairs) takes the instantiation with an
//     int64 key, at the one strip shape G = S = 32, in row tiles.
//   * pad rows in [qlen, ceil(qlen / pad_to) * pad_to) take substitution
//     0: each row carries its own mismatch constant (-mismatch, or 0) and
//     key constant, so the substitution stays one select a cell; rows past
//     the pad are masked out of both maxima.
//   * the epilogue, after a __syncwarp, reads the records with sw_pass's
//     rules: the terminate column tc is the first column whose pad max
//     equals term, and later columns count neither for the score nor for
//     score2 (they were computed all the same, so no lane is frozen or
//     rolled back); score and ref_end take the strict-greater update from
//     0 and -1; read_end is the key's row; score2 / ref_end2 are the best
//     pad max outside +-mask_len of ref_end, earliest column on ties.
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
// __vimax3_s32 (the score-only running max takes two columns at once; the
// full mode's two column maxima take an IMAD, a max and an add-max a row
// instead): 7.5 int32 instructions, all 32-bit (16-bit lanes would need
// saturating kNeg arithmetic to stay exact). A column first computes the
// F-free part of every row from the last column's H, then runs the F chain
// down the strip, so no cell spends a move on keeping the diagonal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -(1 << 30);
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kNoRef = 1000;     // a ref code >= 4 (N): matches no row
constexpr int kNoQuery = 2000;   // the code of a row past qlen
constexpr int kRowBits = 10;     // a row's place in a tile of <= 1,024 rows
constexpr int kRowMask = (1 << kRowBits) - 1;

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

template <int G>
__device__ __forceinline__ int group_max(int v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

template <int G>
__device__ __forceinline__ int group_min(int v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

struct Pass {
  const int8_t* q;      // [B, W] query codes
  const int8_t* r;      // [B, R] ref codes
  const int32_t* ql;    // [B]
  const int32_t* rl;    // [B]
  const int32_t* tm;    // [B] terminate (full mode)
  int32_t* out;         // [1 or 5, B]
  int32_t* ws;          // full mode: records [3, R, B]; then, past 1,024
                        // rows, the tile boundaries [2 buffers, 2, R, B]
  int B, W, R, wpad, match, mismatch, gap_open, gap_extend, mask_len, pad_to,
      second_inclusive;
};

// G lanes sweep one pair; out is [1, B] (score-only) or [5, B]: score,
// ref_end, read_end, score2, ref_end2.
template <typename Key>
constexpr Key kKeyNeg = (Key)kNeg * ((Key)1 << (8 * sizeof(Key) - 32));

template <int G, int S, bool FULL, typename Key = int>
__global__ void __launch_bounds__(kThreads) sw_kernel(const Pass p) {
  constexpr int kRows = G * S;   // rows of a tile
  // only the widest strip (G = 32, S = 32) is ever given more rows than
  // one tile; the other shapes compile without the boundary code
  constexpr bool kTiled = kRows == 32 * 32;
  const int g = threadIdx.x & (G - 1);
  const int pair = (blockIdx.x * kThreads + threadIdx.x) / G;
  const bool real = pair < p.B;  // the last warp's spare groups still shuffle
  const int ql = real ? p.ql[pair] : 0;
  const int nreal = min(max(ql, 0), p.wpad);
  // rows swept: the real ones, and in full mode the SSE pad rows too
  const int nrows =
      FULL ? min(max(floor_div(ql + p.pad_to - 1, p.pad_to) * p.pad_to, 0),
                 p.wpad)
           : nreal;
  const int ncol = real ? min(max(p.rl[pair], 0), p.R) : 0;
  // the full mode records every column, even of a pair with no rows
  const int ntile =
      ncol > 0 ? max((nrows + kRows - 1) / kRows, FULL ? 1 : 0) : 0;
  const int row0 = g * S;
  const int8_t* q = p.q + (size_t)pair * p.W;
  const int8_t* rf = p.r + (size_t)pair * p.R;
  const int nge = -p.gap_extend;
  const size_t RB = (size_t)p.R * p.B;
  constexpr int kKeyInts = sizeof(Key) / 4;
  Key* key_rec = reinterpret_cast<Key*>(p.ws);  // [R, B]
  int32_t* rec = p.ws + kKeyInts * RB;          // tile, pad max [2, R, B]
  int32_t* bnd = p.ws + (FULL ? (kKeyInts + 2) * RB : 0);  // [2, 2, R, B]

  int best = 0;  // score-only: max H over the real rows of every tile
  const int ntile_w = kTiled ? __reduce_max_sync(kFull, ntile) : 1;
  for (int tile = 0; tile < ntile_w; ++tile) {
    const int tcol = tile < ntile ? ncol : 0;
    const int rb0 = tile * kRows + row0;  // this lane's first row
    // per row: query code, H and E of the last column, and the running max
    // of H (score-only) or the mismatch, key and live-mask constants (full)
    int qv[S], h[S], e[S], mx[S], xs[S], pc[S];
    Key kc[S];
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int j = rb0 + t;
      qv[t] = j < nreal ? (j < p.W ? (int)q[j] : 0) : kNoQuery;
      h[t] = 0;
      e[t] = kNeg;
      if constexpr (FULL) {
        xs[t] = j < nreal ? -p.mismatch : 0;         // pad rows score 0
        kc[t] = j < nreal ? (Key)(kRowMask - (row0 + t)) : kKeyNeg<Key>;
        pc[t] = j < nrows ? 0 : kNeg;
      } else {
        mx[t] = 0;
      }
    }
    // the boundary above this tile (read by lane 0) and below it (written
    // by lane G - 1): [2, R, B] each, H then F
    const bool above = kTiled && tile > 0;
    const bool below = kTiled && tile + 1 < ntile;
    const int32_t* bin = bnd + (size_t)((tile + 1) & 1) * 2 * RB;
    int32_t* bout = bnd + (size_t)(tile & 1) * 2 * RB;

    const int nstep = __reduce_max_sync(kFull, tcol > 0 ? tcol + G - 1 : 0);
    // from lane g - 1 at the end of the last step, for this step's column:
    // H of the row above, F into row0, the ref base, and (full) the partial
    // column maxima; and H of the row above in the previous column (this
    // column's diagonal)
    int h_in = 0, f_in = kNeg, rb_in = kNoRef, diag_top = 0, pad_in = -1;
    Key key_in = kKeyNeg<Key>;
    // lane 0's inputs of the next step: ref base, and the tile above's
    // bottom H of this column (the next column's diagonal) and F into row 0
    int rb_next = kNoRef, hb_next = 0, fb_next = kNeg;
    if (g == 0 && tcol > 0) {
      rb_next = rf[0] < 4 ? (int)rf[0] : kNoRef;
      if (above) fb_next = bin[RB + pair];
    }
    // steps in pairs: the second of a pair folds both columns' H into the
    // running max (an odd count adds a step past every lane's last column)
    for (int s0 = 0; s0 < nstep; s0 += 2) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int s = s0 + k;
        const int c = s - g;
        int rb = rb_in, f = f_in, diag = diag_top, pad = pad_in;
        Key key = key_in;
        if (g == 0) {  // row 0 of the tile: its inputs from memory
          rb = rb_next;
          f = fb_next;
          diag = hb_next;
          key = kKeyNeg<Key>;
          pad = -1;
          if (s + 1 < tcol) {
            const int v = rf[s + 1];
            rb_next = v < 4 ? v : kNoRef;
            if (above) fb_next = bin[RB + (size_t)(s + 1) * p.B + pair];
          }
          if (above && s < tcol) hb_next = bin[(size_t)s * p.B + pair];
        }
        diag_top = h_in;
        if (c >= 0 && c < tcol) {
          // first the part of each row's H that F does not reach, from the
          // last column's H before any row is overwritten (no register
          // moves), then the F chain down the strip
          int hn[S];
#pragma unroll
          for (int t = 0; t < S; ++t) {
            const int sub =
                qv[t] == rb ? p.match : (FULL ? xs[t] : -p.mismatch);
            hn[t] = __vimax_s32_relu(diag + sub, e[t]);
            diag = h[t];
          }
#pragma unroll
          for (int t = 0; t < S; ++t) {
            const int hv = max(hn[t], f);
            const int te = hv - p.gap_open;
            f = __viaddmax_s32(f, nge, te);
            e[t] = __viaddmax_s32(e[t], nge, te);
            if constexpr (FULL) {
              key = max(key, (Key)hv * (1 << kRowBits) + kc[t]);
              pad = __viaddmax_s32(hv, pc[t], pad);
            } else if (k == 1) {
              mx[t] = __vimax3_s32(mx[t], h[t], hv);
            }
            h[t] = hv;
          }
          if (g == G - 1) {
            const size_t at = (size_t)c * p.B + pair;
            if constexpr (FULL) {  // the column's record
              if (tile == 0) {
                key_rec[at] = key;
                rec[at] = 0;
                rec[RB + at] = pad;
              } else {
                if ((key >> kRowBits) > (key_rec[at] >> kRowBits)) {
                  key_rec[at] = key;
                  rec[at] = tile;
                }
                rec[RB + at] = max(rec[RB + at], pad);
              }
            }
            if (below) {
              bout[at] = h[S - 1];
              bout[RB + at] = f;
            }
          }
        } else if (!FULL && k == 1) {  // the first step's column, if it had one
#pragma unroll
          for (int t = 0; t < S; ++t) mx[t] = max(mx[t], h[t]);
        }
        if (G > 1) {
          h_in = __shfl_up_sync(kFull, h[S - 1], 1, G);
          f_in = __shfl_up_sync(kFull, f, 1, G);
          rb_in = __shfl_up_sync(kFull, rb, 1, G);
          if constexpr (FULL) {
            key_in = __shfl_up_sync(kFull, key, 1, G);
            pad_in = __shfl_up_sync(kFull, pad, 1, G);
          }
        }
      }
    }
    if constexpr (!FULL) {
#pragma unroll
      for (int t = 0; t < S; ++t)
        if (rb0 + t < nreal) best = max(best, mx[t]);
    }
    __syncwarp();  // the tile's boundary and records, before they are read
  }

  if constexpr (!FULL) {
    best = group_max<G>(best);
    if (g == 0 && real) p.out[pair] = best;
  } else {
    const Key* keys = key_rec + pair;
    const int32_t* tile_rec = rec + pair;
    const int32_t* pad_rec = rec + RB + pair;
    // terminate: the first column whose pad max equals term
    const int term = real ? p.tm[pair] : -1;
    int tc = ncol;
    for (int c = g; c < ncol; c += G)
      if (pad_rec[(size_t)c * p.B] == term) {
        tc = c;
        break;
      }
    const int ncomp = min(group_min<G>(tc) + 1, ncol);  // columns that count
    // score / ref_end: the strict-greater update from 0 / -1 in column
    // order, i.e. the earliest column at the max
    int bv = 0, bc = kBig;
    for (int c = g; c < ncomp; c += G) {
      const Key v = keys[(size_t)c * p.B] >> kRowBits;  // < 0: no real row
      if (v > bv) {
        bv = (int)v;
        bc = c;
      }
    }
    const int score = group_max<G>(bv);
    const int first = group_min<G>(bv == score && score > 0 ? bc : kBig);
    const int ref_end = score > 0 ? first : -1;
    int read_end = nreal > 0 ? 0 : ql - 1;
    if (ref_end >= 0) {
      const size_t at = (size_t)ref_end * p.B;
      read_end = tile_rec[at] * kRows + kRowMask -
                 (int)(keys[at] & kRowMask);
    }
    // score2 / ref_end2: the best column max outside [ref_end - mask,
    // ref_end + mask]; columns past tc (and past rlen) count as 0
    const int lo_edge = max(ref_end - p.mask_len, 0);
    const int hi_edge = real ? min(ref_end + p.mask_len, p.rl[pair]) : 0;
    int s2 = kNeg, c2 = kBig;
    for (int c = g; c < ncomp; c += G) {
      const bool right_ok = p.second_inclusive ? c >= hi_edge : c > hi_edge;
      const int v = (c < lo_edge || right_ok) ? pad_rec[(size_t)c * p.B] : 0;
      if (v > s2) {  // ascending c: keeps each lane's first column at its max
        s2 = v;
        c2 = c;
      }
    }
    if (g == 0 && ncomp < p.R && s2 < 0) {  // the first column that is 0
      s2 = 0;
      c2 = ncomp;
    }
    const int score2 = group_max<G>(s2);
    const int ref_end2 = group_min<G>(s2 == score2 ? c2 : kBig);
    if (g == 0 && real) {
      p.out[pair] = score;
      p.out[p.B + pair] = ref_end;
      p.out[2 * p.B + pair] = read_end;
      p.out[3 * p.B + pair] = p.R > 0 ? score2 : 0;
      p.out[4 * p.B + pair] = p.R > 0 && score2 > 0 ? ref_end2 : 0;
    }
  }
}

template <int G, int S, bool FULL, typename Key = int>
int launch(const Pass& a, cudaStream_t stream) {
  const long long threads = (long long)a.B * G;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  sw_kernel<G, S, FULL, Key><<<blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// the instantiation with S == s among S = S0, S0 + 2, ..., SMAX
template <int G, int S, int SMAX, bool FULL>
int launch_s(int s, const Pass& a, cudaStream_t stream) {
  if constexpr (S > SMAX) {
    return -1;
  } else {
    if (s == S) return launch<G, S, FULL>(a, stream);
    return launch_s<G, S + 2, SMAX, FULL>(s, a, stream);
  }
}

// G: the smallest power of two (at most 32) with G * 16 >= wpad rows; S:
// the rows a lane then needs, rounded up to even (G = 1: 2..16; G = 2..16:
// 10..16; G = 32: 10..32, and 32 in tiles of 1,024 rows past that).
template <bool FULL>
int launch_shape(const Pass& a, cudaStream_t stream) {
  int g = 1;
  while (g < 32 && g * 16 < a.wpad) g *= 2;
  const int rows = a.wpad < 32 * 32 ? a.wpad : 32 * 32;  // of one tile
  int s = rows > g ? (rows + g - 1) / g : 1;
  s += s & 1;
  switch (g) {
    case 1: return launch_s<1, 2, 16, FULL>(s, a, stream);
    case 2: return launch_s<2, 10, 16, FULL>(s, a, stream);
    case 4: return launch_s<4, 10, 16, FULL>(s, a, stream);
    case 8: return launch_s<8, 10, 16, FULL>(s, a, stream);
    case 16: return launch_s<16, 10, 16, FULL>(s, a, stream);
    default: return launch_s<32, 10, 32, FULL>(s, a, stream);
  }
}

}  // namespace

// C entry point (bound with ctypes). Returns a cudaError_t: 0 = launched.
// ws: the workspace the wrapper allocates (ops/sw_cuda.py workspace_ints):
// in full mode 3 * R * B int32 (4 * R * B with the int64 key), plus
// 4 * R * B past 1,024 padded rows. The full mode takes the int64 key when
// max(match, -mismatch, -gap_open, -gap_extend, 0) * (padded W + R) >=
// 2^20 (ops/sw_cuda.py h_bound; an int32 key overflows from H = 2^21).
extern "C" int sw_pass_launch(const void* q, const void* r, const void* ql,
                              const void* rl, const void* tm, void* out,
                              void* ws, int B, int W, int R, int match,
                              int mismatch, int gap_open, int gap_extend,
                              int mask_len, int pad_to, int second_inclusive,
                              int score_only, void* stream) {
  if (B <= 0) return 0;
  const Pass a{static_cast<const int8_t*>(q),
               static_cast<const int8_t*>(r),
               static_cast<const int32_t*>(ql),
               static_cast<const int32_t*>(rl),
               static_cast<const int32_t*>(tm),
               static_cast<int32_t*>(out),
               static_cast<int32_t*>(ws),
               B, W, R, (W + pad_to - 1) / pad_to * pad_to, match, mismatch,
               gap_open, gap_extend, mask_len, pad_to, second_inclusive};
  auto st = static_cast<cudaStream_t>(stream);
  if (score_only) return launch_shape<false>(a, st);
  int step = match > 0 ? match : 0;   // H's most gain a row or a column
  if (-mismatch > step) step = -mismatch;
  if (-gap_open > step) step = -gap_open;
  if (-gap_extend > step) step = -gap_extend;
  if ((long long)step * (a.wpad + R) >= (1 << 20))
    return launch<32, 32, true, long long>(a, st);
  return launch_shape<true>(a, st);
}
