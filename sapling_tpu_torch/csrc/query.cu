// The query cascade for Hopper (sm_90a): plQuery, the classic suffix-array
// binary search and its llcp/rlcp-pruned variant, one thread a query.
//
// Replace the XLA programs of sapling_tpu/ops/query.py::plquery_batch
// (:1011; with _plquery_fast3 :723, _general_refine :886, make_rank_probe
// :315, make_rank_probe3 :384, probe_at :143, _masked_binary_search :504,
// _lane_bounds :581 and ops/predict.py::predict_pwl :231),
// ::binsearch_batch (:1370) and ::fancy_binsearch_batch (:1404), and
// compute exactly what the port's plain versions compute
// (sapling_tpu_torch/ops/query.py plquery_batch, binsearch_batch,
// fancy_binsearch_batch), bit for bit: the same member of a duplicate run,
// the same -1s.
//
// The plain versions run every lane of a batch through one masked decision
// sequence and sync with the host once a bisection round and once a stride
// step. Here one thread runs one query through the reference's sequential
// cascade (src/sapling_api.h:159-248; src/binarysearch.cpp:38-58,158-165),
// so a call is one launch and no host sync:
//
//   predict    exact int64 rational interpolation between the PWL
//              checkpoints, round half up, the d == 0 bucket, clipped to
//              [0, n-1] (or the caller's pred64);
//   probes     PROBE selects one of three forms with the same outcome:
//                kFast3     one int64 compare against prefix3[rank] (the
//                           value is the rank; rev is read once at the end)
//                kPrefix64  up to 32 bases: one unsigned 64-bit compare,
//                           masked to the length, against the suffix's
//                           first 32 bases (plquery: its rank record's key;
//                           the pruned search: its node record's)
//                kPacked    with rank records the key, then on a tie past
//                           32 bases, else rev[rank] and at once,
//                           ceil(L/16)+1 genome words, funnel-shifted into
//                           line, XOR, clz
//              and finish's off-end rules (the plain versions' prefix64
//              probe gives the same outcomes);
//   cascade    the prediction probe, the optional bucket probe
//              (adaptive_bounds), phase A (the 'most' window edge), phase B
//              (the 'max' window edge), phase C (the stride scan for L > k,
//              capped by max_stride_steps, with the stuck test) and phase D
//              (bisection with the hi == lo + 2 base case).
//
// What bounds them: bytes, as random 32-byte sectors. A plquery
// prediction reads one sector of the bucket records, a probe one of
// prefix3 or of the rank records (and the genome on a tie past 32 bases)
// or one of rev and one or two of the packed genome, as the binary
// search's probes do. The least time of a call is the distinct
// sectors its lanes touch, times 32 bytes, over HBM's 3.35 TB/s; with
// `stats` the kernels count the sectors a lane touches (and can record
// their numbers, so that the caller counts the distinct ones), and their
// deepest phase C and phase D step counts, which equal the plain versions'
// host loop rounds. Each probe waits on the last, so what the card reaches
// is set by the loads in flight: the resident threads an SM, which the
// registers a thread decide.
//
// What the designs do about it:
//
//   plquery_kernel   One thread a query, kept small: no shared memory, no
//                    warp cooperation, lanes in the caller's order (sorting
//                    them bought 1.03-1.04x on a torch gather). A query
//                    takes 2.4 probes on average (61% resolve at the
//                    prediction probe, the deepest 10), and a warp runs as
//                    long as its deepest lane. A per-warp queue
//                    raised the probe slots a lane uses from 40-46% to
//                    72-78% but ran 1.10-1.15x slower (registers): time
//                    follows the sectors a lane reads from device memory.
//                    So a prediction reads one 32-byte bucket record
//                    (bucket_records_kernel: xlo, xhi, ylo, and yhi - ylo
//                    beside the bucket's bounds word), not two sectors
//                    each of xlist and ylist and one of bounds: 1.14-1.29x
//                    on an H100. A probe reads one 16-byte rank record
//                    (records_kernel: the suffix's first 32 bases,
//                    genome_key, and rev), not rev and then, dependent on
//                    it, the genome: the key decides up to 32 bases, and
//                    past 32 unless all 32 agree, where compare_at reads
//                    the genome. That takes a DRAM load off a probe where
//                    rev and the genome outgrow the 50 MB L2 (46 Mbp:
//                    1.05-1.26x); where they fit (4.6 Mbp) a probe found
//                    both in L2 and the records ran 0.83-1.00x, so the
//                    wrapper passes no rank records there and a probe
//                    reads rev and the genome. The prefix3 probe (fast3,
//                    8 bytes a rank) ran 1.03-1.06x slower than the rank
//                    records at 16 and 21 bases on the PWL prediction (2.4
//                    probes a query), but 1.48x faster than rev and the
//                    genome under the NN engine's predictions (17
//                    bisection rounds): it answers where the caller
//                    passes q3. The prefix64 probe was dropped.
//   binsearch_kernel Every lane's bisection over [0, n-1] starts with the
//                    same midpoints, so the first kTreeLevels levels (and
//                    the pre-probes of ranks 0 and n-1) are one table: each
//                    persistent block fills it in shared memory once, with
//                    rev[mid] and the suffix's first 32 bases beside it, and
//                    a lane walks it without touching device memory unless
//                    its first 32 bases tie with a node's (then it reads the
//                    genome as a probe does). That takes 12 of a lane's
//                    ~22 dependent probes off device memory: 1.07-1.11x at
//                    4.6 and 46 Mbp on an H100. At 230 Mbp, where the
//                    bisection has 28 levels and its first ones were L1 and
//                    L2 hits anyway, the gain is gone (0.97-0.98x).
//   fancy_binsearch_kernel
//                    The Manber-Myers search, one thread a query: a round
//                    tests the one table entry it needs (llcp[mid] when
//                    loLcp >= hiLcp, else rlcp[mid]) and probes only when
//                    that entry equals the boundary LCP; a lane stops when
//                    it is decided. The probe's LCP is the capped one
//                    (finish), as the plain version feeds it back. A round
//                    is one dependent load of one 32-byte node record a
//                    rank (records_kernel builds them once for an index
//                    and its tables): the suffix's first 32 bases
//                    (genome_key), rev, llcp and rlcp. So the test and the
//                    probe read the same sector, and a probe reads the
//                    genome only at L > 32 when all 32 bases tie. Up to 32
//                    bases the prefix64 and packed forms are one
//                    instantiation (40 registers, against 64 for the
//                    packed form's compare_at). Lane state is 32-bit
//                    (n < 2^31). The first design read llcp or rlcp, then
//                    rev and prefix64 or the genome on a probe: ~52
//                    scattered sectors a lane along ~39 dependent loads at
//                    4.6 Mbp; the records run 1.6-2.1x faster on an NVIDIA
//                    H100 80GB HBM3 at 700 W. Measured and dropped
//                    (PERF.md): a shared table of the top 11 levels, int32
//                    state alone, a prefetch of both candidate next
//                    records, the record's LCP half read first, and a
//                    long probe's genome read from base 32 on.
//   records_kernel   The builders of those records, once for an index (and
//                    its tables): a rank r reads rev[r] (and llcp[r],
//                    rlcp[r]) once, in order, writes its 16 (32) bytes
//                    once, in order, and gathers its key's three genome
//                    words from rev[r] >> 4: a random place, dependent on
//                    rev[r]. The first builders read the genome as int64
//                    words (1.5 sectors a key, 23 MB at 46 Mbp) and wrote a
//                    node record as two 16-byte stores, half of each sector
//                    a store. Now the genome is read as 32-bit words (1.25
//                    sectors a key, 11.5 MB: 1.22-1.26x at 46 Mbp on an
//                    NVIDIA H100 80GB HBM3 at 700 W), a warp's node
//                    records are staged in shared memory and stored as 64
//                    consecutive 16-byte chunks, whole sectors a store
//                    (1.42-1.52x), and the streams are loaded and stored
//                    evict-first (ld/st .cs, 1.00-1.03x), so that the
//                    genome stays in L2 while they pass. Past the L2 (230
//                    Mbp: a 57.5 MB genome) the gathers miss and set the
//                    time, so node records copy their first halves from
//                    the index's rank records where it holds them, a
//                    stream and no gather (2.2x there). Measured and
//                    dropped: four ranks a thread, their gathers issued
//                    together (1.00-1.04x the time of one: the resident
//                    warps keep enough in flight), and a persisting L2
//                    window over the genome (1.25-2.5x slower).
//
// The binary search keeps each lane's decision sequence and its probe and
// sector counts (a probe answered from shared memory records the sectors
// the first design read), so its bound does not move with the design; the
// pruned search records the sectors it really reads: a node record each
// round and compare_at's genome windows.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;        // plquery's threads a block
// the binary search: the levels of its shared table, threads a block
constexpr int kTreeLevels = 12;
constexpr int kTreeNodes = 1 << kTreeLevels;  // nodes 1 .. kTreeNodes - 1
constexpr int kSearchThreads = 512;
constexpr int kFast3 = 0, kPrefix64 = 1, kPacked = 2;
constexpr int kBasesPerWord = 16;
constexpr int kWin = 7;   // query words a probe compares from registers
// a bucket record's yhi - ylo that says "read ylist[bucket + 1]": a bucket
// of 2^32 - 1 ranks or more (n >= 2^32), or a falling ylist
constexpr uint32_t kWideM = 0xFFFFFFFFu;

struct Args {
  const int64_t* packed;    // [packed_len] 2-bit genome words (< 2^32)
  const void* rev;          // [n] int32 holding uint32 bits, or int64
  const int64_t* xlist;     // [2^buckets + 1]
  const int64_t* ylist;
  const int64_t* prefix3;   // [n], or null
  const int32_t* bounds;    // [2^buckets] uint32 bits (over << 16 | under)
  const int64_t* q_words;   // [ceil(L/16), B] word-major, or null (fast3)
  const int64_t* q3;        // [B] 3-bit packed queries (fast3)
  const int64_t* x;         // [B] adjusted k-mers
  const int64_t* pred64;    // [B] the caller's predicted ranks, or null
  int64_t* out;             // [B] positions, -1 = not found
  int32_t* lane_stats;      // [2, B] probes, sectors; or null
  int32_t* depth;           // [2] deepest phase C, phase D steps; or null
  int64_t* trace;           // [B, trace_cap] sector numbers a lane touched
                            // (the first trace_cap; -1 past its last); or
                            // null
  int64_t B, n, packed_len, most_over, most_under, max_over, max_under,
      max_stride_steps;
  int length, k, buckets, adaptive, trace_cap;
  const int32_t* llcp = nullptr;   // the pruned search's [n] tables
  const int32_t* rlcp = nullptr;
  const longlong2* nodes = nullptr;   // its [n] node records, 2 halves each
  // plquery's records: [2^buckets] of 2 halves ({xlo, xhi}, {ylo, m |
  // bounds << 32}) and [n] rank records {genome_key(rev[r]), rev[r]} (or
  // null: a probe reads rev and the genome)
  const longlong2* bucket_recs = nullptr;
  const longlong2* rank_recs = nullptr;
  // the record builders' genome: the packed words as 32 bits (uint32 bits
  // in int32), packed_len of them
  const int32_t* genome32 = nullptr;
};

struct Probe {
  int64_t val;     // the rank (fast3) or the text position
  bool match;      // a full L-base match
  bool smaller;    // the suffix sorts below the query (off the end too)
  bool off_end;    // the compare ran off the genome (not on fast3)
  int64_t lcp;     // LCP(query, suffix) capped at the genome's end (not
                   // on fast3)
};

// the dynamic shared memory of a block
__device__ __forceinline__ unsigned char* shared_bytes() {
  extern __shared__ __align__(16) unsigned char smem[];
  return smem;
}

// an address as its 32-byte sector's number
__device__ __forceinline__ int64_t sector(const void* p) {
  return (int64_t)((uintptr_t)p >> 5);
}

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

template <typename REV>
__device__ __forceinline__ int64_t rev_at(const void* rev, int64_t rank) {
  if constexpr (sizeof(REV) == 4)
    return (int64_t)(uint32_t)__ldg(static_cast<const int32_t*>(rev) + rank);
  else
    return __ldg(static_cast<const int64_t*>(rev) + rank);
}

// the suffix at pos's first 32 bases from the genome words w = words
// pos >> 4 .. + 2, as one big-endian key
__device__ __forceinline__ uint64_t key_of(const uint32_t w[3], int64_t pos) {
  const int sh = (int)(pos & 15) << 1;
  // sh == 0 takes nothing from the next word (a shift by 32 is undefined)
  const uint32_t hi = sh ? (w[0] << sh) | (w[1] >> (32 - sh)) : w[0];
  const uint32_t lo = sh ? (w[1] << sh) | (w[2] >> (32 - sh)) : w[1];
  return (uint64_t)hi << 32 | lo;
}

// compare_at's first two aligned genome words at text position pos, as one
// key: the suffix's first 32 bases (word indexes clamped as there)
__device__ __forceinline__ uint64_t genome_key(const Args& a, int64_t pos) {
  const int64_t last = a.packed_len - 1, w0 = pos >> 4;
  uint32_t w[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    w[j] = (uint32_t)__ldg(a.packed + lmin(w0 + j, last));
  return key_of(w, pos);
}

// One query's state: its inputs, read once, and its counts. With RANKS a
// probe reads rank records (plquery's), else rev and the genome.
template <int PROBE, typename REV, bool RANKS = false>
struct Lane {
  const Args& a;
  int64_t b;
  uint64_t qword;                 // the query's first 32 bases, masked to
  uint64_t qmask;                 // the length (not on fast3)
  int64_t q3m, mask3;             // fast3: the masked query and its mask
  uint32_t qw[kWin];              // packed: the query's first words
  int wq;
  int probes = 0, sectors = 0;

  // with stats, count (and with a trace, record) the sectors of [p, last];
  // returns their count (0 without stats)
  __device__ int touch(const void* p, const void* last) {
    if (!a.lane_stats) return 0;
    const int before = sectors;
    for (int64_t s = sector(p); s <= sector(last); ++s) {
      if (a.trace && sectors < a.trace_cap)
        a.trace[b * a.trace_cap + sectors] = s;
      ++sectors;
    }
    return sectors - before;
  }
  __device__ void touch(const void* p) { touch(p, p); }

  __device__ int64_t rev(int64_t rank) {
    touch(static_cast<const REV*>(a.rev) + rank);
    return rev_at<REV>(a.rev, rank);
  }

  __device__ Lane(const Args& a_, int64_t b_) : a(a_), b(b_) {
    const int L = a.length;
    if constexpr (PROBE == kFast3) {
      mask3 = 0;
      for (int j = 0; j < L; ++j) mask3 |= (int64_t)7 << (60 - 3 * j);
      q3m = a.q3[b] & mask3;
      return;
    }
    wq = (L + kBasesPerWord - 1) / kBasesPerWord;
    qmask = L >= 32 ? ~0ull : ~0ull << (64 - 2 * L);
    uint64_t hi, lo;
    if constexpr (PROBE == kPrefix64) {
      hi = (uint32_t)a.q_words[b];
      lo = wq > 1 ? (uint32_t)a.q_words[a.B + b] : 0;
    } else {
#pragma unroll
      for (int j = 0; j < kWin; ++j)
        if (j < wq) qw[j] = (uint32_t)a.q_words[j * a.B + b];
      hi = qw[0];
      lo = wq > 1 ? qw[1] : 0;
    }
    qword = ((hi << 32) | lo) & qmask;
  }

  // the off-end rules (the reference's getLcp, src/sapling_api.h:115-130):
  // the LCP is capped at the genome's end, and a suffix that runs off the
  // end before differing sorts below the query
  __device__ Probe finish(int64_t pos, int64_t lcp_raw, bool q_gt) const {
    const int64_t L = a.length;
    const int64_t rem = lmin(a.n - pos, L);
    const int64_t lcp = lmin(lcp_raw, rem);
    Probe p;
    p.val = pos;
    p.match = lcp == L;
    p.off_end = !p.match && lcp == rem && rem < L;
    p.smaller = p.off_end || (!p.match && q_gt);
    p.lcp = lcp;
    return p;
  }

  // the query against the suffix at rank: from prefix3 (kFast3), its rank
  // record (RANKS), else rev[rank] and the genome (kPacked)
  __device__ Probe probe(int64_t rank) {
    ++probes;
    if constexpr (PROBE == kFast3) {
      const int64_t* at = a.prefix3 + rank;
      touch(at);
      const int64_t pm = __ldg(at) & mask3;
      Probe p;
      p.val = rank;
      p.match = pm == q3m;
      p.smaller = !p.match && q3m > pm;   // values < 2^63: signed is unsigned
      p.off_end = false;
      p.lcp = 0;
      return p;
    } else if constexpr (RANKS) {
      const longlong2* at = a.rank_recs + rank;
      touch(at);
      const longlong2 r = __ldg(at);
      Probe p;
      if constexpr (PROBE == kPrefix64) {
        key_decides(r.y, (uint64_t)r.x, &p);   // always, up to 32 bases
        return p;
      } else {
        return key_decides(r.y, (uint64_t)r.x, &p) ? p : compare_at(r.y);
      }
    } else {
      static_assert(PROBE == kPacked, "the key form reads rank records");
      return compare_at(rev(rank));
    }
  }

  // The query's first min(L, 32) bases against key, the first 32 bases of
  // the suffix at pos (genome_key; it differs from the plain version's
  // prefix64 only past the genome's end, where finish caps the LCP): true,
  // with *p the outcome, where they decide (some base differs, or L <=
  // 32); false where all agree past 32 bases (compare_at decides).
  __device__ bool key_decides(int64_t pos, uint64_t key, Probe* p) const {
    const uint64_t pw = key & qmask;
    const uint64_t d = pw ^ qword;
    if (!d && a.length > 32) return false;
    *p = finish(pos, d ? __clzll((long long)d) >> 1 : a.length, qword > pw);
    return true;
  }

  // probe(rank) of the packed form with rev[rank] and genome_key(rev[rank])
  // already known (the binary search's shared table): the first min(L, 32)
  // bases decide unless they all agree and L > 32, where compare_at reads
  // the genome. Counts the probe and records the sectors probe(rank) reads.
  __device__ Probe probe_known(int64_t rank, int64_t pos, uint64_t key) {
    ++probes;
    touch(static_cast<const REV*>(a.rev) + rank);
    Probe p;
    if (!key_decides(pos, key, &p)) return compare_at(pos);
    const int64_t last = a.packed_len - 1, w0 = pos >> 4;   // its first window
    touch(a.packed + lmin(w0, last),
          a.packed + lmin(w0 + (wq < kWin ? wq : kWin), last));
    return p;
  }

  // a probe answered from a node record: the suffix's first 32 bases (key,
  // as genome_key gives them) and its position pos. Up to 32 bases
  // (kPrefix64) the key decides as prefix64 does (the two differ only past
  // the genome's end, where finish caps the LCP); past 32 (kPacked) it
  // decides unless all 32 bases agree, where compare_at reads the genome
  // (and records its windows' sectors).
  __device__ Probe probe_node(int64_t pos, uint64_t key) {
    ++probes;
    Probe p;
    if constexpr (PROBE == kPrefix64) {
      key_decides(pos, key, &p);
      return p;
    } else {
      return key_decides(pos, key, &p) ? p : compare_at(pos);
    }
  }

  // probe_at: the query against the genome at text position pos, a window
  // of up to kWin query words at a time (one window up to 112 bases): the
  // window's kWin + 1 genome words are loaded together, funnel-shifted into
  // line and XORed with the query's; the first differing word decides.
  // Word indexes past the padded array are clamped (those bases lie past n,
  // where the LCP is capped anyway).
  __device__ Probe compare_at(int64_t pos) {
    const int sh = (int)(pos & 15) << 1;
    const int64_t last = a.packed_len - 1;
    for (int base = 0; base < wq; base += kWin) {
      const int nw = wq - base < kWin ? wq - base : kWin;
      const int64_t w0 = (pos >> 4) + base;
      uint32_t w[kWin + 1];
#pragma unroll
      for (int j = 0; j <= kWin; ++j)
        if (j <= nw) w[j] = (uint32_t)__ldg(a.packed + lmin(w0 + j, last));
      touch(a.packed + lmin(w0, last), a.packed + lmin(w0 + nw, last));
#pragma unroll
      for (int j = 0; j < kWin; ++j) {
        if (j >= nw) break;
        const uint32_t q = base == 0 ? qw[j] : query_word(base + j);
        // sh == 0 takes nothing from the next word (a shift by 32 is
        // undefined)
        const uint32_t aligned =
            sh ? (w[j] << sh) | (w[j + 1] >> (32 - sh)) : w[j];
        const uint32_t d = aligned ^ q;
        if (d) {   // the first differing base decides the order
          const int64_t lcp_raw =
              (int64_t)(base + j) * kBasesPerWord + (__clz((int)d) >> 1);
          return finish(pos, lcp_raw, q > aligned);
        }
      }
    }
    return finish(pos, a.length, false);
  }

  __device__ uint32_t query_word(int j) const {
    return (uint32_t)__ldg(a.q_words + (int64_t)j * a.B + b);
  }

  // the value a hi == lo + 2 base case returns for rank lo + 1, unprobed
  __device__ int64_t value_at(int64_t rank) {
    if constexpr (PROBE == kFast3) {
      return rank;
    } else if constexpr (RANKS) {
      touch(a.rank_recs + rank);
      return __ldg(a.rank_recs + rank).y;
    } else {
      return rev(rank);
    }
  }

  // the reference's binarySearch (src/sapling_api.h:133-153) over [lo, hi]:
  // it returns the matching probe's value, rank lo+1's value at the
  // hi == lo + 2 base case (without looking at its match), or -1 when the
  // interval runs out. *steps counts the rounds.
  __device__ int64_t bisect(int64_t lo, int64_t hi, int* steps) {
    for (;;) {
      ++*steps;
      if (hi == lo + 2) return value_at(lo + 1);
      const int64_t mid = lo + ((hi - lo) >> 1);
      const Probe p = probe(mid);
      if (p.match) return p.val;
      if (lo + 1 >= hi) return -1;
      if (p.smaller)
        lo = mid;
      else
        hi = mid;
    }
  }

  __device__ void done(int64_t res, int c_steps, int d_steps) {
    if constexpr (PROBE == kFast3) {
      if (res >= 0) res = rev(res);
    }
    a.out[b] = res;
    if (a.lane_stats) {
      if (a.trace)
        for (int i = sectors; i < a.trace_cap; ++i)
          a.trace[b * a.trace_cap + i] = -1;
      a.lane_stats[b] = probes;
      a.lane_stats[a.B + b] = sectors;
      if (c_steps) atomicMax(a.depth, c_steps);
      if (d_steps) atomicMax(a.depth + 1, d_steps);
    }
  }
};

// predict_pwl: round half up of ylo + M*N/D, M = yhi - ylo, N = x - xlo,
// D = xhi - xlo, with N split in base 2^16 so that no product leaves int64.
// The bucket's checkpoints come from its bucket record (one sector; m past
// 32 bits reads ylist[bucket + 1] too), which also holds its bounds word:
// *bw.
template <typename L>
__device__ int64_t predict(L& lane, int64_t x, uint32_t* bw) {
  const Args& a = lane.a;
  const int64_t bucket = x >> (2 * a.k - a.buckets);
  const longlong2* rec = a.bucket_recs + 2 * bucket;
  lane.touch(rec, rec + 1);
  const longlong2 xs = __ldg(rec), ys = __ldg(rec + 1);
  const int64_t xlo = xs.x, xhi = xs.y, ylo = ys.x;
  int64_t m = (uint32_t)ys.y;
  *bw = (uint32_t)((uint64_t)ys.y >> 32);
  if (m == kWideM) {
    lane.touch(a.ylist + bucket + 1);
    m = __ldg(a.ylist + bucket + 1) - ylo;
  }
  const int64_t d = xhi - xlo, nn = x - xlo;
  const int64_t abs_n = nn < 0 ? -nn : nn;
  const int64_t nh = abs_n >> 16, nl = abs_n & 0xFFFF;
  const int64_t ds = d == 0 ? 1 : d;
  const int64_t q1 = floor_div(m * nh, ds), r1 = m * nh - q1 * ds;
  const int64_t q2 = floor_div((r1 << 16) + m * nl, ds);
  const int64_t r = (r1 << 16) + m * nl - q2 * ds;
  const int64_t q = (q1 << 16) + q2;
  int64_t pred = nn >= 0 ? ylo + q + (2 * r >= ds ? 1 : 0)
                         : ylo - q - (2 * r > ds ? 1 : 0);
  if (d == 0) pred = ylo;
  return lmin(lmax(pred, 0), a.n - 1);
}

template <int PROBE, typename REV, bool RANKS>
__global__ void __launch_bounds__(kThreads) plquery_kernel(const __grid_constant__ Args a) {
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= a.B) return;
  Lane<PROBE, REV, RANKS> lane(a, b);
  const int64_t n = a.n;
  const int64_t x = a.x[b];
  uint32_t bw = 0;   // the bucket's bounds word (adaptive)
  const int64_t pred = a.pred64 ? a.pred64[b] : predict(lane, x, &bw);
  const int64_t e_right = lmin(pred + a.most_over, n - 1);
  const int64_t e_left = lmax(pred - a.most_under, 0);

  // prediction probe (:161-167): suffix at pred < query -> search right
  const Probe p0 = lane.probe(pred);
  if (p0.match) return lane.done(p0.val, 0, 0);
  const bool right = p0.smaller;
  int64_t lo, hi;
  bool need_a = true;
  int64_t a_right = 0, a_left = 0;
  if (a.adaptive) {
    // the bucket's own max-error window, before the 'most' window; a
    // clipped bucket (0xFFFF) takes the 'most' window. predict read its
    // bounds word; a caller's prediction reads it from bounds.
    if (a.pred64) {
      const int32_t* at = a.bounds + (x >> (2 * a.k - a.buckets));
      lane.touch(at);
      bw = (uint32_t)__ldg(at);
    }
    a_right = lmin(pred + lmin(bw >> 16, a.most_over), n - 1);
    a_left = lmax(pred - lmin(bw & 0xFFFF, a.most_under), 0);
    const Probe p1 = lane.probe(right ? a_right : a_left);
    if (p1.match) return lane.done(p1.val, 0, 0);
    need_a = right ? p1.smaller : !p1.smaller;
    lo = right ? pred : a_left;
    hi = right ? a_right : pred;
  } else {
    lo = right ? pred : e_left;
    hi = right ? e_right : pred;
  }

  // phase A: the 'most' window edge (:171-174 right, :209-213 left)
  bool escalate = false;
  if (need_a) {
    const Probe pa = lane.probe(right ? e_right : e_left);
    if (pa.match) return lane.done(pa.val, 0, 0);
    // escalation (:175 right-still-smaller, :214/:221 left-still-bigger)
    escalate = right ? pa.smaller : !pa.smaller;
    if (a.adaptive) {
      lo = right ? a_right : e_left;
      hi = right ? e_right : a_left;
    }
  }

  int c_steps = 0;
  if (escalate) {
    // phase B: the 'max' window edge (:180-183 right, :225-228 left)
    const int64_t b_right = lmin(pred + a.max_over + 1, n - 1);
    const int64_t b_left = lmax(pred - a.max_under - 1, 0);
    const Probe pb = lane.probe(right ? b_right : b_left);
    if (pb.match) return lane.done(pb.val, 0, 0);
    lo = right ? e_right : b_left;
    hi = right ? b_right : e_left;
    // phase C: the stride scan, only for queries longer than k (:184-196,
    // :229-241). The reference's loop is unbounded and can livelock at the
    // array ends; it is capped, and stops when the edge can't advance.
    if (a.length > a.k) {
      bool act = right ? pb.smaller && !pb.off_end : !pb.smaller;
      while (act && c_steps < a.max_stride_steps) {
        ++c_steps;
        const int64_t new_lo = right ? hi : lmax(lo - a.max_under, 0);
        const int64_t new_hi = right ? lmin(hi + a.max_over, n - 1) : lo;
        const int64_t at = right ? new_hi : new_lo;
        const bool stuck = at == (right ? hi : lo);
        lo = new_lo;
        hi = new_hi;
        const Probe pc = lane.probe(at);
        if (pc.match) return lane.done(pc.val, c_steps, 0);
        act = !stuck && (right ? pc.smaller && !pc.off_end : !pc.smaller);
      }
    }
  }

  // phase D: bisection (:245-247)
  int d_steps = 0;
  const int64_t res = lane.bisect(lo, hi, &d_steps);
  lane.done(res, c_steps, d_steps);
}

// The binary search's shared table: node i (root 1, children 2i and 2i+1,
// the smaller-than-query side 2i+1) holds rev[mid] and genome_key of it
// for the interval the bisection reaches it with; slot 0 holds rank 0 and
// slot kTreeNodes rank n-1 (bQuery's pre-probes). Nodes no lane reaches
// are left unwritten.
struct Node {
  uint64_t key;
  int64_t pos;
};

constexpr size_t kTreeBytes = (size_t)(kTreeNodes + 1) * sizeof(Node);

template <typename REV>
__device__ void fill_tree(const Args& a, Node* tree) {
  for (int i = threadIdx.x; i <= kTreeNodes; i += blockDim.x) {
    int64_t rank = i == 0 ? 0 : a.n - 1;
    bool reached = true;
    if (i > 0 && i < kTreeNodes) {
      int64_t lo = 0, hi = a.n - 1;
      for (int l = 30 - __clz(i); l >= 0; --l) {
        // the bisection probes this interval and goes on below it
        if (hi == lo + 2 || lo + 1 >= hi) {
          reached = false;
          break;
        }
        const int64_t mid = lo + ((hi - lo) >> 1);
        if ((i >> l) & 1)
          lo = mid;
        else
          hi = mid;
      }
      rank = lo + ((hi - lo) >> 1);   // lo + 1 at a hi == lo + 2 node
    }
    if (reached) {
      const int64_t pos = rev_at<REV>(a.rev, rank);
      tree[i] = Node{genome_key(a, pos), pos};
    }
  }
}

// bQuery (binarysearch.cpp:158-165): rank 0 and rank n-1 first, then the
// binary search over [0, n-1]; an absent query resolves to -1. The first
// kTreeLevels rounds read the shared table.
template <typename REV>
__device__ void binsearch_lane(const Args& a, const Node* tree, int64_t b) {
  Lane<kPacked, REV> lane(a, b);
  const Probe p_lo = lane.probe_known(0, tree[0].pos, tree[0].key);
  if (p_lo.match) return lane.done(p_lo.val, 0, 0);
  const Node& last = tree[kTreeNodes];
  const Probe p_hi = lane.probe_known(a.n - 1, last.pos, last.key);
  if (p_hi.match) return lane.done(p_hi.val, 0, 0);
  int64_t lo = 0, hi = a.n - 1;
  int steps = 0, node = 1;
  for (int level = 0; level < kTreeLevels; ++level) {
    ++steps;
    const Node& nd = tree[node];
    if (hi == lo + 2) {   // value_at(lo + 1), from the table
      lane.touch(static_cast<const REV*>(a.rev) + lo + 1);
      return lane.done(nd.pos, 0, steps);
    }
    const int64_t mid = lo + ((hi - lo) >> 1);
    const Probe p = lane.probe_known(mid, nd.pos, nd.key);
    if (p.match) return lane.done(p.val, 0, steps);
    if (lo + 1 >= hi) return lane.done(-1, 0, steps);
    if (p.smaller) {
      lo = mid;
      node = 2 * node + 1;
    } else {
      hi = mid;
      node = 2 * node;
    }
  }
  const int64_t res = lane.bisect(lo, hi, &steps);
  lane.done(res, 0, steps);
}

template <typename REV>
__global__ void __launch_bounds__(kSearchThreads)
    binsearch_kernel(const __grid_constant__ Args a) {
  Node* tree = reinterpret_cast<Node*>(shared_bytes());
  fill_tree<REV>(a, tree);
  __syncthreads();
  for (int64_t b = (int64_t)blockIdx.x * kSearchThreads + threadIdx.x;
       b < a.B; b += (int64_t)gridDim.x * kSearchThreads)
    binsearch_lane<REV>(a, tree, b);
}

// A node record of the pruned search, as its two 16-byte halves: the
// suffix's first 32 bases and its position, then llcp | rlcp << 32 and a
// zero word. One record is one 32-byte sector; both halves are loaded at
// once, so a round waits on one load.
struct FancyNode {
  uint64_t key;
  int64_t pos;
  int llcp, rlcp;
};

__device__ __forceinline__ FancyNode load_node(const longlong2* nodes,
                                               int rank) {
  const longlong2 kp = __ldg(nodes + 2 * (int64_t)rank);
  const longlong2 lr = __ldg(nodes + 2 * (int64_t)rank + 1);
  return FancyNode{(uint64_t)kp.x, kp.y, (int)lr.x, (int)(lr.x >> 32)};
}

// The record builders: a warp's stage of node records, and what a builder
// makes: plquery's rank records, or node records of the genome or of the
// index's rank records.
constexpr size_t kStageBytes = (size_t)kThreads * 2 * sizeof(longlong2);
constexpr int kRankRecords = 0, kNodeRecords = 1, kNodesFromRanks = 2;

// a stream the builders read or write once, evict-first (ld/st .cs): the
// genome they gather from stays in L2 while the streams pass through
template <typename T>
__device__ __forceinline__ T stream_load(const T* p) {
  return __ldcs(p);
}
template <typename T>
__device__ __forceinline__ void stream_store(T* p, const T& v) {
  __stcs(p, v);
}

template <typename REV>
__device__ __forceinline__ int64_t rev_stream(const void* rev, int64_t r) {
  if constexpr (sizeof(REV) == 4)
    return (int64_t)(uint32_t)stream_load(static_cast<const int32_t*>(rev) +
                                          r);
  else
    return stream_load(static_cast<const long long*>(rev) + r);
}

// word i of the builders' 32-bit genome, clamped to the array as
// compare_at clamps it
__device__ __forceinline__ uint32_t genome_word(const Args& a, int64_t i) {
  return (uint32_t)__ldg(a.genome32 + lmin(i, a.packed_len - 1));
}

// One thread a rank r: the rank record {genome_key(rev[r]), rev[r]}
// (kRankRecords: plquery's, a probe's one 16-byte load), or the node
// record, that and {llcp[r] | rlcp[r] << 32, 0} (the pruned search's, a
// round's one 32-byte load), its first half gathered from the genome
// (kNodeRecords) or read from the index's rank records (kNodesFromRanks,
// REV unused: a stream, no gather). All exact: the same words as the
// plain versions.
template <typename REV, int KIND>
__global__ void __launch_bounds__(kThreads)
    records_kernel(const __grid_constant__ Args a, longlong2* out) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t pos = 0;
  uint64_t key = 0, lcps = 0;
  // the streams: the rank's rev word or rank record (and llcp, rlcp); a
  // rank past n gathers genome words 0 .. 2 and writes nothing
  if (r < a.n) {
    if constexpr (KIND == kNodesFromRanks) {
      const longlong2 rec = stream_load(a.rank_recs + r);
      key = (uint64_t)rec.x;
      pos = rec.y;
    } else {
      pos = rev_stream<REV>(a.rev, r);
    }
    if constexpr (KIND != kRankRecords)
      lcps = (uint32_t)stream_load(a.llcp + r)
             | (uint64_t)(uint32_t)stream_load(a.rlcp + r) << 32;
  }
  if constexpr (KIND != kNodesFromRanks) {   // the gather
    uint32_t w[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) w[i] = genome_word(a, (pos >> 4) + i);
    key = key_of(w, pos);
  }
  const longlong2 rec = make_longlong2((long long)key, pos);
  if constexpr (KIND == kRankRecords) {
    if (r < a.n) stream_store(out + r, rec);
  } else {
    // the warp's 32 records into its stage, then out as 64 consecutive
    // 16-byte chunks (the warp's ranks are consecutive), 32 a store
    longlong2* stage = reinterpret_cast<longlong2*>(shared_bytes())
                       + 2 * (threadIdx.x - lane);
    stage[2 * lane] = rec;
    stage[2 * lane + 1] = make_longlong2((long long)lcps, 0);
    __syncwarp();
    const int64_t r0 = r - lane;
#pragma unroll
    for (int c = lane; c < 64; c += 32)
      if (r0 + (c >> 1) < a.n) stream_store(out + 2 * r0 + c, stage[c]);
  }
}

// plquery's bucket records: one thread a bucket b writes {xlist[b],
// xlist[b + 1]} and {ylist[b], m | bounds[b] << 32} (32 bytes: a
// prediction's one load), m = ylist[b + 1] - ylist[b] where it lies in
// [0, kWideM), else kWideM (the kernel then reads ylist[b + 1]); bounds 0
// without the array.
__global__ void __launch_bounds__(kThreads)
    bucket_records_kernel(const __grid_constant__ Args a, longlong2* recs) {
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= (int64_t)1 << a.buckets) return;
  const int64_t ylo = __ldg(a.ylist + b), m = __ldg(a.ylist + b + 1) - ylo;
  const uint64_t m32 = m >= 0 && m < (int64_t)kWideM ? (uint64_t)m : kWideM;
  const uint64_t bw = a.bounds ? (uint32_t)__ldg(a.bounds + b) : 0u;
  recs[2 * b] = make_longlong2(__ldg(a.xlist + b), __ldg(a.xlist + b + 1));
  recs[2 * b + 1] = make_longlong2(ylo, (long long)(bw << 32 | m32));
}

// The llcp/rlcp-pruned search (the port's fancy_binsearch_batch; the
// reference's unused fancyBinarySearch, src/binarysearch.cpp:90-153):
// bQuery's pre-probes of ranks 0 and n-1 seed loLcp and hiLcp, then each
// round over [lo, hi] takes hi == lo + 1 as -1 and hi == lo + 2 as rank
// lo+1's value, unverified, or moves lo or hi to mid, on the table entry
// alone where it differs from the boundary LCP, else on a probe. At most
// bit_length(n - 1) + 2 rounds, as in the plain version (a lane is decided
// within them). Every rank is read from its node record (so no rev, llcp
// or rlcp is read: the Lane's rev type is unused); PROBE is kPrefix64 up
// to 32 bases and kPacked past 32. Stats count probes and the sectors
// read: a node record a pre-probe, a round or the base case, and
// compare_at's genome windows; there are no host rounds to match, so depth
// stays 0.
template <int PROBE>
__global__ void __launch_bounds__(kThreads)
    fancy_binsearch_kernel(const __grid_constant__ Args a) {
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= a.B) return;
  Lane<PROBE, int32_t> lane(a, b);
  const int n = (int)a.n;
  auto node = [&](int rank) {
    lane.touch(a.nodes + 2 * (int64_t)rank);   // one 32-byte sector
    return load_node(a.nodes, rank);
  };
  FancyNode nd = node(0);
  const Probe p0 = lane.probe_node(nd.pos, nd.key);
  if (p0.match) return lane.done(p0.val, 0, 0);
  nd = node(n - 1);
  const Probe p1 = lane.probe_node(nd.pos, nd.key);
  if (p1.match) return lane.done(p1.val, 0, 0);
  int lo = 0, hi = n - 1, lo_lcp = (int)p0.lcp, hi_lcp = (int)p1.lcp;
  int trips = 2;
  while (((n - 1) >> (trips - 2)) != 0) ++trips;
  for (int t = 0; t < trips; ++t) {
    if (hi == lo + 1) break;
    if (hi == lo + 2) {   // rank lo + 1's position, unprobed
      const longlong2* at = a.nodes + 2 * (int64_t)(lo + 1);
      lane.touch(at);
      return lane.done(__ldg(at).y, 0, 0);
    }
    const int mid = lo + ((hi - lo) >> 1);
    nd = node(mid);
    if (lo_lcp >= hi_lcp) {
      if (nd.llcp > lo_lcp) {
        lo = mid;
        continue;
      }
      if (nd.llcp < lo_lcp) {
        hi = mid;
        hi_lcp = nd.llcp;
        continue;
      }
    } else {
      if (nd.rlcp < hi_lcp) {
        lo = mid;
        lo_lcp = nd.rlcp;
        continue;
      }
      if (nd.rlcp > hi_lcp) {
        hi = mid;
        continue;
      }
    }
    // the entry equals the boundary LCP
    const Probe p = lane.probe_node(nd.pos, nd.key);
    if (p.match) return lane.done(p.val, 0, 0);
    if (p.smaller) {
      lo = mid;
      lo_lcp = (int)p.lcp;
    } else {
      hi = mid;
      hi_lcp = (int)p.lcp;
    }
  }
  lane.done(-1, 0, 0);
}

int blocks_for(int64_t B) { return (int)((B + kThreads - 1) / kThreads); }

template <int PROBE>
int launch_fancy(const Args& a, cudaStream_t stream) {
  fancy_binsearch_kernel<PROBE><<<blocks_for(a.B), kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename REV, int KIND>
int launch_records(const Args& a, longlong2* out, cudaStream_t stream) {
  const int blocks = blocks_for(a.n);
  const size_t smem = KIND == kRankRecords ? 0 : kStageBytes;
  records_kernel<REV, KIND><<<blocks, kThreads, smem, stream>>>(a, out);
  return (int)cudaGetLastError();
}

template <int PROBE, bool RANKS>
int launch_plquery(const Args& a, int rev64, cudaStream_t stream) {
  if (rev64)
    plquery_kernel<PROBE, int64_t, RANKS><<<blocks_for(a.B), kThreads, 0,
                                            stream>>>(a);
  else
    plquery_kernel<PROBE, int32_t, RANKS><<<blocks_for(a.B), kThreads, 0,
                                            stream>>>(a);
  return (int)cudaGetLastError();
}

// binsearch_kernel<REV> on no more blocks than fit on the card at once
// (each fills its table once and loops over the lanes). The count is found
// on a device's first call, where the kernel is also allowed the table's
// shared memory, and kept.
template <typename REV>
int launch_binsearch(const Args& a, cudaStream_t stream) {
  static std::atomic<int> resident[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidValue;
  int grid = resident[dev].load(std::memory_order_relaxed);
  if (!grid) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(binsearch_kernel<REV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kTreeBytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, binsearch_kernel<REV>, kSearchThreads, kTreeBytes);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid = per_sm * sms;
    resident[dev].store(grid, std::memory_order_relaxed);
  }
  const int64_t needed = (a.B + kSearchThreads - 1) / kSearchThreads;
  if (needed < grid) grid = (int)needed;
  binsearch_kernel<REV><<<grid, kSearchThreads, kTreeBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes). Each returns a cudaError_t: 0 =
// launched. The arrays are SaplingIndex.device_arrays()' (int64 packed
// words, xlist, ylist and prefix views; rev int32 holding uint32 bits when
// rev64 is 0, else int64; bounds int32 holding uint32 bits); q_words is
// int64 [ceil(L/16), B]; x, pred64 and out are int64 [B]. lane_stats
// (int32 [2, B]), depth (int32 [2], zeroed)
// and trace (int64 [B, trace_cap]) may be null. plquery reads xlist,
// ylist and bounds through its bucket records (bucket_recs, int64
// [2^buckets, 4], 32-byte aligned; ylist also where a record says so, and
// bounds with pred64); with q3 (int64 [B]) and prefix3 (int64 [n]) at
// length <= 21 a probe reads prefix3 (kFast3, q_words may be null), else
// with rank records (rank_recs, int64 [n, 2], 16-byte aligned) rev and the
// genome's first 32 bases through them, else rev and the genome. The
// pruned search reads rev, llcp and rlcp only through its node records
// (nodes, int64 [n, 4], 32-byte aligned), and the genome on a 32-base tie
// past 32 bases; with stats it records the sectors of both.
extern "C" int plquery_launch(
    const void* packed, long long packed_len, const void* rev, int rev64,
    const void* xlist, const void* ylist, const void* prefix3,
    const void* bounds, const void* bucket_recs, const void* rank_recs,
    const void* q_words, const void* q3, const void* x, const void* pred64,
    void* out, void* lane_stats,
    void* depth, void* trace, long long B, long long n, int length, int k,
    int buckets, long long most_over, long long most_under,
    long long max_over, long long max_under, long long max_stride_steps,
    int adaptive, int trace_cap, void* stream) {
  if (B <= 0) return 0;
  Args a{};
  a.packed = static_cast<const int64_t*>(packed);
  a.packed_len = packed_len;
  a.rev = rev;
  a.xlist = static_cast<const int64_t*>(xlist);
  a.ylist = static_cast<const int64_t*>(ylist);
  a.prefix3 = static_cast<const int64_t*>(prefix3);
  a.bounds = static_cast<const int32_t*>(bounds);
  a.bucket_recs = static_cast<const longlong2*>(bucket_recs);
  a.rank_recs = static_cast<const longlong2*>(rank_recs);
  a.q_words = static_cast<const int64_t*>(q_words);
  a.q3 = static_cast<const int64_t*>(q3);
  a.x = static_cast<const int64_t*>(x);
  a.pred64 = static_cast<const int64_t*>(pred64);
  a.out = static_cast<int64_t*>(out);
  a.lane_stats = static_cast<int32_t*>(lane_stats);
  a.depth = static_cast<int32_t*>(depth);
  a.trace = static_cast<int64_t*>(trace);
  a.B = B;
  a.n = n;
  a.most_over = most_over;
  a.most_under = most_under;
  a.max_over = max_over;
  a.max_under = max_under;
  a.max_stride_steps = max_stride_steps;
  a.length = length;
  a.k = k;
  a.buckets = buckets;
  a.adaptive = adaptive;
  a.trace_cap = trace_cap;
  auto st = static_cast<cudaStream_t>(stream);
  if (q3) return launch_plquery<kFast3, false>(a, rev64, st);
  if (!rank_recs) return launch_plquery<kPacked, false>(a, rev64, st);
  return length <= 32 ? launch_plquery<kPrefix64, true>(a, rev64, st)
                      : launch_plquery<kPacked, true>(a, rev64, st);
}

extern "C" int binsearch_launch(const void* packed, long long packed_len,
                                const void* rev, int rev64,
                                const void* q_words, void* out,
                                void* lane_stats, void* depth, void* trace,
                                long long B, long long n, int length,
                                int trace_cap, void* stream) {
  if (B <= 0) return 0;
  Args a{};
  a.packed = static_cast<const int64_t*>(packed);
  a.packed_len = packed_len;
  a.rev = rev;
  a.q_words = static_cast<const int64_t*>(q_words);
  a.out = static_cast<int64_t*>(out);
  a.lane_stats = static_cast<int32_t*>(lane_stats);
  a.depth = static_cast<int32_t*>(depth);
  a.trace = static_cast<int64_t*>(trace);
  a.trace_cap = trace_cap;
  a.B = B;
  a.n = n;
  a.length = length;
  auto st = static_cast<cudaStream_t>(stream);
  return rev64 ? launch_binsearch<int64_t>(a, st)
               : launch_binsearch<int32_t>(a, st);
}

extern "C" int fancy_binsearch_launch(
    const void* packed, long long packed_len, const void* nodes,
    const void* q_words, void* out, void* lane_stats, void* depth,
    void* trace, long long B, long long n, int length, int trace_cap,
    int probe, void* stream) {
  if (B <= 0) return 0;
  Args a{};
  a.packed = static_cast<const int64_t*>(packed);
  a.packed_len = packed_len;
  a.nodes = static_cast<const longlong2*>(nodes);
  a.q_words = static_cast<const int64_t*>(q_words);
  a.out = static_cast<int64_t*>(out);
  a.lane_stats = static_cast<int32_t*>(lane_stats);
  a.depth = static_cast<int32_t*>(depth);
  a.trace = static_cast<int64_t*>(trace);
  a.trace_cap = trace_cap;
  a.B = B;
  a.n = n;
  a.length = length;
  auto st = static_cast<cudaStream_t>(stream);
  switch (probe) {
    case kPrefix64: return launch_fancy<kPrefix64>(a, st);
    case kPacked: return launch_fancy<kPacked>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The builders' records of genome32 (the packed genome as int32 words
// holding uint32 bits, `words` of them), rev and, for node records, llcp
// and rlcp (int32 [n]): with llcp null plquery's rank records (out int64
// [n, 2], 16-byte aligned), else the pruned search's node records (out
// int64 [n, 4], 32-byte aligned), their first halves copied from
// rank_recs (the rank records of the same genome and rev, int64 [n, 2],
// 16-byte aligned; genome32 and rev are then not read) where it is not
// null, else gathered.
extern "C" int records_launch(const void* genome32, long long words,
                              const void* rev, int rev64, const void* llcp,
                              const void* rlcp, const void* rank_recs,
                              void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  Args a{};
  a.genome32 = static_cast<const int32_t*>(genome32);
  a.packed_len = words;
  a.rev = rev;
  a.llcp = static_cast<const int32_t*>(llcp);
  a.rlcp = static_cast<const int32_t*>(rlcp);
  a.rank_recs = static_cast<const longlong2*>(rank_recs);
  a.n = n;
  auto st = static_cast<cudaStream_t>(stream);
  auto recs = static_cast<longlong2*>(out);
  if (!llcp)
    return rev64 ? launch_records<int64_t, kRankRecords>(a, recs, st)
                 : launch_records<int32_t, kRankRecords>(a, recs, st);
  if (rank_recs) return launch_records<int32_t, kNodesFromRanks>(a, recs, st);
  return rev64 ? launch_records<int64_t, kNodeRecords>(a, recs, st)
               : launch_records<int32_t, kNodeRecords>(a, recs, st);
}

// plquery's bucket records: bucket_recs is int64 [2^buckets, 4], 32-byte
// aligned, of xlist and ylist (int64 [2^buckets + 1]) and bounds (int32
// [2^buckets], or null).
extern "C" int bucket_records_launch(const void* xlist, const void* ylist,
                                     const void* bounds, void* bucket_recs,
                                     int buckets, void* stream) {
  Args a{};
  a.xlist = static_cast<const int64_t*>(xlist);
  a.ylist = static_cast<const int64_t*>(ylist);
  a.bounds = static_cast<const int32_t*>(bounds);
  a.buckets = buckets;
  auto st = static_cast<cudaStream_t>(stream);
  bucket_records_kernel<<<blocks_for((int64_t)1 << buckets), kThreads, 0,
                          st>>>(a, static_cast<longlong2*>(bucket_recs));
  return (int)cudaGetLastError();
}
