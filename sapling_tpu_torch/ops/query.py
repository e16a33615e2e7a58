"""Batched plQuery and the binary-search baselines on PyTorch tensors.

These are the plain versions. On the card every single-device caller runs
plquery_batch, binsearch_batch and fancy_binsearch_batch as the
hand-written kernels of ops.query_cuda (csrc/query.cu, one thread a
query, one launch a call), which return the same bits; these run on the
CPU and in the index-sharded engine (whose `take` gathers are
collectives). The kernels' record tables (plquery_records,
bucket_records, fancy_nodes) have plain twins here too.

The reference's query (src/sapling_api.h:159-248) walks one query at a
time. Here every lane of a [B] batch takes the same decision sequence,
with per-lane state held in int64 tensors and masked updates, on whatever
device the index arrays live on:

  * prediction is exact int64 rational math (ops.predict), or ranks the
    caller predicted itself (`pred64`);
  * a probe compares the query with the suffix at a suffix-array rank and
    comes in three forms with the same outcome:
      - `make_rank_probe3`: one gather of the per-rank 3-bit prefix
        (`prefix3`); ranks are tracked and `rev` is gathered once at the
        end (the fast3 path, length <= min(k, 21));
      - `make_rank_probe` with `prefix64`: one gather of the per-rank
        32-base prefix beside `rev[rank]` (length <= 32);
      - `make_rank_probe` over the packed genome (`probe_at`): gather
        `rev[rank]`, then ceil(L/16)+1 genome words at that position,
        funnel-shift them into line and XOR them with the packed query;
  * the recursive binarySearch (:133-153) is a loop over masked lanes that
    ends when every lane has resolved, one host sync per round;
  * the unbounded stride scan for queries longer than k (:184-196,
    :229-241) is capped by `max_stride_steps` and stops a lane whose edge
    can no longer move.

Lane state is int64 throughout: torch has no uint32 arithmetic on the CPU,
so uint32 values are held as int64, or stored as int32 whose bits
`gather64` reads back as uint32.

Every gather from a per-rank array (rev, prefix64, prefix3) goes through a
`take(arr, rank)` hook: `take_rank` on one device, or `make_take`'s
index-sharded gather, which reads the local rank range and combines the
ranks of an index-shard group with one all_reduce
(parallel.sharded_index).

LCP bookkeeping (loLcp/hiLcp) is dropped, as in sapling_tpu: the reference
only uses it as a compare start offset, which never changes an outcome.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..parallel.mesh import all_reduce
from .pack import BASES_PER_WORD, P3_BASES
from .predict import predict_pwl

_MASK32 = 0xFFFFFFFF

# Host loop rounds since the caller last reset them: "C" stride-scan steps
# (phase C), "D" bisection rounds (phase D and the plain binary search);
# each ends in one host sync. The kernels of ops.query_cuda add their
# deepest step counts, the same numbers, when called with stats=True. Only
# read by measurement scripts.
ROUNDS = {"C": 0, "D": 0}


class Probe(NamedTuple):
    match: torch.Tensor           # bool: full L-base match
    smaller: torch.Tensor         # bool: suffix < query (off the end included)
    off_end: torch.Tensor | None = None  # bool: compare ran off the genome
    lcp: torch.Tensor | None = None      # int64: LCP(query, suffix), <= L
    # (off_end and lcp are None on the prefix3 probe, whose callers never
    # read them: phase C does not run at length <= k)


def gather64(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[idx] as int64, where `a` is int64 or int32 holding uint32 bits."""
    v = a[idx]
    return v if v.dtype == torch.int64 else v.long() & _MASK32


class SplitRanks(NamedTuple):
    """rank -> pos values of >= 2^32-base genomes in 5 bytes a rank: `lo`
    the low 32 bits (int32 holding the uint32 bits), `hi` bits 32.. (uint8).
    int64 would take 8 bytes a rank; take_rank reassembles the int64."""

    lo: torch.Tensor
    hi: torch.Tensor


def take_rank(a, idx: torch.Tensor) -> torch.Tensor:
    """a[idx] as int64 from a per-rank array: int64, int32 holding uint32
    bits, or SplitRanks."""
    if isinstance(a, SplitRanks):
        return (a.hi[idx].long() << 32) | gather64(a.lo, idx)
    return gather64(a, idx)


def make_take(shard=None):
    """The per-rank gather of the query: take_rank, or under index sharding
    (shard = (group, shard_size)) a gather over rank-range shards.

    Each rank of `group` holds the contiguous rank range [me*size,
    (me+1)*size) of every per-rank array. A lane whose rank lives elsewhere
    gathers local index 0 and contributes 0, so after one all_reduce (SUM)
    over the group every rank holds every lane's value. The values are
    int64 before the sum (uint32 bits widened, split limbs reassembled), so
    the sum of one value and zeros is exact, negative int64 views of uint64
    words included. Every rank of the group gets the same result, so every
    later decision, and each host loop's trip count, is the same on each:
    the collectives line up."""
    if shard is None:
        return take_rank
    group, size = shard
    me = dist.get_rank(group)

    def take(arr, rank):
        owner = rank // size
        mine = owner == me
        v = take_rank(arr, torch.where(mine, rank - owner * size, 0))
        return all_reduce(torch.where(mine, v, 0), group)

    return take


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of 32-bit words held in int64 (0 gives 32). frexp's
    exponent is the bit length, exact for float64 below 2^53."""
    return 32 - torch.frexp(x.to(torch.float64)).exponent.long()


def _finish_probe(lcp_raw, q_gt, pos, *, n: int, length: int) -> Probe:
    """Cap the LCP at the genome's end and derive the compare outcome; a
    suffix that runs off the end before differing sorts below the query
    (the reference's getLcp, src/sapling_api.h:115-130)."""
    rem = torch.clamp(n - pos, max=length)
    lcp = torch.minimum(lcp_raw, rem)
    match = lcp == length
    off_end = ~match & (lcp == rem) & (rem < length)
    smaller = off_end | (~match & q_gt)
    return Probe(match=match, smaller=smaller, off_end=off_end, lcp=lcp)


def probe_at(packed, pos, q_words, *, n: int, length: int) -> Probe:
    """Compare the L-base query with the genome at text positions `pos`.

    packed:  int64 [n_words + pad] big-endian 2-bit genome words (< 2^32)
    pos:     int64 [B] text positions in [0, n)
    q_words: int64 [ceil(L/16), B] packed queries, word-major
             (ops.pack.pack_queries; bits beyond L are zero)
    """
    wq = -(-length // BASES_PER_WORD)
    sh = (pos & 15) << 1
    rsh = (32 - sh) & 31
    w0 = pos >> 4
    last = packed.shape[0] - 1
    # words past the padded array hold only bases beyond n, where the LCP
    # is capped anyway: clamp their index rather than read out of bounds
    clamp = ((n - 1) >> 4) + wq > last
    words = [packed[torch.clamp(w0 + j, max=last) if clamp else w0 + j]
             for j in range(wq + 1)]
    zero = torch.zeros_like(pos)
    lcp_words = torch.full_like(pos, wq)
    dw, qw, aw = zero, zero, zero
    seen = torch.zeros_like(pos, dtype=torch.bool)
    for j in range(wq):
        # sh == 0 takes nothing from the next word (rsh is 0 there, not 32)
        aligned = (((words[j] << sh) & _MASK32)
                   | torch.where(sh != 0, words[j + 1] >> rsh, 0))
        qj = q_words[j]
        d = aligned ^ qj
        new = ~seen & (d != 0)
        lcp_words = torch.where(new, j, lcp_words)
        dw = torch.where(new, d, dw)
        qw = torch.where(new, qj, qw)
        aw = torch.where(new, aligned, aw)
        seen = seen | new
    lcp_raw = torch.where(
        seen, lcp_words * BASES_PER_WORD + (_clz32(dw) >> 1), length)
    # the first differing base decides the order (big-endian packing)
    return _finish_probe(lcp_raw, qw > aw, pos, n=n, length=length)


def make_rank_probe(packed, rev, prefix, q_words, *, n: int, length: int,
                    take=take_rank):
    """rank [B] -> (text position, Probe).

    With `prefix` (the int64 view of ops.pack.rank_prefix64's uint64
    words) and length <= 32: gather prefix[rank] and rev[rank]
    independently and compare in masked 32-bit halves, so that all 64
    bits order as unsigned. Zero-padded short suffixes stay exact: the
    off-end test n - pos < length decides a tie at a pad base. Otherwise
    gather rev[rank], then compare against the packed genome (probe_at).
    `take(arr, rank)` does the per-rank gathers (make_take).
    """
    if prefix is not None and length <= 32:
        if length <= 16:
            mhi = ((1 << (2 * length)) - 1) << (32 - 2 * length)
            mlo = 0
        else:
            mhi = _MASK32
            mlo = (((1 << (2 * (length - 16))) - 1)
                   << (32 - 2 * (length - 16))) & _MASK32
        qhi = q_words[0] & mhi
        qlo = (q_words[1] & mlo if q_words.shape[0] > 1
               else torch.zeros_like(qhi))

        def probe(rank):
            pos = take(rev, rank)
            pw = take(prefix, rank)
            phi = (pw >> 32) & mhi
            plo = pw & mlo
            dhi = phi ^ qhi
            hi_eq = dhi == 0
            dlo = plo ^ qlo
            clz = torch.where(hi_eq, 32 + _clz32(dlo), _clz32(dhi))
            lcp_raw = torch.where(~hi_eq | (dlo != 0), clz >> 1, length)
            q_gt = (qhi > phi) | (hi_eq & (qlo > plo))
            return pos, _finish_probe(lcp_raw, q_gt, pos, n=n, length=length)

        return probe

    def probe(rank):
        pos = take(rev, rank)
        return pos, probe_at(packed, pos, q_words, n=n, length=length)

    return probe


def make_rank_probe3(prefix3, q3, *, length: int, take=take_rank):
    """rank [B] -> (rank, Probe) via one int64 gather of prefix3.

    prefix3 / q3 hold the shifted 3-bit encoding (ops.pack.rank_prefix3)
    as int64 views of their uint64 words: 21 bases use bits 0..62, so
    every value is < 2^63 and a signed compare orders them as the
    unsigned words. The pad value 0 sorts below every base, so the
    compare alone gives the reference's order, off-end-is-smaller
    included. A hit returns the rank; the caller gathers rev once.
    `take(arr, rank)` does the gather (make_take)."""
    mask = 0
    for j in range(length):
        mask |= 7 << (60 - 3 * j)
    qm = q3 & mask

    def probe(rank):
        pm = take(prefix3, rank) & mask
        match = pm == qm
        return rank, Probe(match=match, smaller=~match & (qm > pm))

    return probe


def _masked_binary_search(probe, lo, hi, res, resolved):
    """The reference binarySearch (src/sapling_api.h:133-153) over all
    unresolved lanes at once: each bisects until it matches (res = the
    probe's value), hits the hi == lo+2 base case (which returns rank
    lo+1's value without looking at its match) or runs out of interval
    (res = -1). Every unresolved lane comes in holding res = -1 and keeps
    it until it resolves, so a lane that runs out of interval needs no
    write."""
    while not bool(resolved.all()):
        ROUNDS["D"] += 1
        active = ~resolved
        base2 = hi == lo + 2
        mid = torch.where(active, torch.where(base2, lo + 1,
                                              lo + ((hi - lo) >> 1)), 0)
        val, p = probe(mid)
        now_base = active & base2
        now_match = active & ~base2 & p.match
        now_fail = active & ~base2 & ~p.match & (lo + 1 >= hi)
        res = torch.where(now_base | now_match, val, res)
        resolved = resolved | now_base | now_match | now_fail
        go = active & ~(now_base | now_match | now_fail)
        lo = torch.where(go & p.smaller, mid, lo)
        hi = torch.where(go & ~p.smaller, mid, hi)
    return res


def _lane_bounds(bounds, x, *, kbits: int, buckets: int, most_over: int,
                 most_under: int):
    """Per-lane (over, under) window bounds from the per-bucket maxima
    (index.pwl.bucket_bounds: over << 16 | under), clamped into the global
    'most' bounds so the escalation ladder stays nested (bucket within
    most within max); clipped buckets (0xFFFF) fall back to the global
    window."""
    bw = gather64(bounds, x >> (kbits - buckets))
    return (torch.clamp(bw >> 16, max=most_over),
            torch.clamp(bw & 0xFFFF, max=most_under))


def plquery_batch(packed, rev, xlist, ylist, q_words, x, prefix=None,
                  prefix3=None, q3=None, bounds=None, *, n: int, length: int,
                  k: int, buckets: int, most_over: int, most_under: int,
                  max_over: int, max_under: int,
                  max_stride_steps: int = 1 << 20,
                  adaptive_bounds: bool = False, pred64=None,
                  take=take_rank):
    """Batched Sapling::plQuery (reference: src/sapling_api.h:159-248).

    packed: int64 genome words; rev: rank -> pos (int64, or int32 holding
    uint32 bits); xlist/ylist: int64 PWL checkpoints; q_words: int64
    [ceil(L/16), B] packed queries (may be None when the fast3 path
    answers); x: int64 [B] adjusted k-mers; prefix: int64 view of the
    per-rank 32-base prefixes or None; prefix3 / q3: int64 3-bit prefixes
    and packed queries or None; bounds: per-bucket window bounds (int32
    holding uint32 bits). All on one device.

    The fast3 probe answers when prefix3 and q3 are given and length <=
    min(k, 21); the general probe (prefix64 up to 32 bases, else the
    packed genome) answers everything else. Both run one cascade.

    adaptive_bounds: probe the lane's bucket's own max-error window before
    the reference's global windows, as sapling_tpu does with the flag;
    results stay verified hits / -1s but which member of a duplicate run
    comes back can differ from the reference.

    pred64: int64 [B] predicted ranks in [0, n) that replace the PWL
    prediction (for another predictor); the caller passes the most/max
    windows measured for that predictor.

    take: the per-rank gather (make_take): rev, prefix and prefix3 may be
    rank-range shards whose gathers combine over an index-shard group.

    Returns int64 [B] text positions, -1 where the reference returns -1,
    bit-identical to `sapling_tpu`'s plquery_batch on the same arguments
    (which member of a duplicate run comes back included).
    """
    if adaptive_bounds and bounds is None:
        raise ValueError("adaptive_bounds=True needs the bounds array")
    fast3 = (prefix3 is not None and q3 is not None
             and length <= min(k, P3_BASES))
    if fast3:
        probe = make_rank_probe3(prefix3, q3, length=length, take=take)
    elif q_words is None:
        raise ValueError(f"length {length} at k={k} takes the general "
                         "path, which needs q_words")
    else:
        probe = make_rank_probe(packed, rev, prefix, q_words, n=n,
                                length=length, take=take)
    pred = (predict_pwl(x, xlist, ylist, 2 * k, buckets, n)
            if pred64 is None else pred64)
    e_right = torch.clamp(pred + most_over, max=n - 1)
    e_left = torch.clamp(pred - most_under, min=0)

    # prediction probe (:161-167): suffix at pred < query -> search right
    val, p0 = probe(pred)
    resolved = p0.match
    res = torch.where(resolved, val, -1)
    dir_right = p0.smaller

    if adaptive_bounds:
        # this bucket's own max-error window, before the 'most' window
        bo, bu = _lane_bounds(bounds, x, kbits=2 * k, buckets=buckets,
                              most_over=most_over, most_under=most_under)
        a_right = torch.clamp(pred + bo, max=n - 1)
        a_left = torch.clamp(pred - bu, min=0)
        aedge = torch.where(dir_right, a_right, a_left)
        val, p1 = probe(torch.where(resolved, 0, aedge))
        hit1 = ~resolved & p1.match
        res = torch.where(hit1, val, res)
        resolved = resolved | hit1
        need_a = ~resolved & torch.where(dir_right, p1.smaller,
                                         ~p1.match & ~p1.smaller)
        lo = torch.where(dir_right, pred, a_left)
        hi = torch.where(dir_right, a_right, pred)
    else:
        need_a = ~resolved
        lo = torch.where(dir_right, pred, e_left)
        hi = torch.where(dir_right, e_right, pred)

    # --- phase A: 'most' window edge (:171-174 right, :209-213 left) ---
    edge = torch.where(dir_right, e_right, e_left)
    val, pa = probe(torch.where(need_a, edge, 0))
    hit_a = need_a & pa.match
    res = torch.where(hit_a, val, res)
    resolved = resolved | hit_a
    # escalation (:175 right-still-smaller, :214/:221 left-still-bigger)
    escalate = need_a & ~hit_a & torch.where(dir_right, pa.smaller,
                                             ~pa.match & ~pa.smaller)
    if adaptive_bounds:
        lo = torch.where(need_a, torch.where(dir_right, a_right, e_left), lo)
        hi = torch.where(need_a, torch.where(dir_right, e_right, a_left), hi)

    # --- phase B: 'max' window edge (:180-183 right, :225-228 left) ---
    b_right = torch.clamp(pred + max_over + 1, max=n - 1)
    b_left = torch.clamp(pred - max_under - 1, min=0)
    bedge = torch.where(dir_right, b_right, b_left)
    val, pb = probe(torch.where(escalate, bedge, 0))
    hit_b = escalate & pb.match
    res = torch.where(hit_b, val, res)
    resolved = resolved | hit_b
    lo = torch.where(escalate, torch.where(dir_right, e_right, b_left), lo)
    hi = torch.where(escalate, torch.where(dir_right, b_right, e_left), hi)

    # --- phase C: stride scan, only for queries longer than k (:184-196,
    # :229-241). The reference's loop is unbounded and can livelock at the
    # array ends; it is capped here, and a lane stops when its edge can't
    # advance.
    if length > k:
        act = escalate & ~resolved & torch.where(
            dir_right, pb.smaller & ~pb.off_end, ~pb.match & ~pb.smaller)
        steps = 0
        while steps < max_stride_steps and bool(act.any()):
            steps += 1
            ROUNDS["C"] += 1
            new_lo = torch.where(dir_right, hi,
                                 torch.clamp(lo - max_under, min=0))
            new_hi = torch.where(dir_right,
                                 torch.clamp(hi + max_over, max=n - 1), lo)
            probe_at_rank = torch.where(dir_right, new_hi, new_lo)
            stuck = probe_at_rank == torch.where(dir_right, hi, lo)
            lo = torch.where(act, new_lo, lo)
            hi = torch.where(act, new_hi, hi)
            val, pc = probe(torch.where(act, probe_at_rank, 0))
            hit = act & pc.match
            res = torch.where(hit, val, res)
            resolved = resolved | hit
            keep = torch.where(dir_right, pc.smaller & ~pc.off_end,
                               ~pc.match & ~pc.smaller)
            act = act & ~hit & keep & ~stuck

    # --- phase D: masked binary search (:245-247) ---
    res = _masked_binary_search(probe, lo, hi, res, resolved)
    if not fast3:
        return res
    found = res >= 0
    return torch.where(found, take(rev, torch.where(found, res, 0)), -1)


def binsearch_batch(packed, rev, q_words, *, n: int, length: int,
                    take=take_rank):
    """Batched classic suffix-array binary search, the baseline Sapling is
    measured against (reference: src/binarysearch.cpp:38-58,158-165).

    Like the reference's bQuery it probes rank 0 and rank n-1 first, then
    searches [0, n-1]. The reference's recursion has no not-found guard
    and can recurse forever on an absent query; those lanes resolve to -1.
    take: the per-rank gather (make_take). Returns int64 [B] positions,
    bit-identical to `sapling_tpu`'s."""
    zero = torch.zeros(q_words.shape[1], dtype=torch.int64,
                       device=q_words.device)
    probe = make_rank_probe(packed, rev, None, q_words, n=n, length=length,
                            take=take)
    pos_lo, p_lo = probe(zero)
    res = torch.where(p_lo.match, pos_lo, -1)
    resolved = p_lo.match
    pos_hi, p_hi = probe(zero + (n - 1))
    hit = ~resolved & p_hi.match
    res = torch.where(hit, pos_hi, res)
    resolved = resolved | hit
    return _masked_binary_search(probe, zero, zero + (n - 1), res, resolved)


def fancy_binsearch_batch(packed, rev, llcp, rlcp, q_words, *, n: int,
                          length: int, prefix=None):
    """Manber-Myers llcp/rlcp-pruned binary search, batched.

    The reference ships it as `fancyBinarySearch` (src/binarysearch.cpp:
    90-153) but its bQuery never calls it, and its midpoint tables are
    built over (0, n-k) while it searches (0, n-1). This follows the
    intended algorithm with tables over the search interval
    (index.suffix_array.build_llcp_rlcp; int32 [n] tensors here).

    Per round every lane gathers its llcp/rlcp entries and probes the
    genome only when they equal its boundary LCP. The trip count is fixed,
    log2(n) + 2, as every branch halves the interval, so the loop needs no
    host sync. `prefix` (the int64 view of prefix64) gives the prefix64
    probe at length <= 32, with the packed probe's outcome and LCP.
    Returns int64 [B] positions, bit-identical to `sapling_tpu`'s."""
    zero = torch.zeros(q_words.shape[1], dtype=torch.int64,
                       device=q_words.device)
    probe = make_rank_probe(packed, rev, prefix, q_words, n=n,
                            length=length)
    # bQuery's pre-probes of rank 0 / n-1 (binarysearch.cpp:158-163); their
    # LCPs seed loLcp/hiLcp
    pos0, p0 = probe(zero)
    res = torch.where(p0.match, pos0, -1)
    resolved = p0.match
    pos1, p1 = probe(zero + (n - 1))
    hit = ~resolved & p1.match
    res = torch.where(hit, pos1, res)
    resolved = resolved | hit
    lo, hi = zero, zero + (n - 1)
    lo_lcp, hi_lcp = p0.lcp, p1.lcp
    base_rank = zero - 1
    for _ in range(max((n - 1).bit_length() + 2, 2)):
        live = ~resolved & (base_rank < 0)
        nf = live & (hi == lo + 1)          # :93 -> n+1 sentinel -> -1
        resolved = resolved | nf
        b2 = live & ~nf & (hi == lo + 2)    # :94 -> rank lo+1, unprobed
        base_rank = torch.where(b2, lo + 1, base_rank)
        active = live & ~nf & ~b2

        mid = lo + ((hi - lo) >> 1)
        ll = gather64(llcp, mid)
        rl = gather64(rlcp, mid)
        cond_a = lo_lcp >= hi_lcp
        r_np = active & torch.where(cond_a, ll > lo_lcp, rl < hi_lcp)
        l_np = active & torch.where(cond_a, ll < lo_lcp, rl > hi_lcp)
        need = active & ~r_np & ~l_np       # llcp/rlcp == boundary: probe
        pos, p = probe(torch.where(need, mid, 0))
        m_hit = need & p.match
        res = torch.where(m_hit, pos, res)
        resolved = resolved | m_hit
        pr = need & ~p.match & p.smaller    # suffix too small -> right
        pl = need & ~p.match & ~p.smaller
        lo = torch.where(r_np | pr, mid, lo)
        hi = torch.where(l_np | pl, mid, hi)
        lo_lcp = torch.where(~cond_a & r_np, rl, lo_lcp)
        lo_lcp = torch.where(pr, p.lcp, lo_lcp)
        hi_lcp = torch.where(cond_a & l_np, ll, hi_lcp)
        hi_lcp = torch.where(pl, p.lcp, hi_lcp)
    # base-case lanes return rev[lo+1] unverified, like the reference's base
    # case (and the plain search's)
    has_base = base_rank >= 0
    return torch.where(has_base,
                       gather64(rev, torch.where(has_base, base_rank, 0)),
                       res)


def plquery_records(packed, rev, *, n: int) -> torch.Tensor:
    """plquery's rank records (csrc/query.cu's records_kernel builds
    the same on the card): int64 [n, 2], a rank r's row the first 32 bases
    of the suffix at rev[r] (two aligned genome words, big-endian 2-bit
    codes, word indexes clamped to the array as probe_at clamps them; the
    uint64's bits) and rev[r]."""
    pos = gather64(rev, torch.arange(n, device=packed.device))
    sh = (pos & 15) << 1
    last = packed.shape[0] - 1
    w = [packed[torch.clamp((pos >> 4) + j, max=last)] for j in range(3)]
    # sh == 0 takes nothing from the next word (a word >> 32 is 0)
    hi, lo = (((w[j] << sh) & _MASK32) | (w[j + 1] >> (32 - sh))
              for j in range(2))
    key = torch.where(hi >= 1 << 31, hi - (1 << 32), hi) * (1 << 32) + lo
    return torch.stack([key, pos], dim=1)


def rank_sample(rank_recs, *, n: int, shift: int) -> torch.Tensor:
    """The sample of the rank records' keys that plquery_kernel's sampled
    forms (csrc/query.cu) read: int64 [((n - 1) >> shift) + 2], entry e
    the key (rank_recs[r, 0]) of rank r = min(e << shift, n - 1), its
    bases past the genome's end (at and past n - rank_recs[r, 1]) zero,
    so that the entries rise with e as the suffixes do."""
    ranks = torch.clamp(torch.arange(((n - 1) >> shift) + 2,
                                     device=rank_recs.device) << shift,
                        max=n - 1)
    rec = rank_recs[ranks]
    bases = torch.clamp(n - rec[:, 1], max=32)
    return rec[:, 0] & (torch.full_like(bases, -1) << (64 - 2 * bases))


# a bucket record's m that says "read ylist[bucket + 1]" (csrc/query.cu's
# kWideM)
WIDE_M = _MASK32


def bucket_records(xlist, ylist, bounds=None, *, buckets: int
                   ) -> torch.Tensor:
    """plquery's bucket records (csrc/query.cu's bucket_records_kernel
    builds the same on the card): int64 [2^buckets, 4], a bucket b's row
    xlist[b], xlist[b + 1], ylist[b] and m | bounds[b] << 32 (the uint64's
    bits), m = ylist[b + 1] - ylist[b] where it lies in [0, WIDE_M), else
    WIDE_M; bounds 0 without the array."""
    nb = 1 << buckets
    ylo = ylist[:nb]
    m = ylist[1:nb + 1] - ylo
    m32 = torch.where((m >= 0) & (m < WIDE_M), m, WIDE_M)
    bw = (torch.zeros_like(ylo) if bounds is None
          else bounds[:nb].long() & _MASK32)
    word = torch.where(bw >= 1 << 31, bw - (1 << 32), bw) * (1 << 32) + m32
    return torch.stack([xlist[:nb], xlist[1:nb + 1], ylo, word], dim=1)


def fancy_nodes(packed, rev, llcp, rlcp, *, n: int) -> torch.Tensor:
    """The pruned search's node records (csrc/query.cu's records_kernel
    builds the same on the card): int64 [n, 4], a rank r's row its rank
    record (plquery_records: the first 32 bases of the suffix at rev[r],
    rev[r]), llcp[r] | rlcp[r] << 32, and 0."""
    lcps = (rlcp[:n].long() << 32) | (llcp[:n].long() & _MASK32)
    return torch.cat([plquery_records(packed, rev, n=n),
                      torch.stack([lcps, torch.zeros_like(lcps)], dim=1)],
                     dim=1)
