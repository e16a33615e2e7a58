"""Piecewise-linear learned index: vectorized build + error audit.

The reference builds the PWL table with two serial full-genome sweeps
(reference: src/sapling_api.h:384-487). Here both sweeps are array programs:

  sweep 1 (checkpoints): a single stable argsort of the k-mer stream gives,
    per bucket, the (min-x, earliest-position) checkpoint in one pass
    (reference loop :409-434), plus the global-max final checkpoint (:429-433)
    and the empty-bucket forward fill (:436-449).

  sweep 2 (error audit): every k-mer is re-predicted in one vectorized shot
    and the prediction error computed with the closed-form KRMQ run-length
    shift (see index.suffix_array.lcp_ge_k_runs) instead of a per-k-mer
    binary search (reference getError :309-337).

Reference quirk preserved: getError only *shifts* under-shot actuals
(y < predict); in the y > predict branch the search result is discarded and
the raw `y - predict` returned (:326-336).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.pack import ALPHA, kmers_scan
from ..ops.predict import predict_pwl
from ..utils import parhost
from .suffix_array import lcp_ge_k_runs


@dataclass
class PwlTable:
    buckets: int          # log2 bucket count
    xlist: np.ndarray     # int64 [2^buckets + 1]
    ylist: np.ndarray     # int64 [2^buckets + 1]
    max_over: int
    max_under: int
    mean_error: int
    most_over: int
    most_under: int
    # per-bucket max |error| bounds, packed (over16 << 16) | under16,
    # 0xFFFF = clipped (fall back to the global bounds). Powers the
    # adaptive-bounds query variant (ops.query, adaptive_bounds=True):
    # the reference charges every query the GLOBAL 95th-pct/max window
    # (src/sapling_api.h:165-183), so the worst buckets set everyone's
    # bisection depth; per-bucket bounds shrink the average window, which
    # is what the gather-bound TPU engine actually pays for.
    bounds: np.ndarray | None = None   # uint32 [2^buckets]


@dataclass
class ErrorAudit:
    errors: np.ndarray            # int32 signed error per genome k-mer
    perfect_predictions: int

    def per_bin_stats(self, kmers: np.ndarray, kbits: int, buckets: int):
        """Per-bucket error statistics (parity with eval/ErrorsPerBin/
        PerBinErrors.java:5-60): max/mean/median of |error| per bin."""
        bins = (kmers >> (kbits - buckets)).astype(np.int64)
        a = np.abs(self.errors.astype(np.int64))
        nb = 1 << buckets
        order = np.argsort(bins, kind="stable")
        bs, es = bins[order], a[order]
        starts = np.searchsorted(bs, np.arange(nb))
        ends = np.searchsorted(bs, np.arange(nb) + 1)
        mx = np.zeros(nb, dtype=np.int64)
        mean = np.zeros(nb, dtype=np.float64)
        med = np.zeros(nb, dtype=np.float64)
        cnt = ends - starts
        nz = cnt > 0
        mx[nz] = np.maximum.reduceat(es, starts[nz])
        sums = np.add.reduceat(es.astype(np.float64), starts[nz])
        mean[nz] = sums / cnt[nz]
        for b in np.flatnonzero(nz):  # median needs per-group selection
            med[b] = np.median(es[starts[b] : ends[b]])
        return {"count": cnt, "max": mx, "mean": mean, "median": med}


def _fill_empty(xlist: np.ndarray, ylist: np.ndarray, nb: int):
    """Empty-bucket forward fill (reference src/sapling_api.h:436-449):
    a bucket with no k-mers inherits the previous bucket's checkpoint."""
    if xlist[0] == -1:
        xlist[0] = 0
        ylist[0] = 0
    empty = xlist == -1
    src = np.where(~empty, np.arange(nb + 1), 0)
    src = np.maximum.accumulate(src)
    return xlist[src], ylist[src]


def _stripe_kmers(c, s, e):
    """Stripe k-mer source: a materialized `kmers` array, or — for
    builds where the full int64 stream would not fit host RAM (8 bytes x
    4.7e9 positions at wheat-class scale) — derived per chunk from the
    2-bit `codes` (fork workers see codes copy-on-write)."""
    kmers = c.get("kmers")
    if kmers is not None:
        return kmers[s:e]
    from ..ops.pack import kmers_scan

    return kmers_scan(c["codes"][s : e + c["k"] - 1], c["k"])[: e - s]


def _ckpt_stripe(span):
    """Per-stripe sweep-1 reduction (see build_checkpoints_fast): dense
    per-bucket minkey plus the stripe's (max bucket, best final key)."""
    lo, hi = span
    c = parhost.ctx()
    shift = c["shift"]
    nb = c["nb"]
    chunk = c["chunk"]
    posbits = c.get("posbits", 32)
    pmask = np.int64((1 << posbits) - 1)
    sent = np.iinfo(np.int64).max
    minkey = np.full(nb, sent, dtype=np.int64)
    low_mask = np.int64((1 << shift) - 1)
    for s in range(lo, hi, chunk):
        xs = _stripe_kmers(c, s, min(s + chunk, hi))
        key = ((xs & low_mask) << posbits) | np.arange(
            s, s + xs.shape[0], dtype=np.int64)
        np.minimum.at(minkey, xs >> shift, key)
    filled = np.flatnonzero(minkey != sent)
    bmax = int(filled[-1]) if filled.size else -1
    best = -1
    if bmax >= 0:
        # final-checkpoint candidate: max x in the stripe's max bucket,
        # earliest position (pos negated into the key so the max-reduce
        # tie-breaks earliest)
        for s in range(lo, hi, chunk):
            xs = _stripe_kmers(c, s, min(s + chunk, hi))
            sel = xs >> shift == bmax
            if sel.any():
                xl = xs[sel] & low_mask
                ps = np.flatnonzero(sel).astype(np.int64) + s
                key = (xl << posbits) | (pmask - ps)
                best = max(best, int(key.max()))
    return minkey, bmax, best


def build_checkpoints_fast(kmers: np.ndarray | None, y, kbits: int,
                           buckets: int, chunk: int = 1 << 26,
                           workers: int = 1, codes: np.ndarray | None = None,
                           k: int | None = None,
                           _posbits: int | None = None):
    """Sort-free sweep 1 — bit-identical output to build_checkpoints
    without the full-stream argsort (the multi-Gbp build's dominant
    stage: ~166 s at 230 Mbp, ~45 min extrapolated to GRCh38 scale).

    Within a bucket, x varies only in its low `shift` bits, so the
    48-bit key (xlow << 32 | position) makes ONE np.minimum.at pass
    compute both the per-bucket min-x and its earliest-position
    tie-break at once (the reference's strictly-less update keeps the
    first occurrence, src/sapling_api.h:409-434). Positions pack into
    max(32, bit_length(m)) key bits, so any m with
    shift + posbits <= 63 works (wheat-class n >= 2^32 included);
    falls back to build_checkpoints otherwise.
    With workers > 1 the stream is striped over forked workers
    (utils.parhost) and the dense per-bucket keys merged — the global
    max x lives in the overall max bucket, so any stripe touching it
    reports it as its own max (monotone x >> shift).

    kmers=None derives the stream per chunk from `codes`+`k` inside the
    workers (no 8-byte-per-position array at >4 Gbp scale); `y` only
    needs fancy-indexing by the nb+1 winning positions, so a SplitInv
    shim works as well as a flat array.
    """
    nb = 1 << buckets
    shift = kbits - buckets
    m = kmers.shape[0] if kmers is not None else codes.shape[0] - k + 1
    # _posbits: test hook to exercise the wide-position keys a > 2^32
    # position stream takes, at unit-test scale
    posbits = _posbits or max(32, int(m).bit_length())
    if shift + posbits > 63:
        if kmers is None:  # tiny-bucket fallback; fine below ~2^32 only
            from ..ops.pack import kmers_scan

            kmers = kmers_scan(codes, k)
        return build_checkpoints(kmers, y, kbits, buckets)
    xlist = np.full(nb + 1, -1, dtype=np.int64)
    ylist = np.zeros(nb + 1, dtype=np.int64)
    if m > 0:
        ctx = {"shift": shift, "nb": nb, "chunk": chunk,
               "posbits": posbits}
        if kmers is not None:
            ctx["kmers"] = kmers
        else:
            ctx["codes"], ctx["k"] = codes, k
        parts = parhost.run_forked(
            _ckpt_stripe, parhost.stripes_of(m, max(1, workers)),
            ctx, workers=workers)
        minkey = parts[0][0]
        for mk, _, _ in parts[1:]:
            np.minimum(minkey, mk, out=minkey)
        bstar = max(bm for _, bm, _ in parts)
        best = max(bb for _, bm, bb in parts if bm == bstar)
        sent = np.iinfo(np.int64).max
        pmask = np.int64((1 << posbits) - 1)
        filled = np.flatnonzero(minkey != sent)
        pos = minkey[filled] & pmask
        xlist[filled] = (filled.astype(np.int64) << shift) | (
            minkey[filled] >> posbits)
        ylist[filled] = y[pos].astype(np.int64)
        xlist[nb] = (np.int64(bstar) << shift) | (best >> posbits)
        ylist[nb] = int(y[int(pmask) - (best & int(pmask))])
    xlist, ylist = _fill_empty(xlist, ylist, nb)
    return xlist, ylist


def build_checkpoints(kmers: np.ndarray, y: np.ndarray, kbits: int, buckets: int):
    """Sweep 1: per-bucket (min-x, y-of-earliest-min-x) checkpoints.

    kmers: int64 [m] k-mer value at each genome position
    y:     suffix-array rank (inv) at each position, same length
    """
    nb = 1 << buckets
    shift = kbits - buckets
    xlist = np.full(nb + 1, -1, dtype=np.int64)
    ylist = np.zeros(nb + 1, dtype=np.int64)
    if kmers.shape[0]:
        order = np.argsort(kmers, kind="stable")
        # chunked sweep over the sorted stream (multi-Gbp genomes: avoid
        # materializing xs/bs as whole extra int64 arrays)
        m = kmers.shape[0]
        chunk = 1 << 26
        prev_b = -1
        for lo in range(0, m, chunk):
            oc = order[lo : lo + chunk]
            xs = kmers[oc]
            bs = (xs >> shift).astype(np.int64)
            first = np.flatnonzero(np.diff(bs, prepend=np.int64(prev_b)))
            xlist[bs[first]] = xs[first]
            ylist[bs[first]] = y[oc[first]].astype(np.int64)
            prev_b = int(bs[-1])
        # final checkpoint: maximum x, earliest occurrence (strict-greater
        # update in the reference loop keeps the first occurrence :429-433).
        xmax = int(kmers[order[-1]])
        cnt = int(np.count_nonzero(kmers == xmax))
        pos_first_max = order[m - cnt]
        xlist[nb] = xmax
        ylist[nb] = int(y[pos_first_max])
    xlist, ylist = _fill_empty(xlist, ylist, nb)
    return xlist, ylist


def error_audit(
    kmers: np.ndarray,
    inv: np.ndarray,
    lcp: np.ndarray,
    xlist: np.ndarray,
    ylist: np.ndarray,
    k: int,
    buckets: int,
    n: int,
    chunk: int = 1 << 26,
    fwd: np.ndarray | None = None,
    workers: int = 1,
) -> ErrorAudit:
    """Sweep 2: predict every genome k-mer, record the signed shifted
    error. Chunked so multi-Gbp genomes stay within host RAM (the int64
    temporaries would otherwise be ~8 arrays x n x 8 B). Pass precomputed
    `fwd` (lcp>=k forward runs) to skip re-deriving them from lcp.
    workers > 1 fans chunks over forked workers (utils.parhost) — the
    multi-Gbp build's dominant stage, embarrassingly chunk-parallel."""
    m = kmers.shape[0]
    kbits = ALPHA * k
    if fwd is None:
        fwd, _bwd = lcp_ge_k_runs(lcp, k)
    errors = np.empty(m, dtype=np.int32)
    perfect = 0
    for lo, err, perf in parhost.run_forked(
            _audit_span, parhost.spans_of(m, chunk),
            {"kmers": kmers, "inv": inv, "fwd": fwd, "xlist": xlist,
             "ylist": ylist, "kbits": kbits, "buckets": buckets, "n": n},
            workers=workers):
        errors[lo : lo + err.shape[0]] = err
        perfect += perf
    return ErrorAudit(errors=errors, perfect_predictions=perfect)


def _audit_span(span):
    """One error_audit chunk (fork-worker body; big inputs come in
    copy-on-write via parhost.ctx())."""
    lo, hi = span
    c = parhost.ctx()
    pred = predict_pwl(_stripe_kmers(c, lo, hi), c["xlist"], c["ylist"],
                       c["kbits"], c["buckets"], c["n"], xp=np)
    if "inv_hi" in c:
        y = (c["inv"][lo:hi].astype(np.int64)
             | (c["inv_hi"][lo:hi].astype(np.int64) << 32))
    else:
        y = c["inv"][lo:hi].astype(np.int64)
    fwd = c["fwd"]
    fwd_len = fwd.shape[0]
    yc = np.minimum(y, fwd_len - 1) if fwd_len else y * 0
    runs = np.where(y < fwd_len, fwd[yc].astype(np.int64), 0) \
        if fwd_len else np.zeros_like(y)
    # under-shot actual (y < pred): shift y up toward pred, bounded by
    # the lcp>=k run (all intermediate ranks share the k-prefix).
    y_shift = np.where(y < pred, np.minimum(pred, y + runs), y)
    err = (y_shift - pred).astype(np.int32)
    if c.get("hist"):
        vals, counts = np.unique(err, return_counts=True)
        return lo, vals, counts.astype(np.int64)
    return lo, err, int(np.count_nonzero(err == 0))


class SplitInv:
    """pos -> rank fancy-indexing shim over split (uint32 lo, uint8 hi)
    limbs — the 5 B/position storage that keeps a >= 2^32-base build in
    host RAM. Quacks like the flat int64 inv array everywhere the build
    path indexes it (build_checkpoints_fast ylist gathers)."""

    def __init__(self, lo: np.ndarray, hi: np.ndarray):
        self.lo, self.hi = lo, hi
        self.shape = lo.shape

    def __getitem__(self, idx):
        return (self.lo[idx].astype(np.int64)
                | (self.hi[idx].astype(np.int64) << 32))


def error_audit_hist(
    codes: np.ndarray,
    inv_lo: np.ndarray,
    inv_hi: np.ndarray,
    fwd: np.ndarray,
    xlist: np.ndarray,
    ylist: np.ndarray,
    k: int,
    buckets: int,
    n: int,
    chunk: int = 1 << 26,
    workers: int = 1,
):
    """Sweep 2 for >= 2^32-base builds: same per-k-mer getError audit as
    error_audit, but k-mers derive per chunk from `codes`, ranks come
    from split limbs, and only the ERROR VALUE HISTOGRAM leaves the
    workers — the int32 errors array alone would be 4 bytes x n at
    wheat-class n. Returns (values int64[], counts int64[], perfect)
    with values ascending; feed to error_stats_from_hist."""
    m = codes.shape[0] - k + 1
    acc: dict[int, int] = {}
    for _lo, vals, counts in parhost.run_forked(
            _audit_span, parhost.spans_of(m, chunk),
            {"codes": codes, "k": k, "inv": inv_lo, "inv_hi": inv_hi,
             "fwd": fwd, "xlist": xlist, "ylist": ylist,
             "kbits": ALPHA * k, "buckets": buckets, "n": n, "hist": True},
            workers=workers):
        for v, cnt in zip(vals.tolist(), counts.tolist()):
            acc[v] = acc.get(v, 0) + cnt
    perfect = acc.pop(0, 0)
    vals = np.array(sorted(acc), dtype=np.int64)
    counts = np.array([acc[v] for v in vals.tolist()], dtype=np.int64)
    return vals, counts, perfect


def error_stats_from_hist(vals: np.ndarray, counts: np.ndarray,
                          perfect: int, most_threshold: float = 0.95):
    """error_stats computed from the (value, count) histogram — exact
    order-statistic semantics of the sorted-array version (reference
    errorStats, src/sapling_api.h:342-379), including its index
    truncation: the p-th element of the sorted magnitudes is read off
    the cumulative counts."""
    vals = np.asarray(vals, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int64)

    def side(mag, cnt):
        order = np.argsort(mag)
        mag, cnt = mag[order], cnt[order]
        size = int(cnt.sum())
        if size == 0:
            return 0, 0, 0, size
        mx = int(mag[-1])
        tot = int((mag * cnt).sum())
        cum = np.cumsum(cnt)
        most = int(mag[np.searchsorted(cum, int(most_threshold * size),
                                       side="right")])
        return mx, most, tot, size

    pos, neg = vals > 0, vals < 0
    max_over, most_over, tot_o, n_over = side(vals[pos], counts[pos])
    max_under, most_under, tot_u, n_under = side(-vals[neg], counts[neg])
    n_total = n_over + n_under + perfect
    max_over = max(max_over, 2)
    max_under = max(max_under, 2)
    tot = tot_o + tot_u
    mean_error = int(0.5 + tot // n_total) if n_total else 0
    most_over = max(most_over, 1)
    most_under = max(most_under, 1)
    return max_over, max_under, mean_error, most_over, most_under


def bucket_bounds(kmers: np.ndarray, errors: np.ndarray, kbits: int,
                  buckets: int, chunk: int = 1 << 26) -> np.ndarray:
    """Per-bucket max over/under prediction error, packed into uint32
    (over16 << 16) | under16, clipped at 0xFFFF (sentinel: use the global
    bounds). Chunked sort+reduceat keeps multi-Gbp audits within RAM."""
    nb = 1 << buckets
    shift = kbits - buckets
    over = np.zeros(nb, dtype=np.int64)
    under = np.zeros(nb, dtype=np.int64)
    m = kmers.shape[0]
    for lo in range(0, m, chunk):
        hi = min(lo + chunk, m)
        b = (kmers[lo:hi] >> shift).astype(np.int64)
        e = errors[lo:hi].astype(np.int64)
        order = np.argsort(b, kind="stable")
        bs, es = b[order], e[order]
        uniq = np.flatnonzero(np.diff(bs, prepend=np.int64(-1)))
        mx = np.maximum.reduceat(es, uniq)
        mn = np.minimum.reduceat(es, uniq)
        ub = bs[uniq]
        np.maximum.at(over, ub, mx)
        np.maximum.at(under, ub, -mn)
    np.clip(over, 0, 0xFFFF, out=over)
    np.clip(under, 0, 0xFFFF, out=under)
    return ((over.astype(np.uint32) << np.uint32(16))
            | under.astype(np.uint32))


def error_stats(audit: ErrorAudit, most_threshold: float = 0.95):
    """errorStats (reference :342-379), including its exact integer/index
    truncation semantics."""
    err = audit.errors  # int32; sums accumulate in int64
    overs = err[err > 0]
    unders = -err[err < 0]
    n_total = overs.size + unders.size + audit.perfect_predictions
    max_over = int(overs.max()) if overs.size else 0
    max_under = int(unders.max()) if unders.size else 0
    tot = int(overs.sum(dtype=np.int64)) + int(unders.sum(dtype=np.int64))
    max_under = max(max_under, 2)
    max_over = max(max_over, 2)
    mean_error = int(0.5 + tot // n_total) if n_total else 0  # C++ integer div
    overs.sort()   # in place: overs/unders are local copies; at multi-Gbp
    unders.sort()  # scale a second sorted copy would be ~12 GB each
    most_over = int(overs[int(most_threshold * overs.size)]) if overs.size else 0
    most_under = (
        int(unders[int(most_threshold * unders.size)]) if unders.size else 0
    )
    most_over = max(most_over, 1)
    most_under = max(most_under, 1)
    return max_over, max_under, mean_error, most_over, most_under


def build_pwl(
    codes: np.ndarray,
    inv: np.ndarray,
    lcp: np.ndarray,
    k: int,
    buckets: int,
    most_threshold: float = 0.95,
    return_audit: bool = False,
):
    """Full PWL build from 2-bit codes + suffix data."""
    n = codes.shape[0]
    kbits = ALPHA * k
    kmers = kmers_scan(codes, k)
    y = inv[: kmers.shape[0]].astype(np.int64)
    xlist, ylist = build_checkpoints(kmers, y, kbits, buckets)
    audit = error_audit(kmers, inv, lcp, xlist, ylist, k, buckets, n)
    mo, mu, me, so, su = error_stats(audit, most_threshold)
    table = PwlTable(
        buckets=buckets,
        xlist=xlist,
        ylist=ylist,
        max_over=mo,
        max_under=mu,
        mean_error=me,
        most_over=so,
        most_under=su,
        bounds=bucket_bounds(kmers, audit.errors, kbits, buckets),
    )
    if return_audit:
        return table, audit, kmers
    return table
