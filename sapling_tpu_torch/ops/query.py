"""Batched plQuery on PyTorch tensors: PWL predict -> escalating window ->
masked binary-search refinement, over suffix-array ranks.

The reference's query (src/sapling_api.h:159-248) walks one query at a
time. Here every lane of a [B] batch takes the same decision sequence,
with per-lane state held in int64 tensors and masked updates, on whatever
device the index arrays live on:

  * prediction is exact int64 rational math (ops.predict);
  * each probe is ONE gather of the per-rank 3-bit suffix prefix
    (`prefix3`, ops.pack.rank_prefix3) and one signed int64 compare: the
    pad value 0 sorts below every base, so the compare alone gives the
    reference's complete ordering, off-end-is-smaller included;
  * the recursive binarySearch (:133-153) is a loop over masked lanes that
    ends when every lane has resolved;
  * ranks are tracked throughout and `rev` is gathered once at the end.

This covers queries of length <= min(k, 21), where the reference never
takes its stride-scan phase C. Longer queries, and indexes without
`prefix3`, need the general cascade over the packed genome, which this
module does not have yet: `plquery_batch` refuses them.
"""

from __future__ import annotations

import torch

from .pack import P3_BASES
from .predict import predict_pwl


def make_rank_probe3(prefix3, q3, *, length: int):
    """rank -> (match, smaller) via one int64 gather of prefix3.

    prefix3 / q3 hold the shifted 3-bit encoding as int64 views of their
    uint64 words: 21 bases use bits 0..62, so every value is < 2^63 and a
    signed compare orders them as the unsigned words. `smaller` means the
    suffix at `rank` sorts below the query."""
    mask = 0
    for j in range(length):
        mask |= 7 << (60 - 3 * j)
    qm = q3 & mask

    def probe(rank):
        pm = prefix3[rank] & mask
        match = pm == qm
        return match, ~match & (qm > pm)

    return probe


def _masked_rank_bisect(probe, lo, hi, rank_res, resolved):
    """The reference binarySearch (src/sapling_api.h:133-153) over RANK
    state: all unresolved lanes bisect together until each has matched,
    hit the hi == lo+2 base case (which returns rank lo+1 unprobed) or
    run out of interval (-1)."""
    while not bool(resolved.all()):
        active = ~resolved
        base2 = hi == lo + 2
        mid = torch.where(base2, lo + 1, lo + ((hi - lo) >> 1))
        match, smaller = probe(torch.where(active, mid, 0))
        now_base = active & base2
        now_match = active & ~base2 & match
        now_fail = active & ~base2 & ~match & (lo + 1 >= hi)
        rank_res = torch.where(now_base | now_match, mid, rank_res)
        resolved = resolved | now_base | now_match | now_fail
        go = active & ~(now_base | now_match | now_fail)
        lo = torch.where(go & smaller, mid, lo)
        hi = torch.where(go & ~smaller, mid, hi)
    return rank_res


def plquery_batch(rev, xlist, ylist, prefix3, q3, x, *, n: int, length: int,
                  k: int, buckets: int, most_over: int, most_under: int,
                  max_over: int, max_under: int):
    """Batched Sapling::plQuery (reference: src/sapling_api.h:159-248) for
    queries of length <= min(k, 21).

    rev: int64 [n] rank -> pos; xlist/ylist: int64 PWL checkpoints;
    prefix3: int64 [n] per-rank 3-bit prefixes; q3: int64 [B] packed
    queries (ops.pack.pack_queries3); x: int64 [B] adjusted k-mers. All on
    one device. Returns int64 [B] text positions, -1 where the reference
    returns -1, bit-identical to `sapling_tpu`'s plquery_batch (which
    member of a duplicate run comes back included).
    """
    if prefix3 is None or q3 is None or length > min(k, P3_BASES):
        raise NotImplementedError(
            f"plquery for length {length} > min(k={k}, {P3_BASES}) or an "
            "index without prefix3 needs the general cascade, which the "
            "PyTorch port does not have yet")
    probe = make_rank_probe3(prefix3, q3, length=length)
    pred = predict_pwl(x, xlist, ylist, 2 * k, buckets, n)
    e_right = torch.clamp(pred + most_over, max=n - 1)
    e_left = torch.clamp(pred - most_under, min=0)

    # prediction probe (:161-167)
    match, dir_right = probe(pred)
    resolved = match
    rank_res = torch.where(match, pred, -1)

    # 'most' window edge probe (:171-174 / :209-213)
    need_a = ~resolved
    lo = torch.where(dir_right, pred, e_left)
    hi = torch.where(dir_right, e_right, pred)
    edge = torch.where(dir_right, e_right, e_left)
    match_a, smaller_a = probe(torch.where(need_a, edge, 0))
    hit_a = need_a & match_a
    rank_res = torch.where(hit_a, edge, rank_res)
    resolved = resolved | hit_a
    escalate = need_a & ~hit_a & torch.where(dir_right, smaller_a,
                                             ~match_a & ~smaller_a)

    # escalation to the max-error window edge
    b_right = torch.clamp(pred + max_over + 1, max=n - 1)
    b_left = torch.clamp(pred - max_under - 1, min=0)
    bedge = torch.where(dir_right, b_right, b_left)
    match_b, _ = probe(torch.where(escalate, bedge, 0))
    hit_b = escalate & match_b
    rank_res = torch.where(hit_b, bedge, rank_res)
    resolved = resolved | hit_b
    lo = torch.where(escalate, torch.where(dir_right, e_right, b_left), lo)
    hi = torch.where(escalate, torch.where(dir_right, b_right, e_left), hi)

    rank_res = _masked_rank_bisect(probe, lo, hi, rank_res, resolved)
    found = rank_res >= 0
    pos = rev[torch.where(found, rank_res, 0)]
    return torch.where(found, pos, -1)
