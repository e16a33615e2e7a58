"""The plain reference of exact lookups, and the comparison that decides
`correct`.

Sapling's contract for a query of length L >= k: where the query occurs
in the genome, the answer is a position p with genome[p:p+L] == query
(any occurrence); where it does not occur, the answer is -1 or a position
that does not hold it (the reference does not verify its last probe), and
never one outside the genome. The reference
works that out from the genome alone, in plain PyTorch, with no code or
array of the program:

  * a table of the genome's `width`-base keys (2 bits a base, so up to 31
    bases fit an int64), sorted with their positions (`KeyTable`);
  * a query of L <= width occurs where some key starts with it: a range
    of the sorted keys; positions past the table's last (fewer than
    `width` bases left) are compared one by one;
  * a query of L > width can occur only at a position whose key equals
    its first `width` bases: each such candidate is compared base by base.

`judge` holds a program's answers to it: a position is checked by reading
the genome there; a query whose answer does not hold it is asked whether
it occurs. It runs on the device of the genome tensor it is given, in
blocks of queries.
"""

from __future__ import annotations

import torch

KEY_BASES = 31          # the widest key that fits an int64 (62 bits)
_PAIRS_PER_BLOCK = 1 << 24


def _keys(codes: torch.Tensor, width: int, count: int) -> torch.Tensor:
    """int64 [count] keys of the `width` bases starting at 0..count-1 of
    the uint8 code vector `codes`, the first base the most significant."""
    key = torch.zeros(count, dtype=torch.int64, device=codes.device)
    for j in range(width):
        key = key * 4 + codes[j:j + count].to(torch.int64)
    return key


def _row_keys(rows: torch.Tensor, width: int) -> torch.Tensor:
    """int64 [B] keys of the first `width` columns of uint8 [B, L] rows."""
    key = torch.zeros(rows.shape[0], dtype=torch.int64, device=rows.device)
    for j in range(width):
        key = key * 4 + rows[:, j].to(torch.int64)
    return key


class KeyTable:
    """The genome's `width`-base keys, sorted, with their positions (the
    smallest position first among equal keys)."""

    def __init__(self, genome: torch.Tensor, width: int = KEY_BASES):
        self.genome = genome
        self.n = int(genome.shape[0])
        self.width = min(width, self.n)
        count = self.n - self.width + 1
        self.keys, self.pos = torch.sort(
            _keys(genome, self.width, count), stable=True)

    def ranges(self, lo_key: torch.Tensor, hi_key: torch.Tensor):
        """[lo, hi) of the sorted keys within [lo_key, hi_key]."""
        return (torch.searchsorted(self.keys, lo_key),
                torch.searchsorted(self.keys, hi_key, right=True))

    def matches_at(self, rows: torch.Tensor, pos: torch.Tensor):
        """bool [B]: genome[pos:pos+L] == rows (uint8 [B, L]); False where
        the window runs past the genome or pos < 0."""
        length = rows.shape[1]
        ok = (pos >= 0) & (pos <= self.n - length)
        at = torch.where(ok, pos, torch.zeros_like(pos))
        idx = at[:, None] + torch.arange(length, device=pos.device)
        return ok & (self.genome[idx] == rows).all(dim=1)

    def occurs(self, rows: torch.Tensor) -> torch.Tensor:
        """bool [B]: whether each query (uint8 [B, L] codes) occurs in the
        genome."""
        b, length = rows.shape
        dev = rows.device
        if b == 0 or length > self.n:
            return torch.zeros(b, dtype=torch.bool, device=dev)
        width = self.width
        if length <= width:
            shift = 2 * (width - length)
            lo_key = _row_keys(rows, length) << shift
            lo, hi = self.ranges(lo_key, lo_key + ((1 << shift) - 1))
            found = hi > lo
            # starts past the table's last key: fewer than `width` bases
            for p in range(self.n - width + 1, self.n - length + 1):
                found |= self.matches_at(
                    rows, torch.full((b,), p, dtype=torch.int64, device=dev))
            return found
        lo, hi = self.ranges(*(2 * (_row_keys(rows, width),)))
        found = torch.zeros(b, dtype=torch.bool, device=dev)
        todo = torch.nonzero(hi > lo).flatten()
        offset = 0
        while todo.numel():
            # the offset-th candidate of every query not yet found
            found[todo] = self.matches_at(rows[todo],
                                          self.pos[lo[todo] + offset])
            offset += 1
            todo = todo[(~found[todo]) & (lo[todo] + offset < hi[todo])]
        return found


def judge(table: KeyTable, rows: torch.Tensor,
          answers: torch.Tensor) -> dict:
    """Counts of a program's answers to the queries `rows` (uint8 [B, L]
    codes on the table's device):

      * `missed`: a query that occurs, answered -1 or with a position
        that does not hold it (wrong);
      * `out_of_range`: a query that does not occur, answered below -1 or
        past the genome (wrong);
      * `absent`, `absent_unanswered`: queries that do not occur, and
        those of them answered -1. Sapling answers such a query -1 or with
        an unverified position (its bisection's base case returns rank
        lo + 1 without a compare, sapling_api.h:133-153), so neither is
        wrong.
    """
    answers = answers.to(rows.device, torch.int64)
    out = dict.fromkeys(("missed", "out_of_range", "absent",
                         "absent_unanswered"), 0)
    step = max(1, _PAIRS_PER_BLOCK // max(1, rows.shape[1]))
    for lo in range(0, rows.shape[0], step):
        r, a = rows[lo:lo + step], answers[lo:lo + step]
        other = torch.nonzero(~table.matches_at(r, a)).flatten()
        occurs = table.occurs(r[other])
        absent = a[other[~occurs]]
        out["missed"] += int(occurs.sum())
        out["out_of_range"] += int(((absent < -1) | (absent >= table.n)).sum())
        out["absent"] += int(absent.numel())
        out["absent_unanswered"] += int((absent == -1).sum())
    return out


def kmer_only_answers(table: KeyTable, rows: torch.Tensor) -> torch.Tensor:
    """The control: answers that check only the first `table.width` bases
    of each query (a k-mer table's lookup, its first occurrence), never
    the rest; -1 where the k-mer is absent. It breaks the guarantee that
    a position answered holds the whole query."""
    width = min(table.width, rows.shape[1])
    key = _row_keys(rows, width) << (2 * (table.width - width))
    lo = torch.searchsorted(table.keys, key)
    at = lo.clamp(max=table.keys.numel() - 1)
    hit = (lo < table.keys.numel()) & (table.keys[at] == key)
    return torch.where(hit, table.pos[at], torch.full_like(lo, -1))
