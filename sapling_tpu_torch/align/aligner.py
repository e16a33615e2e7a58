"""Batched seed-and-extend read aligner.

The reference SaplingAligner (reference: src/align.cpp:151-389) aligns one
read at a time: 7 seeds per strand, one plQuery each, hit expansion via
LCP runs, then one striped-SW call per candidate window, keeping the best
strictly-greater score with a perfect-match early exit.

Here the same computation runs in three batched phases over a whole block
of reads, then replays the reference's *serial selection order* so the
chosen alignment (and therefore the SAM bytes) is identical:

  phase 1 (device): one plquery over all (read, strand, seed) 16-mers;
  phase 2 (host, vectorized): seed verification + hit counting via the
    precomputed lcp>=k run-length arrays (countHitsLeft/Right semantics,
    reference: src/sapling_api.h:254-303, including the i=0-probes-
    lcp[sa_pos] quirk shared by both directions);
  phase 3 (device): decode every candidate window from the packed genome,
    score them all, select each read's winner (the first row attaining
    the read's max: the reference's strict-greater serial walk), and run
    the full forward and reverse passes on the winner rows only;
  finish (host): native banded traceback and SAM records.

The device is the aligner's `device` argument, the card by default:
phases 1 and 3 run there, with the CUDA SW kernels on the card
(ops.sw_cuda) and plain PyTorch on the CPU when the caller asks for it.
The never-populated `Sapling::sa` defect (src/align.cpp:287 reads an
empty vector) is fixed by design: seeds use inv[ref_pos].
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import AlignerConfig
from ..ops.sw import sw_align_ends, sw_align_winner_from_genome
from .cigar import Alignment, finish_alignments_batch
from .sam import sam_header, sam_record

# SSW base translation (reference: src/ssw_cpp.cpp:12-25): upper+lowercase
# acgt map to 0..3, everything else to 4 (N, mismatches everything).
_SSW_TRANS = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _SSW_TRANS[_b] = _i
    _SSW_TRANS[_b + 32] = _i  # lowercase

# uppercase ACGT only — what the reference's seed path effectively accepts
# (kmerize reads an uninitialized vals[] entry for anything else and the
# exact-match check query.compare(ref_seq) then fails; src/align.cpp:283-285)
_UPPER_ACGT = np.zeros(256, bool)
for _b in b"ACGT":
    _UPPER_ACGT[_b] = True

_COMP_CHAR = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _COMP_CHAR[_a] = _b


@dataclass
class AlignedRead:
    name: str
    seq: str
    qual: str
    aligned: bool
    strand: int = 0
    ref_name: str = ""
    alignment: Alignment | None = None

    def to_sam(self) -> str:
        return sam_record(self.name, self.seq, self.qual, self.aligned,
                          self.alignment, self.ref_name, self.strand)


class SeedExtendAligner:
    def __init__(self, index, cfg: AlignerConfig | None = None,
                 device="cuda"):
        """index: a SaplingIndex; the aligner works on its view on `device`
        (SaplingIndex.to; the card unless the caller asks for "cpu"), and
        the caller's index stays where it was."""
        self.cfg = cfg or AlignerConfig()
        if index.lcpk_fwd is None or index.lcpk_bwd is None:
            raise ValueError("index built without aligner arrays "
                             "(keep_aligner_arrays=True required)")
        if getattr(index, "inv_hi", None) is not None:
            # split-limb (>=2^32-rank) artifacts store inv as low 32 bits
            # + a separate uint8 high limb; reading idx.inv alone would
            # silently truncate ranks >= 2^32
            raise ValueError(
                "split-limb index (inv_hi present) unsupported by the "
                "aligner — ranks would truncate; build with n < 2^32")
        if index.inv is None or len(index.inv) != index.n:
            raise ValueError("index has no full inverse-rank array "
                             "(built with inv=0?) — aligner needs inv[n]")
        if self.cfg.max_hits > 255:
            raise ValueError("max_hits > 255 unsupported (uint8 run arrays)")
        if index.k != self.cfg.sapling_k:
            raise ValueError(
                f"index k={index.k} != aligner sapling_k={self.cfg.sapling_k}"
                " — build the index with IndexConfig(k=sapling_k)")
        self.device = torch.device(device)
        self.idx = index.to(self.device)
        # cumulative per-phase wall time across blocks; device phases
        # include the host's wait for their results
        self.phase_seconds: dict[str, float] = {}
        self._phase_lock = threading.Lock()

    def _add_phase(self, name: str, seconds: float) -> None:
        with self._phase_lock:
            self.phase_seconds[name] = (
                self.phase_seconds.get(name, 0.0) + seconds)

    # --- main entry ---------------------------------------------------------

    def align_block(self, reads: list) -> list[AlignedRead]:
        """Align a block of FASTQ reads; returns per-read results in input
        order. Composition of the three pipeline stages (encode -> seed
        query -> finish); align_blocks coalesces the middle stage across
        blocks."""
        prep = self._encode_block(reads)
        (positions,) = self._query_seeds([prep])
        return self._finish_block(prep, positions)

    def _encode_block(self, reads: list) -> dict:
        """Host-only stage 1: per-block byte matrices for both strands,
        seed k-mers, and the too-short-read results skeleton."""
        t0 = time.perf_counter()
        k = self.idx.k
        cfg = self.cfg
        results: list[AlignedRead | None] = [None] * len(reads)

        # encode both strands of every usable read (SSW translation; the
        # seed path additionally requires uppercase ACGT, see _UPPER_ACGT),
        # vectorized over the whole block
        nr = len(reads)
        raws = [rd.seq if isinstance(rd.seq, bytes) else rd.seq.encode()
                for rd in reads]
        lens_r = np.array([len(x) for x in raws], np.int64)
        for ri in np.flatnonzero(lens_r < k):
            rd = reads[ri]
            results[ri] = AlignedRead(
                name=rd.name, seq=_as_str(rd.seq), qual=rd.qual,
                aligned=False)
        rix = np.flatnonzero(lens_r >= k)
        lenv = lens_r[rix]
        lmax = int(lenv.max()) if len(rix) else 0
        mat = np.zeros((nr, lmax), np.uint8)
        if nr:
            allmask = np.arange(lmax)[None, :] < lens_r[:, None]
            mat[allmask] = np.frombuffer(b"".join(raws), np.uint8)
        mat = mat[rix]
        jj = np.arange(lmax)[None, :]
        colmask = jj < lenv[:, None]
        # reference revComp complements UPPERCASE ACGT only and leaves
        # every other char untouched (src/align.cpp:241-256)
        rc_raw = np.take_along_axis(
            _COMP_CHAR[mat], np.clip(lenv[:, None] - 1 - jj, 0, None),
            axis=1)
        ne = 2 * len(rix)
        codes_mat = np.zeros((ne, lmax), np.uint8)
        codes_mat[0::2] = np.where(colmask, _SSW_TRANS[mat], 0)
        codes_mat[1::2] = np.where(colmask, _SSW_TRANS[rc_raw], 0)
        seedable_mat = np.zeros((ne, lmax), bool)
        seedable_mat[0::2] = _UPPER_ACGT[mat] & colmask
        seedable_mat[1::2] = _UPPER_ACGT[rc_raw] & colmask
        lens = np.repeat(lenv, 2)
        read_of_entry = np.repeat(rix, 2)
        strand_of_entry = np.tile(np.array([0, 1], np.int64), len(rix))

        # seed offsets (reference: src/align.cpp:271-275): 0, last//(ns-1)*i,
        # last — batched over entries
        ns = cfg.num_seeds
        last = lens - k
        qpos_m = (last[:, None] // max(ns - 1, 1)) * np.arange(ns)[None, :]
        if ne:
            qpos_m[:, 0] = 0
            qpos_m[:, ns - 1] = last if ns > 1 else 0
        ei_s = np.repeat(np.arange(ne), ns)            # [S]
        qpos_s = qpos_m.ravel()                        # [S]
        gidx = qpos_s[:, None] + np.arange(k)[None, :]
        seed_kmers = codes_mat[ei_s[:, None], gidx]    # [S, k]
        valid = seedable_mat[ei_s[:, None], gidx].all(axis=1)
        self._add_phase("encode", time.perf_counter() - t0)
        return dict(reads=reads, results=results, nr=nr,
                    codes_mat=codes_mat, lens=lens,
                    read_of_entry=read_of_entry,
                    strand_of_entry=strand_of_entry,
                    ei_s=ei_s, qpos_s=qpos_s,
                    seed_kmers=seed_kmers, valid=valid)

    def _query_seeds(self, preps: list[dict]) -> list[np.ndarray]:
        """Stage 2: ONE plquery over the concatenated valid seed k-mers of
        one or more encoded blocks; returns each block's [S] position
        array (-1 for invalid seeds). Per-lane results are independent of
        batch composition, so coalescing leaves every position the same."""
        kms = [p["seed_kmers"][p["valid"]] for p in preps]
        counts = [len(x) for x in kms]
        outs: list[np.ndarray] = []
        pos_all = None
        if sum(counts):
            allk = kms[0] if len(kms) == 1 else np.concatenate(kms, axis=0)
            t0 = time.perf_counter()
            pos_all = self.idx.query_positions(allk)
            self._add_phase("query(dev)", time.perf_counter() - t0)
        off = 0
        for p, c in zip(preps, counts):
            positions = np.full(len(p["valid"]), -1, dtype=np.int64)
            if c:
                positions[p["valid"]] = pos_all[off:off + c]
            off += c
            outs.append(positions)
        return outs

    def _finish_block(self, prep: dict, positions: np.ndarray
                      ) -> list[AlignedRead]:
        """Stage 3: seed verification + hit counting, candidate SW with
        winner selection on the device, and native traceback for one
        encoded block."""
        idx, cfg = self.idx, self.cfg
        k, flank, mh = idx.k, cfg.flanking, cfg.max_hits
        reads = prep["reads"]
        results = prep["results"]
        nr = prep["nr"]
        codes_mat = prep["codes_mat"]
        lens = prep["lens"]
        read_of_entry = prep["read_of_entry"]
        strand_of_entry = prep["strand_of_entry"]
        ei_s = prep["ei_s"]
        qpos_s = prep["qpos_s"]
        seed_kmers = prep["seed_kmers"]

        _t = [time.perf_counter()]

        def _tick(name):
            now = time.perf_counter()
            self._add_phase(name, now - _t[0])
            _t[0] = now

        # --- phase 2: verify + hit counting ---------------------------------
        ref_pos = positions
        ok = (ref_pos >= 0) & (ref_pos <= idx.n - k)
        if ok.any():
            window = idx.codes[
                np.clip(ref_pos[ok, None], 0, idx.n - k)
                + np.arange(k)[None, :]
            ]
            exact = (window == seed_kmers[ok]).all(axis=1)
            tmp = np.zeros(len(positions), bool)
            tmp[np.flatnonzero(ok)[exact]] = True
            ok = tmp
        sa_pos = np.where(ok, idx.inv[np.clip(ref_pos, 0, idx.n - 1)], 0)
        left, right = idx.count_hits(sa_pos, mh)

        # verified seeds, reference sort order within each entry: ascending
        # (total, qpos, sa_pos, left, right) (src/align.cpp:301)
        okI = np.flatnonzero(ok)
        eiA = ei_s[okI]
        qpA = qpos_s[okI].astype(np.int64)
        spA = sa_pos[okI].astype(np.int64)
        lfA = left[okI].astype(np.int64)
        rgA = right[okI].astype(np.int64)
        totA = lfA + rgA + 1
        order = np.lexsort((rgA, lfA, spA, qpA, totA, eiA))
        eiA, qpA, spA, lfA, rgA, totA = (
            a[order] for a in (eiA, qpA, spA, lfA, rgA, totA))
        _tick("hits")

        # --- phase 3: superset candidate windows + batched SW ----------------
        # possible offset range per seed (reference: src/align.cpp:310-321):
        # total <= maxHits -> [-left, right]; else either [-mh/2-clamped]
        # (no best yet) or just {0}; the clamped range is a superset of {0}.
        over = lfA + rgA > mh
        lfC = np.where(over, np.minimum(lfA, mh // 2), lfA)
        rgC = np.where(over, np.minimum(rgA, mh // 2), rgA)
        counts = (lfC + rgC + 1).astype(np.int64)
        csum = np.concatenate([[0], np.cumsum(counts)])
        rep = np.repeat(np.arange(len(counts)), counts)   # seed row / cand
        off = np.arange(csum[-1]) - csum[rep] - lfC[rep]
        rp = idx.rev[spA[rep] + off].astype(np.int64)
        ln_c = lens[eiA[rep]]
        qp_c = qpA[rep]
        lo = np.maximum(rp - qp_c - flank, 0)
        hi = rp + (ln_c - qp_c) + flank
        keep = hi < idx.n                                  # off-end windows
        rep, off, lo, hi, ln_c = (a[keep] for a in (rep, off, lo, hi, ln_c))

        # Eligibility is pure geometry — known BEFORE scoring. The serial
        # walk visits an over-maxHits seed's full clamped range only while
        # no best exists, i.e. only for the read's first seed with any
        # surviving window (y0); later over-limit seeds contribute offset 0
        # alone (src/align.cpp:310-321).
        if len(rep):
            yrows = np.unique(rep)
            y0 = np.full(nr, len(eiA), np.int64)
            np.minimum.at(y0, read_of_entry[eiA[yrows]], yrows)
            cand_rd_all = read_of_entry[eiA[rep]]
            elig = ((rep == y0[cand_rd_all]) | (totA[rep] <= mh)
                    | (off == 0))
            rep, off, lo, hi, ln_c = (
                a[elig] for a in (rep, off, lo, hi, ln_c))
        _tick("windows")

        # Candidate rows were built in the reference's walk order (reads
        # partition the rows contiguously: entries fwd,rc consecutive,
        # seeds in sorted order, offsets ascending), so each read's winner
        # is its FIRST row attaining its max score: strict > keeps the
        # earliest max, and the perfect-match early exit only skips rows
        # that cannot strictly beat it.
        winners = []  # (read_i, cand_i, strand, window_start)
        cand_ei = eiA[rep]
        swkw = dict(match=cfg.match_score, mismatch=cfg.mismatch_penalty,
                    gap_open=cfg.gap_open, gap_extend=cfg.gap_extend,
                    mask_len=cfg.mask_len)
        if len(rep):
            wmax = int(ln_c.max())
            rl = (hi - lo).astype(np.int32)
            ql = ln_c.astype(np.int32)
            codes_dev = torch.from_numpy(
                np.ascontiguousarray(codes_mat[:, :wmax])).to(self.device)
            win, ends = sw_align_winner_from_genome(
                idx.device_arrays()["packed"], codes_dev, cand_ei, ql, lo,
                rl, read_of_entry[cand_ei], nr, **swkw)
            for ri in np.flatnonzero(win < len(rep)):
                w = int(win[ri])
                winners.append((int(ri), w, int(strand_of_entry[cand_ei[w]]),
                                int(lo[w])))
        _tick("sw(dev)")
        has_winner = np.zeros(nr, bool)
        for ri, *_ in winners:
            has_winner[ri] = True
        for ri, rd in enumerate(reads):
            if results[ri] is None and not has_winner[ri]:
                results[ri] = AlignedRead(
                    name=rd.name, seq=_as_str(rd.seq), qual=rd.qual,
                    aligned=False)

        # one native call finishes every winner: traceback + soft clips +
        # '='/'X' runs + mismatch counts (align.cigar.finish_alignments_batch)
        if winners:
            wi = np.array([w[1] for w in winners], np.int64)
            ris = np.array([w[0] for w in winners], np.int64)
            rows = {kk: vv[ris].copy() for kk, vv in ends.items()}
            # winner-only host windows for the native traceback
            qw = codes_mat[cand_ei[wi], :wmax].astype(np.int8)
            qw[np.arange(wmax)[None, :] >= ql[wi][:, None]] = 0
            rmax_w = int(rl[wi].max())
            rw = idx.codes[np.minimum(
                lo[wi][:, None] + np.arange(rmax_w)[None, :],
                idx.n - 1)].astype(np.int8)
            rw[np.arange(rmax_w)[None, :] >= rl[wi][:, None]] = 0
            # the winner fields use 16-row SSE pad semantics; winners whose
            # score would overflow SSW's byte kernel (score+mismatch >= 255,
            # ssw.c:835-841) take the word kernel's pad-8 fields — recompute
            # those rare rows (score itself is pad-exact, so winner
            # IDENTITY is unaffected)
            ovr = rows["score"] + cfg.mismatch_penalty >= 255
            if ovr.any():
                def put(a):
                    return torch.from_numpy(np.ascontiguousarray(a)).to(
                        self.device)

                full = sw_align_ends(put(qw[ovr]), put(ql[wi][ovr]),
                                     put(rw[ovr]), put(rl[wi][ovr]), **swkw)
                for kk in rows:
                    rows[kk][ovr] = full[kk].cpu().numpy()
            _tick("begins(dev)")
            als = finish_alignments_batch(
                qw, rw, ql[wi], rows,
                match=cfg.match_score, mismatch=cfg.mismatch_penalty,
                gap_open=cfg.gap_open, gap_extend=cfg.gap_extend)
            for (ri, _bi, strand, bleft), al in zip(winners, als):
                rd = reads[ri]
                if al is None:  # traceback failure (align.cpp:336)
                    results[ri] = AlignedRead(
                        name=rd.name, seq=_as_str(rd.seq), qual=rd.qual,
                        aligned=False)
                    continue
                gpos = al.ref_begin + bleft
                ref_name, last_end = _chr_of(idx.chr_ends, gpos)
                al.ref_begin = gpos - last_end
                results[ri] = AlignedRead(
                    name=rd.name, seq=_as_str(rd.seq), qual=rd.qual,
                    aligned=True, strand=strand, ref_name=ref_name,
                    alignment=al)
        _tick("finish")
        return results

    def align_blocks(self, blocks, workers: int = 8, coalesce: int = 2):
        """Pipeline the three stages over an iterable of read blocks,
        yielding per-block result lists in input order.

        The caller's thread encodes blocks and runs ONE coalesced
        seed-query per `coalesce` blocks (_query_seeds); finish stages
        (hit counting, candidate SW, winner selection, native traceback)
        run in a small thread pool, overlapping the next group's encode +
        query. All stages are stateless w.r.t. the read stream (the index
        is read-only); device work goes to each thread's current stream
        and every device result is copied to the host (which waits for
        it) before the host reads it."""
        import collections
        from concurrent.futures import ThreadPoolExecutor

        # make the lazy device state before threads race to make it
        self.idx.device_arrays()
        with ThreadPoolExecutor(max_workers=workers) as ex:
            pending = collections.deque()
            group: list[dict] = []

            def _flush():
                if not group:
                    return
                for prep, pos in zip(group, self._query_seeds(group)):
                    pending.append(ex.submit(self._finish_block, prep, pos))
                group.clear()

            for blk in blocks:
                group.append(self._encode_block(blk))
                if len(group) >= coalesce:
                    _flush()
                while len(pending) > workers + coalesce:
                    yield pending.popleft().result()
            _flush()
            while pending:
                yield pending.popleft().result()

    def align_fastq(self, fastq_path, out, cl: str = "align",
                    block: int = 16384, workers: int = 8,
                    coalesce: int = 2) -> None:
        """Full FASTQ -> SAM pipeline (reference: src/align.cpp:193-224).
        SAM records are written strictly in input-read order (byte parity
        with the reference's serial stream) while blocks are aligned
        through the align_blocks pipeline."""
        from ..io.fastq import read_fastq

        def _blocks():
            buf = []
            for rd in read_fastq(fastq_path):
                buf.append(rd)
                if len(buf) >= block:
                    yield buf
                    buf = []
            if buf:
                yield buf

        close = False
        if isinstance(out, str):
            out = open(out, "w")
            close = True
        try:
            out.write(sam_header(self.idx.chr_ends, cl))
            for ars in self.align_blocks(_blocks(), workers=workers,
                                         coalesce=coalesce):
                for ar in ars:
                    out.write(ar.to_sam())
        finally:
            if close:
                out.close()


def _as_str(seq) -> str:
    return seq.decode() if isinstance(seq, (bytes, bytearray)) else str(seq)


def _chr_of(chr_ends, pos: int):
    """Chromosome + its start offset for a genome position (reference:
    src/align.cpp:354-372)."""
    best_end, name = 0, "*"
    last_end = 0
    for end, nm in chr_ends:
        if end > pos and (best_end == 0 or end < best_end):
            best_end, name = end, nm
        if end <= pos and (last_end == 0 or end > last_end):
            last_end = end
    return name, last_end
