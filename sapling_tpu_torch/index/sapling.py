"""SaplingIndex: the user-facing learned suffix-array index.

Equivalent surface to the reference's `struct Sapling`
(reference: src/sapling_api.h:17-679): the constructor-side state (genome,
rev, inv, PWL table, error bounds, chrEnds) lives as typed numpy arrays on
the host, in the same `.stpu.npz` artifact format as `sapling_tpu`, so an
artifact built by either package loads in the other. An index's `device`
is where its queries run: the card ("cuda") unless the caller asks for
"cpu". `to(device)` gives the index on another device; the arrays the
query reads there are made from the host arrays on first use
(`device_arrays`), and without a card that raises.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import IndexConfig, QueryConfig
from ..io import artifacts
from ..io.fasta import Genome, read_fasta
from ..ops import pack as packops
from ..ops.query_cuda import (binsearch_cuda, bucket_records_cuda,
                              copies_rank_records, fancy_binsearch_cuda,
                              fancy_nodes_cuda, plquery_cuda,
                              plquery_records_cuda, reads_rank_records)
from .pwl import PwlTable, build_pwl
from .suffix_array import SuffixData, build_suffix_data, lcp_ge_k_runs

# the dataclass fields an index is made of (from_arrays copies these)
_ARRAY_FIELDS = ("n", "k", "buckets", "packed", "rev", "inv", "table",
                 "chr_ends", "codes", "prefix64", "prefix3", "lcpk_fwd",
                 "lcpk_bwd", "rev_hi", "inv_hi")


def _pos_dtype(n: int, cfg: str = "auto"):
    """Rank/position STORAGE dtype on the host (the artifact's dtype)."""
    if cfg in ("int32", "int64", "uint32"):
        return np.dtype(cfg).type
    if n < np.iinfo(np.int32).max:
        return np.int32
    if n < np.iinfo(np.uint32).max - 1:
        return np.uint32
    return np.int64


def _build_dtype(pdt):
    """The native SA-IS builder emits int32/int64 only."""
    return np.int64 if np.dtype(pdt) == np.uint32 else pdt


@dataclass
class SaplingIndex:
    n: int
    k: int
    buckets: int
    packed: np.ndarray            # uint32 2-bit genome, padded
    rev: np.ndarray               # rank -> pos
    inv: np.ndarray               # pos -> rank (aligner seeds need it)
    table: PwlTable
    chr_ends: list[tuple[int, str]] = field(default_factory=list)
    codes: np.ndarray | None = None       # uint8 0..3 (host; optional)
    prefix64: np.ndarray | None = None    # uint64 per-rank 32-base prefixes
    prefix3: np.ndarray | None = None     # uint64 per-rank 21-base 3-bit
    lcpk_fwd: np.ndarray | None = None    # forward run of lcp>=k (aligner)
    lcpk_bwd: np.ndarray | None = None    # backward run of lcp>=k
    # split-limb ranks of >= 2^32-base artifacts: rev/inv hold the low 32
    # bits, these the uint8 bits 32.. (the query reassembles rev; the
    # aligner refuses them)
    rev_hi: np.ndarray | None = None
    inv_hi: np.ndarray | None = None
    device: torch.device = field(default=torch.device("cuda"))
    _device: dict = field(default_factory=dict, repr=False)
    # the pruned search's node records of the last llcp/rlcp pair
    # (fancy_nodes)
    _fancy: tuple = field(default=(), repr=False)
    # plquery's record tables on the card and the device arrays they were
    # made of (query_records)
    _records: dict = field(default_factory=dict, repr=False)

    # --- construction -------------------------------------------------------

    @classmethod
    def build(
        cls,
        genome: Genome | np.ndarray,
        cfg: IndexConfig | None = None,
        suffix: SuffixData | None = None,
        keep_aligner_arrays: bool = True,
        device="cuda",
    ) -> "SaplingIndex":
        cfg = cfg or IndexConfig()
        if isinstance(genome, Genome):
            seq, chr_ends = genome.seq, genome.chr_ends
        else:
            seq, chr_ends = np.asarray(genome, dtype=np.uint8), []
        n = int(seq.shape[0])
        buckets = cfg.resolved_buckets(n)
        pdt = _pos_dtype(n, cfg.pos_dtype)
        if suffix is None:
            suffix = build_suffix_data(seq, _build_dtype(pdt))
        codes = packops.encode_bases(seq)
        table = build_pwl(codes, suffix.inv, suffix.lcp, cfg.k, buckets,
                          cfg.most_threshold)
        packed = packops.pack_codes(codes, pad_words=16)
        rev = np.empty(n, dtype=pdt)
        rev[suffix.inv] = np.arange(n, dtype=pdt)
        want_prefix = cfg.prefix_lookup and n <= cfg.prefix_max_n
        prefix64 = packops.rank_prefix64(codes, rev) if want_prefix else None
        prefix3 = packops.rank_prefix3(codes, rev) if want_prefix else None
        idx = cls(
            n=n, k=cfg.k, buckets=buckets, packed=packed, rev=rev,
            inv=suffix.inv.astype(pdt), table=table, chr_ends=list(chr_ends),
            codes=codes, prefix64=prefix64, prefix3=prefix3,
            device=torch.device(device),
        )
        if keep_aligner_arrays:
            fwd, bwd = lcp_ge_k_runs(suffix.lcp, cfg.k)
            idx.lcpk_fwd = np.minimum(fwd, 255).astype(np.uint8)
            idx.lcpk_bwd = np.minimum(bwd, 255).astype(np.uint8)
        return idx

    @classmethod
    def from_arrays(cls, src, device="cuda") -> "SaplingIndex":
        """An index made of another index object's host arrays: any object
        with SaplingIndex's fields, such as a `sapling_tpu` SaplingIndex.
        The numpy arrays are shared, not copied."""
        return cls(**{f: getattr(src, f) for f in _ARRAY_FIELDS},
                   device=torch.device(device))

    @classmethod
    def from_fasta(cls, path: str, cfg: IndexConfig | None = None,
                   cache: bool = True, device="cuda") -> "SaplingIndex":
        """Build from a FASTA path with the reference's artifact-caching
        pattern: <path>.sa and <path>_k<k>_b<buckets>.stpu.npz are
        transparently reloaded if present, else built and written
        (reference: src/sapling_api.h:552-675)."""
        cfg = cfg or IndexConfig()
        genome = read_fasta(path)
        npz = f"{path}_k{cfg.k}_b{cfg.buckets}.stpu.npz"
        if cache and os.path.exists(npz):
            return cls.load(npz, device=device)
        sa_path = path + ".sa"
        pdt = _pos_dtype(genome.n, cfg.pos_dtype)
        bdt = _build_dtype(pdt)
        if os.path.exists(sa_path):
            inv64, lcp64 = artifacts.read_sa(sa_path)
            inv = inv64.astype(bdt)
            sa = np.empty(genome.n, dtype=bdt)
            sa[inv] = np.arange(genome.n, dtype=bdt)
            suffix = SuffixData(sa=sa, inv=inv, lcp=lcp64.astype(bdt))
        else:
            suffix = build_suffix_data(genome.seq, bdt)
            if cache:
                artifacts.write_sa(sa_path, suffix.inv, suffix.lcp)
        idx = cls.build(genome, cfg, suffix=suffix, device=device)
        if cache:
            idx.save(npz)
        return idx

    # --- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        ends = np.array([e for e, _ in self.chr_ends], dtype=np.int64)
        names = np.array([nm for _, nm in self.chr_ends])
        artifacts.save_npz(
            path,
            format_version=np.int64(4 if self.rev_hi is not None else 3),
            n=np.int64(self.n), k=np.int64(self.k),
            buckets=np.int64(self.buckets),
            packed=self.packed, rev=self.rev, inv=self.inv,
            xlist=self.table.xlist, ylist=self.table.ylist,
            stats=np.array([self.table.max_over, self.table.max_under,
                            self.table.mean_error, self.table.most_over,
                            self.table.most_under], dtype=np.int64),
            chr_end_pos=ends, chr_end_name=names,
            codes=self.codes if self.codes is not None else np.zeros(0, np.uint8),
            prefix64=(self.prefix64 if self.prefix64 is not None
                      else np.zeros(0, np.uint64)),
            prefix3=(self.prefix3 if self.prefix3 is not None
                     else np.zeros(0, np.uint64)),
            lcpk_fwd=self.lcpk_fwd if self.lcpk_fwd is not None else np.zeros(0, np.uint8),
            lcpk_bwd=self.lcpk_bwd if self.lcpk_bwd is not None else np.zeros(0, np.uint8),
            bounds=(self.table.bounds if self.table.bounds is not None
                    else np.zeros(0, np.uint32)),
            rev_hi=(self.rev_hi if self.rev_hi is not None
                    else np.zeros(0, np.uint8)),
            inv_hi=(self.inv_hi if self.inv_hi is not None
                    else np.zeros(0, np.uint8)),
        )

    # 1: pre-prefix3 artifacts; 2: +prefix3; 3: +per-bucket bounds;
    # 4: +split-limb rev_hi/inv_hi (>= 2^32-base genomes)
    SUPPORTED_FORMATS = (1, 2, 3, 4)

    @classmethod
    def load(cls, path: str, skip: tuple = (), mmap: bool = False,
             device="cuda") -> "SaplingIndex":
        """Load an artifact written by either package. skip: member names
        to leave out; an optional one loads as None, packed, rev or inv as
        an empty array (e.g. skip=("inv",) for query-only use: the inverse
        array is never read by a query). mmap=True memory-maps large members instead of
        copying them into RAM (io.artifacts.load_npz): load returns in
        milliseconds and untouched members cost no disk reads. A mapped
        member is read-only; device_arrays never hands one to a tensor
        that could be written."""
        z = artifacts.load_npz(path, skip=skip, mmap=mmap)
        for name in skip:
            z.setdefault(name, np.zeros(0, np.uint8))
        ver = int(z.get("format_version", 1))
        if ver not in cls.SUPPORTED_FORMATS:
            raise IOError(
                f"{path}: unsupported index artifact format v{ver} "
                f"(supported: {cls.SUPPORTED_FORMATS})")
        st = z["stats"]
        table = PwlTable(
            buckets=int(z["buckets"]), xlist=z["xlist"], ylist=z["ylist"],
            max_over=int(st[0]), max_under=int(st[1]), mean_error=int(st[2]),
            most_over=int(st[3]), most_under=int(st[4]),
            bounds=(z["bounds"] if "bounds" in z and z["bounds"].size
                    else None),
        )
        chr_ends = [(int(e), str(nm)) for e, nm in
                    zip(z["chr_end_pos"], z["chr_end_name"])]

        def opt(name):
            return z[name] if name in z and z[name].size else None

        return cls(
            n=int(z["n"]), k=int(z["k"]), buckets=int(z["buckets"]),
            packed=z["packed"], rev=z["rev"], inv=z["inv"], table=table,
            chr_ends=chr_ends, codes=opt("codes"), prefix64=opt("prefix64"),
            prefix3=opt("prefix3"), lcpk_fwd=opt("lcpk_fwd"),
            lcpk_bwd=opt("lcpk_bwd"), rev_hi=opt("rev_hi"),
            inv_hi=opt("inv_hi"), device=torch.device(device),
        )

    def write_reference_artifacts(self, sap_path: str) -> None:
        """Write the PWL table as the reference's .sap file (from_fasta
        writes the .sa itself)."""
        t = self.table
        artifacts.write_sap(sap_path, self.buckets, t.xlist, t.ylist,
                            t.max_over, t.max_under, t.mean_error,
                            t.most_over, t.most_under)

    # --- device state --------------------------------------------------------

    def to(self, device) -> "SaplingIndex":
        """This index on `device` (the Tensor.to idiom): self when it is
        there already, else a new index that shares the host arrays and
        makes its own device arrays on first use. self is never moved."""
        if torch.device(device) == self.device:
            return self
        return type(self).from_arrays(self, device)

    def device_arrays(self) -> dict:
        """The arrays the query and the aligner read on `self.device`,
        made on first use:

          * rev: int32 for int32 and uint32 storage (a view of the host
            array: 4 bytes a rank, read back as uint32 by
            ops.query.gather64), int64 for int64 storage, and the split
            limbs of a >= 2^32-base artifact reassembled into int64;
          * packed: the genome words widened to int64 (values < 2^32);
          * xlist / ylist: the PWL checkpoints as int64;
          * prefix64 / prefix3: int64 views of their uint64 words, or None;
          * bounds: the per-bucket window bounds as an int32 view, or None.
        """
        if not self._device:
            def view(a, dt):
                return None if a is None else self._put(a.view(dt))

            if self.rev_hi is not None:
                rev = (self.rev.astype(np.int64)
                       | (self.rev_hi.astype(np.int64) << 32))
            elif self.rev.dtype == np.int64:
                rev = self.rev
            else:
                rev = self.rev.view(np.int32)
            self._device = {
                "rev": self._put(rev),
                "packed": self._put(self.packed.astype(np.int64)),
                "xlist": self._put(self.table.xlist.astype(np.int64)),
                "ylist": self._put(self.table.ylist.astype(np.int64)),
                "prefix64": view(self.prefix64, np.int64),
                "prefix3": view(self.prefix3, np.int64),
                "bounds": view(self.table.bounds, np.int32),
            }
        return self._device

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on self.device. On the CPU the tensor
        shares the array's memory, so a read-only array (a memory-mapped
        member of load(mmap=True)) is copied first. For the card the
        tensor made from it is only read, by the copy to the device."""
        a = np.ascontiguousarray(a)
        if self.device.type == "cpu":
            return torch.from_numpy(a if a.flags.writeable else a.copy())
        with warnings.catch_warnings():
            warnings.filterwarnings(
                "ignore", "The given NumPy array is not writable")
            return torch.from_numpy(a).to(self.device)

    def device_bytes(self) -> int:
        """Bytes of the arrays device_arrays() keeps on self.device and,
        on the card, of plquery's record tables (query_records)."""
        return sum(t.numel() * t.element_size()
                   for t in (*self.device_arrays().values(),
                             *self.query_records()) if t is not None)

    def query_records(self):
        """plquery's record tables on the card: (bucket records, int64
        [2^buckets, 4], of the table; rank records, int64 [n, 2], of rev and
        the genome, or None where rev and the genome fit the card's L2 and
        a probe reads them: ops.query_cuda.reads_rank_records), made from
        the device arrays with one launch each (ops.query_cuda.
        bucket_records_cuda, plquery_records_cuda) on the first call and
        kept while those arrays stay (swap_table makes the bucket records
        anew). (None, None) on the CPU, where the plain cascade reads the
        arrays."""
        if self.device.type == "cpu":
            return None, None
        dev = self.device_arrays()
        r = self._records
        made_of = (dev["packed"], dev["rev"])
        if self._stale_records("rank_of", made_of):
            r.update(rank=plquery_records_cuda(*made_of, n=self.n)
                     if reads_rank_records(dev["rev"], dev["packed"])
                     else None, rank_of=made_of)
        made_of = (dev["xlist"], dev["ylist"], dev["bounds"])
        if self._stale_records("bucket_of", made_of):
            r.update(bucket=bucket_records_cuda(*made_of,
                                                buckets=self.buckets),
                     bucket_of=made_of)
        return r["bucket"], r["rank"]

    def _stale_records(self, name: str, made_of) -> bool:
        """Whether the record table made of `made_of` (query_records' entry
        `name`) is missing or was made of other arrays."""
        r = self._records
        return not (name in r and all(a is b for a, b in zip(r[name],
                                                             made_of)))

    def swap_table(self, table: PwlTable) -> None:
        """Replace the PWL table in place (e.g. a
        tools/retable_index.py bucket-count A/B). If the device arrays
        exist already, only the table's (xlist, ylist, bounds) are sent
        again: rev, packed and the prefix arrays stay the same tensors; the
        bucket records (query_records), if made, are made anew of them."""
        self.table = table
        self.buckets = table.buckets
        if self._device:
            self._device.update(
                xlist=self._put(table.xlist.astype(np.int64)),
                ylist=self._put(table.ylist.astype(np.int64)),
                bounds=(None if table.bounds is None
                        else self._put(table.bounds.view(np.int32))))
        if self._records:
            self.query_records()

    # --- queries -------------------------------------------------------------

    def kmerize_batch(self, codes2d: np.ndarray) -> np.ndarray:
        return packops.batch_kmers_adjusted(codes2d, self.k)

    def query_words(self, codes2d: np.ndarray) -> torch.Tensor:
        """[B, L] codes -> int64 [ceil(L/16), B] packed query words on
        self.device (word-major, ops.pack.pack_queries)."""
        return torch.from_numpy(
            packops.pack_queries(codes2d).astype(np.int64)).to(self.device)

    def query_inputs(self, codes2d: np.ndarray, fast3: bool | None = None):
        """Host-side packing of a [B, L] code batch into the query's device
        inputs on `self.device`: (x, q3, q_words). x holds the int64
        adjusted k-mers [B]. The fast3 probe answers when the index has
        prefix3, L <= min(k, 21) and `fast3` (default: on the CPU, as the
        plain cascade takes it, not on the card, where the kernel's other
        probes ran faster under the PWL prediction; the NN engine asks for
        it): q3 is then the int64 3-bit packed queries [B] and q_words
        None; otherwise q3 is None and q_words the int64 packed words
        [ceil(L/16), B]."""
        dev = self.device_arrays()
        length = int(codes2d.shape[1])
        if fast3 is None:
            fast3 = self.device.type == "cpu"
        q3 = q_words = None
        if (fast3 and dev["prefix3"] is not None
                and length <= min(self.k, packops.P3_BASES)):
            q3 = torch.from_numpy(
                packops.pack_queries3(codes2d).view(np.int64)).to(self.device)
        else:
            q_words = self.query_words(codes2d)
        x = torch.from_numpy(self.kmerize_batch(codes2d)).to(self.device)
        return x, q3, q_words

    def query_device(self, x: torch.Tensor, q3: torch.Tensor | None,
                     q_words: torch.Tensor | None, length: int,
                     qcfg: QueryConfig | None = None,
                     stats: bool = False) -> torch.Tensor:
        """plQuery over prepared device inputs (query_inputs) -> int64 [B]
        positions on `self.device`, -1 = not found: the plquery kernel on
        the card, on the index's record tables (query_records), the plain
        cascade on the CPU (ops.query_cuda.plquery_cuda; `stats` adds the
        call's rounds to ops.query.ROUNDS). Of `qcfg`, the query reads
        max_stride_steps and adaptive_bounds; the compaction flags change
        only the batch a lane runs in on the TPU, never a result, and are
        ignored here."""
        qcfg = qcfg or QueryConfig()
        dev = self.device_arrays()
        t = self.table
        bucket_recs, rank_recs = self.query_records()
        return plquery_cuda(
            dev["packed"], dev["rev"], dev["xlist"], dev["ylist"], q_words,
            x, dev["prefix64"], dev["prefix3"], q3, dev["bounds"],
            n=self.n, length=length, k=self.k, buckets=self.buckets,
            most_over=t.most_over, most_under=t.most_under,
            max_over=t.max_over, max_under=t.max_under,
            max_stride_steps=qcfg.max_stride_steps,
            adaptive_bounds=qcfg.adaptive_bounds, bucket_recs=bucket_recs,
            rank_recs=rank_recs, stats=stats)

    def query_positions(self, codes2d: np.ndarray,
                        qcfg: QueryConfig | None = None) -> np.ndarray:
        """plQuery over a [B, L] batch of base codes -> [B] positions (-1 =
        not found). Equivalent of reference plQuery (src/sapling_api.h:159)."""
        x, q3, q_words = self.query_inputs(codes2d)
        out = self.query_device(x, q3, q_words, int(codes2d.shape[1]), qcfg)
        return out.cpu().numpy()

    def binsearch_device(self, q_words: torch.Tensor, length: int,
                         llcp: torch.Tensor | None = None,
                         rlcp: torch.Tensor | None = None,
                         stats: bool = False) -> torch.Tensor:
        """The binary-search baselines over prepared device query words
        (query_words) -> int64 [B] positions on `self.device`, -1 = not
        found: the classic search (ops.query_cuda.binsearch_cuda), or with
        the int32 [n] llcp/rlcp tables on `self.device` the pruned one
        (ops.query_cuda.fancy_binsearch_cuda, with the index's prefix64
        when it has one, and on the card the node records of fancy_nodes);
        each its kernel on the card, `stats` as in query_device."""
        dev = self.device_arrays()
        if llcp is None:
            return binsearch_cuda(dev["packed"], dev["rev"], q_words,
                                  n=self.n, length=length, stats=stats)
        return fancy_binsearch_cuda(dev["packed"], dev["rev"], llcp, rlcp,
                                    q_words, n=self.n, length=length,
                                    prefix=dev["prefix64"],
                                    nodes=self.fancy_nodes(llcp, rlcp),
                                    stats=stats)

    def fancy_nodes(self, llcp: torch.Tensor,
                    rlcp: torch.Tensor) -> torch.Tensor | None:
        """The pruned search's node records of these llcp/rlcp tables on
        the card (ops.query_cuda.fancy_nodes_cuda: int64 [n, 4]), made on
        the first call with this pair and kept until another pair comes
        (the same tensor objects, not written in place since, over the
        same rev); their first halves copied from the index's rank records
        where query_records has made them (none is made for this) and the
        genome's gathers would miss the card's L2 (ops.query_cuda.
        copies_rank_records), else gathered from the genome. None on the
        CPU, where the plain search reads the tables."""
        if self.device.type == "cpu":
            return None
        dev = self.device_arrays()
        versions = (llcp._version, rlcp._version)
        f = self._fancy
        if not (f and f[0] is llcp and f[1] is rlcp and f[2] == versions
                and f[3] is dev["rev"]):
            ranks = (None if self._stale_records(
                "rank_of", (dev["packed"], dev["rev"]))
                or not copies_rank_records(dev["packed"])
                else self._records["rank"])
            self._fancy = (llcp, rlcp, versions, dev["rev"], fancy_nodes_cuda(
                dev["packed"], dev["rev"], llcp, rlcp, n=self.n,
                rank_recs=ranks))
        return self._fancy[4]

    def query_positions_binsearch(self, codes2d: np.ndarray) -> np.ndarray:
        """Classic binary-search baseline over the same device arrays."""
        return self.binsearch_device(self.query_words(codes2d),
                                     int(codes2d.shape[1])).cpu().numpy()

    def query_positions_fancy(self, codes2d: np.ndarray, llcp: np.ndarray,
                              rlcp: np.ndarray) -> np.ndarray:
        """llcp/rlcp-pruned binary search with the int32 [n] tables of
        index.suffix_array.build_llcp_rlcp (sent to the device, and on the
        card made into node records, anew each call)."""
        llcp_d, rlcp_d = (torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device) for a in (llcp, rlcp))
        return self.binsearch_device(self.query_words(codes2d),
                                     int(codes2d.shape[1]), llcp_d,
                                     rlcp_d).cpu().numpy()

    def count_hits(self, sa_ranks: np.ndarray, max_hits: int = 32):
        """Number of additional suffix-array neighbors sharing the first k
        bases with each rank: (left, right) counts, each capped at
        max_hits. Equivalent of reference countHitsLeft/countHitsRight
        (src/sapling_api.h:254-303), vectorized over the lcp>=k
        run-length arrays. The reference's off-by-one left walk can step
        to rev[-1] (UB); left is clamped to the ranks that exist."""
        n, k = self.n, self.k
        sa_ranks = np.asarray(sa_ranks)
        m = self.lcpk_fwd.shape[0]                # == n-1 lcp entries
        sp = np.clip(sa_ranks, 0, m - 1)
        fwd = np.where(sa_ranks < m, self.lcpk_fwd[sp].astype(np.int64), 0)
        bwd = np.where(sa_ranks < m, self.lcpk_bwd[sp].astype(np.int64), 0)
        # the right walk also stops at rank > n-k (":258"), a RANK cap
        right = np.minimum(np.minimum(fwd, n - k - sa_ranks + 1), max_hits)
        right = np.maximum(right, 0)
        left = np.minimum(np.minimum(bwd, max_hits), sa_ranks)
        return left, right

    def verify_hits(self, codes2d: np.ndarray, positions: np.ndarray) -> np.ndarray:
        """Self-check: does the genome substring at each position equal the
        query? (reference: src/sapling_example.cpp:143-154)."""
        if self.codes is None:
            raise ValueError("index was built without host codes")
        length = codes2d.shape[1]
        ok = (positions >= 0) & (positions + length <= self.n)
        good = np.zeros(codes2d.shape[0], dtype=bool)
        pos_ok = positions[ok]
        window = self.codes[pos_ok[:, None] + np.arange(length)]
        good[ok] = (window == codes2d[ok]).all(axis=1)
        return good
