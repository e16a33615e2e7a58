"""ctypes bindings to the native C++ substrate (SA-IS, Kasai LCP, SW traceback).

Host-side, build-time / per-best-candidate work lives here; all batched
query-time compute is PyTorch and CUDA (see sapling_tpu_torch.ops).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from .build import build_native


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_native())
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.stpu_sais_u8_i32.argtypes = [u8p, i32p, ctypes.c_int64]
    lib.stpu_sais_u8_i32.restype = ctypes.c_int
    lib.stpu_sais_u8_i64.argtypes = [u8p, i64p, ctypes.c_int64]
    lib.stpu_sais_u8_i64.restype = ctypes.c_int
    lib.stpu_lcp_kasai_i32.argtypes = [u8p, i32p, ctypes.c_int64, i32p, i32p]
    lib.stpu_lcp_kasai_i32.restype = ctypes.c_int
    lib.stpu_lcp_kasai_i64.argtypes = [u8p, i64p, ctypes.c_int64, i64p, i64p]
    lib.stpu_lcp_kasai_i64.restype = ctypes.c_int
    i8p = ctypes.POINTER(ctypes.c_int8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.stpu_lcp_ge_k_fwd_i64.argtypes = [
        u8p, i64p, ctypes.c_int64, ctypes.c_int64, u32p, u8p,
        ctypes.POINTER(ctypes.c_int32)]
    lib.stpu_lcp_ge_k_fwd_i64.restype = ctypes.c_int
    lib.stpu_banded_cigar.argtypes = [
        i8p, i8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, u32p, ctypes.c_int32,
    ]
    lib.stpu_banded_cigar.restype = ctypes.c_int32
    lib.stpu_finish_batch.argtypes = [
        i8p, ctypes.c_int32, i8p, ctypes.c_int32, i32p, i32p, i32p, i32p,
        i32p, i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, u32p, ctypes.c_int32, i32p, i32p,
    ]
    lib.stpu_finish_batch.restype = ctypes.c_int32
    return lib


def _as_u8(text: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(text)
    if a.dtype != np.uint8:
        raise TypeError(f"text must be uint8, got {a.dtype}")
    return a


def build_suffix_array(text: np.ndarray, index_dtype=None) -> np.ndarray:
    """SA-IS suffix array of a uint8 text. Returns sa with sa[rank]=pos.

    index_dtype defaults to int32 when it fits, else int64 (reference's
    offline pipeline patches divsufsort to int64 for >2^31 genomes:
    suffixarray/refToSuffixArray.sh:12).
    """
    a = _as_u8(text)
    n = a.shape[0]
    if index_dtype is None:
        index_dtype = np.int32 if n < np.iinfo(np.int32).max else np.int64
    sa = np.empty(n, dtype=index_dtype)
    if n == 0:
        return sa
    lib = _lib()
    ptr = a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    if np.dtype(index_dtype) == np.int32:
        rc = lib.stpu_sais_u8_i32(
            ptr, sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n
        )
    else:
        rc = lib.stpu_sais_u8_i64(
            ptr, sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n
        )
    if rc != 0:
        raise RuntimeError(f"stpu_sais failed rc={rc}")
    return sa


def lcp_kasai(text: np.ndarray, sa: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Kasai LCP. Returns (inv, lcp): inv[pos]=rank, lcp has length n-1.

    Semantics identical to reference src/sa.h:192-210 / addlcp.cpp:19-50.
    """
    a = _as_u8(text)
    n = a.shape[0]
    sa = np.ascontiguousarray(sa)
    inv = np.empty(n, dtype=sa.dtype)
    lcp = np.zeros(max(n - 1, 0), dtype=sa.dtype)
    if n == 0:
        return inv, lcp
    lib = _lib()
    ptr = a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    if sa.dtype == np.int32:
        rc = lib.stpu_lcp_kasai_i32(
            ptr,
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n,
            inv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            lcp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
    elif sa.dtype == np.int64:
        rc = lib.stpu_lcp_kasai_i64(
            ptr,
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
            inv.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            lcp.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
    else:
        raise TypeError(f"sa dtype must be int32/int64, got {sa.dtype}")
    if rc != 0:
        raise RuntimeError(f"stpu_lcp_kasai failed rc={rc}")
    return inv, lcp


def lcp_ge_k_fwd_split(text: np.ndarray, sa: np.ndarray, k: int):
    """Fused Kasai for n >= 2^32 genomes: returns (inv_lo uint32,
    inv_hi uint8, fwd int32) — the split-limb inverse SA plus the
    `lcp >= k` forward run lengths (fwd[r] over ranks, length n-1; same
    convention as index.suffix_array.lcp_ge_k_runs) — WITHOUT
    materializing the int64 LCP array (8n bytes it saves is what makes a
    >4.3 Gbp host build fit in RAM). sa must be int64."""
    a = _as_u8(text)
    n = a.shape[0]
    sa = np.ascontiguousarray(sa)
    if sa.dtype != np.int64:
        raise TypeError(f"sa must be int64, got {sa.dtype}")
    inv_lo = np.empty(n, dtype=np.uint32)
    inv_hi = np.empty(n, dtype=np.uint8)
    fwd = np.zeros(max(n - 1, 0), dtype=np.int32)
    if n == 0:
        return inv_lo, inv_hi, fwd
    lib = _lib()
    rc = lib.stpu_lcp_ge_k_fwd_i64(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, k,
        inv_lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        inv_hi.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        fwd.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError(f"stpu_lcp_ge_k_fwd failed rc={rc}")
    return inv_lo, inv_hi, fwd


def banded_cigar(ref_codes: np.ndarray, read_codes: np.ndarray, score: int,
                 match: int, mismatch: int, gap_open: int, gap_extend: int,
                 band_width: int) -> np.ndarray | None:
    """Banded DP traceback over the aligned region -> M/I/D cigar ints.

    ref_codes/read_codes: int8 base codes of the ALIGNED slices only
    (ref[ref_begin:ref_end+1], read[read_begin:read_end+1]). Returns None
    on traceback failure (the caller skips the candidate, matching
    reference src/align.cpp:336).
    """
    ref_codes = np.ascontiguousarray(ref_codes, dtype=np.int8)
    read_codes = np.ascontiguousarray(read_codes, dtype=np.int8)
    cap = int(read_codes.shape[0] + ref_codes.shape[0] + 4)
    out = np.empty(cap, dtype=np.uint32)
    lib = _lib()
    n = lib.stpu_banded_cigar(
        ref_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        read_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ref_codes.shape[0], read_codes.shape[0], score,
        match, mismatch, gap_open, gap_extend, band_width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), cap,
    )
    if n == -1:
        return None
    if n < 0:
        raise RuntimeError(f"stpu_banded_cigar rc={n}")
    return out[:n].copy()


def finish_batch(q: np.ndarray, r: np.ndarray, ql: np.ndarray,
                 score: np.ndarray, ref_begin: np.ndarray,
                 ref_end: np.ndarray, read_begin: np.ndarray,
                 read_end: np.ndarray, *, match: int, mismatch: int,
                 gap_open: int, gap_extend: int):
    """Batched banded traceback + SSW post-processing for winning rows.

    q/r: [B, W]/[B, R] int8 full read / full ref-window codes; the other
    arrays are per-row int32 endpoint fields from ops.sw.sw_align_ends.
    Returns (cigars [B, cap] uint32, n_ops [B] int32 with -1 = traceback
    failure, mismatches [B] int32) — final SAM cigars including soft clips
    and '='/'X' runs (reference: src/ssw_cpp.cpp:54-210).
    """
    q = np.ascontiguousarray(q, dtype=np.int8)
    r = np.ascontiguousarray(r, dtype=np.int8)
    b = q.shape[0]
    cap = int(q.shape[1] + r.shape[1] + 8)
    out = np.empty((b, cap), dtype=np.uint32)
    n_ops = np.empty(b, dtype=np.int32)
    mism = np.empty(b, dtype=np.int32)
    if b == 0:
        return out, n_ops, mism
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)  # noqa: E731
    ql, score, ref_begin, ref_end, read_begin, read_end = map(
        i32, (ql, score, ref_begin, ref_end, read_begin, read_end))
    i8p = ctypes.POINTER(ctypes.c_int8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = _lib().stpu_finish_batch(
        q.ctypes.data_as(i8p), q.shape[1], r.ctypes.data_as(i8p), r.shape[1],
        ql.ctypes.data_as(i32p), score.ctypes.data_as(i32p),
        ref_begin.ctypes.data_as(i32p), ref_end.ctypes.data_as(i32p),
        read_begin.ctypes.data_as(i32p), read_end.ctypes.data_as(i32p),
        b, match, mismatch, gap_open, gap_extend,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), cap,
        n_ops.ctypes.data_as(i32p), mism.ctypes.data_as(i32p),
    )
    if rc != 0:
        raise RuntimeError(f"stpu_finish_batch rc={rc}")
    return out, n_ops, mism
