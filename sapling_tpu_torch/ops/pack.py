"""2-bit genome/query packing and k-mer encoding.

The genome is held on device as big-endian 2-bit codes packed 16 bases per
uint32 word: base i lives at bits [30 - 2*(i % 16), 31 - 2*(i % 16)] of word
i // 16. This layout makes lexicographic base comparison equal to unsigned
integer comparison of aligned words, which is what the batched LCP/compare
kernel exploits (see sapling_tpu_torch.ops.query).

Base encoding matches the reference (A=0, C=1, G=2, T=3;
reference: src/sapling_api.h:494-498), and k-mer hashing matches
Sapling::kmerize / kmerizeAdjusted (reference: src/sapling_api.h:73-90).
"""

from __future__ import annotations

import numpy as np

ALPHA = 2  # log2 alphabet size
BASES_PER_WORD = 16

# byte -> 2-bit code lookup (A/C/G/T uppercase only; caller filters first)
_CODE_LUT = np.zeros(256, dtype=np.uint8)
_CODE_LUT[ord("A")] = 0
_CODE_LUT[ord("C")] = 1
_CODE_LUT[ord("G")] = 2
_CODE_LUT[ord("T")] = 3
_DECODE = np.frombuffer(b"ACGT", dtype=np.uint8)


def encode_bases(ascii_u8: np.ndarray) -> np.ndarray:
    """ASCII A/C/G/T bytes -> codes 0..3 (uint8)."""
    return _CODE_LUT[ascii_u8]


def decode_bases(codes: np.ndarray) -> np.ndarray:
    """codes 0..3 -> ASCII bytes."""
    return _DECODE[codes]


def pack_codes(codes: np.ndarray, pad_words: int = 4) -> np.ndarray:
    """Pack 2-bit codes (uint8 [n]) into big-endian uint32 words.

    `pad_words` extra zero words are appended so kernels can gather a fixed
    window of words near the end of the genome without bounds checks.
    """
    n = codes.shape[0]
    n_words = (n + BASES_PER_WORD - 1) // BASES_PER_WORD
    buf = np.zeros(n_words * BASES_PER_WORD, dtype=np.uint32)
    buf[:n] = codes
    buf = buf.reshape(n_words, BASES_PER_WORD)
    shifts = np.uint32(30) - np.uint32(2) * np.arange(BASES_PER_WORD, dtype=np.uint32)
    words = np.bitwise_or.reduce(buf << shifts, axis=1).astype(np.uint32)
    return np.concatenate([words, np.zeros(pad_words, dtype=np.uint32)])


def words_to_u64(words: np.ndarray) -> np.ndarray:
    """Pair adjacent big-endian uint32 genome words into big-endian uint64
    words (32 bases per 8-byte word): u64[i] = (w[2i] << 32) | w[2i+1].

    Same bit layout, half the gather granules: a probe needing uint32
    words [w0, w0+wq] fetches ceil((wq+2)/2) uint64s instead of wq+1
    uint32s — the engine is gather-granule bound (docs/PERFORMANCE.md),
    so this is the device-side genome representation (ops.query.probe_at
    accepts either dtype and selects words by position parity)."""
    w = words
    if w.shape[0] % 2:
        w = np.concatenate([w, np.zeros(1, np.uint32)])
    return (w[0::2].astype(np.uint64) << np.uint64(32)) | w[1::2]


def unpack_words(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_codes (first n bases)."""
    w = words[: (n + BASES_PER_WORD - 1) // BASES_PER_WORD]
    shifts = np.uint32(30) - np.uint32(2) * np.arange(BASES_PER_WORD, dtype=np.uint32)
    codes = ((w[:, None] >> shifts) & np.uint32(3)).astype(np.uint8)
    return codes.reshape(-1)[:n]


def kmers_scan(codes: np.ndarray, k: int, chunk: int = 1 << 27) -> np.ndarray:
    """int64 2k-bit hash of every k-mer: out[i] = hash(codes[i:i+k]).

    Vectorized equivalent of the rolling-hash sweep in buildPiecewiseLinear
    (reference: src/sapling_api.h:402-415). Length n-k+1; chunked so
    multi-Gbp genomes peak at ~2 extra int64 temporaries per chunk.
    """
    n = codes.shape[0]
    if n < k:
        return np.zeros(0, dtype=np.int64)
    m = n - k + 1
    out = np.empty(m, dtype=np.int64)
    for lo in range(0, m, chunk):
        hi = min(lo + chunk, m)
        acc = np.zeros(hi - lo, dtype=np.int64)
        for j in range(k):
            acc <<= ALPHA
            acc |= codes[lo + j : hi + j]
        out[lo:hi] = acc
    return out


def kmerize(codes: np.ndarray, k: int) -> int:
    """Hash of the first k codes (reference: src/sapling_api.h:73-78)."""
    v = 0
    for c in codes[:k]:
        v = (v << ALPHA) | int(c)
    return v


def kmerize_adjusted(codes: np.ndarray, length: int, k: int) -> int:
    """Hash of a possibly-short query (reference: src/sapling_api.h:83-90).

    Queries shorter than k are padded with a G ('closer to the middle of the
    range') then zero-shifted to full 2k bits.
    """
    if length >= k:
        return kmerize(codes, k)
    v = 0
    for c in codes[:length]:
        v = (v << ALPHA) | int(c)
    v = (v << ALPHA) | 2
    return v << (ALPHA * (k - length - 1))


def rank_prefix64(codes: np.ndarray, rev: np.ndarray,
                  chunk: int = 1 << 22) -> np.ndarray:
    """uint64[n] per-RANK suffix prefixes: the first 32 bases of the suffix
    at each suffix-array rank, packed big-endian (base j in bits
    [62-2j, 63-2j]); suffixes shorter than 32 are zero-padded.

    This is the probe-acceleration array: one 8-byte gather decides any
    <=32-base lexicographic comparison against a suffix (see
    ops.query.make_rank_probe), replacing the dependent rev->packed-genome
    gather chain in the hot search loop.
    """
    n = codes.shape[0]
    padded = np.concatenate([codes, np.zeros(32, np.uint8)])
    out = np.empty(n, dtype=np.uint64)
    shifts = (np.uint64(62) - np.uint64(2) * np.arange(32, dtype=np.uint64))
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        pos = rev[lo:hi].astype(np.int64)
        window = padded[pos[:, None] + np.arange(32)]     # [c, 32]
        out[lo:hi] = (window.astype(np.uint64) << shifts).sum(
            axis=1, dtype=np.uint64)
    return out


P3_BASES = 21  # bases per 3-bit-packed prefix word (63 of 64 bits)


def rank_prefix3(codes: np.ndarray, rev: np.ndarray,
                 chunk: int = 1 << 22) -> np.ndarray:
    """uint64[n] per-RANK suffix prefixes in SHIFTED 3-bit encoding: the
    first 21 bases of the suffix at each rank, base j as (code+1) in bits
    [60-3j, 62-3j]; positions past the genome end pack as 0.

    Because the pad value 0 sorts BELOW every real base (A..T = 1..4), a
    single unsigned compare of these words gives the reference's full
    suffix-vs-query ordering INCLUDING the off-end-is-smaller rule
    (reference: src/sapling_api.h:115-130) — no text position needed. One
    8-byte gather therefore decides any <=21-base probe entirely.
    """
    n = codes.shape[0]
    padded = np.concatenate(
        [codes.astype(np.uint64) + 1, np.zeros(P3_BASES, np.uint64)])
    out = np.empty(n, dtype=np.uint64)
    shifts = (np.uint64(60)
              - np.uint64(3) * np.arange(P3_BASES, dtype=np.uint64))
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        pos = rev[lo:hi].astype(np.int64)
        window = padded[pos[:, None] + np.arange(P3_BASES)]
        out[lo:hi] = (window << shifts).sum(axis=1, dtype=np.uint64)
    return out


def pack_queries3(codes: np.ndarray) -> np.ndarray:
    """[B, L] query codes (L <= 21) -> uint64 [B] in the rank_prefix3
    layout (shifted 3-bit bases, zero pad beyond L)."""
    b, length = codes.shape
    if length > P3_BASES:
        raise ValueError(f"pack_queries3 supports length <= {P3_BASES}")
    out = np.zeros(b, dtype=np.uint64)
    for j in range(length):
        out |= (codes[:, j].astype(np.uint64) + 1) << np.uint64(60 - 3 * j)
    return out


def pack_queries(codes: np.ndarray) -> np.ndarray:
    """Pack a batch of equal-length queries [B, L] into WORD-MAJOR words
    [ceil(L/16), B] (bits beyond L in the last word are zero).

    Word-major because TPU tiling pads the last two axes to (8, 128): a
    [B, 2] device array would occupy 64x its bytes in HBM, while [2, B]
    is tight (docs/PERFORMANCE.md).
    """
    b, length = codes.shape
    wq = (length + BASES_PER_WORD - 1) // BASES_PER_WORD
    buf = np.zeros((b, wq * BASES_PER_WORD), dtype=np.uint32)
    buf[:, :length] = codes
    buf = buf.reshape(b, wq, BASES_PER_WORD)
    shifts = np.uint32(30) - np.uint32(2) * np.arange(BASES_PER_WORD, dtype=np.uint32)
    words = np.bitwise_or.reduce(buf << shifts, axis=2).astype(np.uint32)
    return np.ascontiguousarray(words.T)


def batch_kmers_adjusted(codes: np.ndarray, k: int) -> np.ndarray:
    """Vectorized kmerizeAdjusted over a [B, L] batch -> int64 [B]."""
    b, length = codes.shape
    c = codes.astype(np.int64)
    if length >= k:
        out = np.zeros(b, dtype=np.int64)
        for j in range(k):
            out = (out << ALPHA) | c[:, j]
        return out
    out = np.zeros(b, dtype=np.int64)
    for j in range(length):
        out = (out << ALPHA) | c[:, j]
    out = (out << ALPHA) | 2
    return out << (ALPHA * (k - length - 1))
