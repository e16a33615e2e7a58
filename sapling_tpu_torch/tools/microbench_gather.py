"""Gather microbenchmarks for >= 2^31-element rank arrays (PyTorch port;
the twin of tools/microbench_gather.py).

The query spends its time in random gathers from device memory: `rev`
(one rank a probe) and the packed genome (a few consecutive words a
probe). This tool times the candidate layouts on the card:

  rev (n entries, past 2^31 at genome scale: int64 indexes):
    halves   even/odd split: 2 one-element gathers + select (the TPU
             package's HalvesU32)
    rev2d    one [2, ceil(n/2)] operand, ONE gather with (row, col)
             index pairs (the TPU package's Rows2D)

  packed genome (n/16 32-bit words; probes fetch 3 consecutive words):
    words32  3 independent 32-bit takes
    words64  2 64-bit takes over the paired view

  argsort    the device sort of `lanes` int64 and int32 keys (the price
             of making lanes near-sorted)
  randref    one 32-bit take a lane from a `gb`-GB operand, random lanes
  sorted     the same with the lanes sorted (index locality)

Each mode runs `iters` data-chained gathers, the next index derived from
the gathered value, timed with CUDA events (utils.timing.timed) after one
warm chain; operands are filled on the device, never sent from the host.
The rev and genome operands hold STEP (a prime) where the JAX tool holds
ones: a chain of +1 steps stays inside one 32-byte sector for 7 of 8
steps, which the card's 50 MB L2 would serve, so each step here jumps
STEP elements to a fresh sector. randref and sorted keep the JAX tool's
drift of 0..63 elements a step.

Printed per mode: ms a chained round (one step over every lane) and M
lanes/s, as the JAX tool prints them; then the same rounds' gathers
alone, over index vectors made beforehand (no chain arithmetic), and
their rate in 32-byte sectors (the expected distinct sectors a lane
reads a step, times 32 bytes): what a random-gather bound divides by.

    python -m sapling_tpu_torch.tools.microbench_gather [n=3100000000]
        [lanes=5000000] [iters=8]
        [which=halves,rev2d,words32,words64,argsort,sorted,randref]
        [gb=12.4] [device=cuda]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import parse_keyval_args
from ..utils.timing import timed

MODES = ("halves", "rev2d", "words32", "words64", "argsort", "sorted",
         "randref")
STEP = 1_000_003
SECTOR = 32
# expected distinct 32-byte sectors a lane reads a step: halves gathers
# both halves; 3 consecutive u32 words from a random word cross a sector
# edge 2 times in 8, 2 u64 words from a random one 1 time in 4
SECTORS = {"halves": 2.0, "rev2d": 1.0, "words32": 1.25, "words64": 1.25,
           "randref": 1.0, "sorted": 1.0}


def _wrap(modulus):
    """The chain step of the rev and genome modes: the next index is the
    gathered value added to this one, modulo the index range."""
    return lambda ix, v: torch.remainder(ix + v, modulus)


def _drift(m):
    """The chain step of randref / sorted: a drift of the gathered value
    (0..63), clamped to the operand."""
    return lambda ix, v: torch.clamp(ix + v, max=m - 1)


def _hashed(m: int, device) -> torch.Tensor:
    """int32 [m] = (i * 2654435761 mod 2^32) & 63, the JAX tool's
    content, filled on the device in chunks."""
    out = torch.empty(m, dtype=torch.int32, device=device)
    chunk = 1 << 28
    for lo in range(0, m, chunk):
        i = torch.arange(lo, min(lo + chunk, m), dtype=torch.int64,
                         device=device)
        out[lo:lo + len(i)] = ((i * 2654435761) & 63).to(torch.int32)
    return out


def run_modes(n: int, lanes: int, iters: int, which, gb=(12.4,),
              device="cuda", log=print) -> list[dict]:
    """Time each mode in `which`; returns a row a measurement: mode, ms a
    chained round, lanes/s, ms of a round's gathers alone and, for the
    gather modes, their bytes/s of 32-byte sectors."""
    device = torch.device(device)
    rng = np.random.default_rng(7)
    rows = []

    def bench(name, mode, take, step, i0, operand_bytes):
        """The chain of `iters` rounds (index = step(index, take(index)));
        then the same `iters` gathers alone, over the chain's index
        vectors made beforehand: no chain arithmetic is timed, and the
        sector rate comes from this time."""
        def chain():
            ix = i0
            for _ in range(iters):
                ix = step(ix, take(ix))
            return ix

        ixs = [i0]
        for _ in range(iters - 1):
            ixs.append(step(ixs[-1], take(ixs[-1])))
        _out, dt = timed(chain, device, reps=1, warm=1)
        _out, dg = timed(lambda: [take(ix) for ix in ixs], device, reps=1,
                         warm=1)
        row = dict(name=name, mode=mode, lanes=lanes, iters=iters,
                   operand_bytes=operand_bytes, ms_per_round=dt / iters * 1e3,
                   lanes_per_s=lanes * iters / dt,
                   gather_ms=dg / iters * 1e3)
        text = (f"{name:10s} {row['ms_per_round']:8.4f} ms/round "
                f"({row['lanes_per_s'] / 1e6:8.1f} M lanes/s); the "
                f"{'gathers' if mode in SECTORS else 'sorts'} alone "
                f"{row['gather_ms']:8.4f} ms")
        if mode in SECTORS:
            row["sectors_per_lane"] = SECTORS[mode]
            row["sector_bytes_per_s"] = (lanes * iters / dg * SECTORS[mode]
                                         * SECTOR)
            text += (f" = {row['sector_bytes_per_s'] / 1e9:7.1f} GB/s of "
                     f"32-byte sectors at {SECTORS[mode]:g} a lane")
        log(text + f"; operand {operand_bytes / 1e9:.2f} GB")
        rows.append(row)

    def put(a):
        return torch.from_numpy(a).to(device)

    def filled(*shape, dtype=torch.int32):
        return torch.full(shape, STEP, dtype=dtype, device=device)

    def release():
        """Give a freed operand's memory back before the next is made."""
        if device.type == "cuda":
            torch.cuda.empty_cache()

    idx0 = put(rng.integers(0, n, lanes, dtype=np.int64))
    half = (n + 1) // 2
    if "halves" in which:
        even, odd = filled(half), filled(half)

        def take_h(ix):
            j = ix >> 1
            return torch.where((ix & 1) == 0, even[j], odd[j])

        bench("halves", "halves", take_h, _wrap(n), idx0, 8 * half)
        del even, odd
        release()
    if "rev2d" in which:
        two_d = filled(2, half)
        bench("rev2d", "rev2d", lambda ix: two_d[ix & 1, ix >> 1],
              _wrap(n), idx0, 8 * half)
        del two_d
        release()
    nw = n // 16
    if "words32" in which:
        words = filled(nw)

        def take_w32(ix):
            w0 = ix >> 4
            return words[w0] + words[w0 + 1] + words[w0 + 2]

        # the words past w0 stay inside the operand: indexes below n - 32
        bench("words32", "words32", take_w32, _wrap(n - 32),
              idx0 % (n - 32), 4 * nw)
        del words
        release()
    if "words64" in which:
        pairs = filled(nw // 2, dtype=torch.int64)

        def take_w64(ix):
            u0 = ix >> 5
            s = torch.zeros_like(ix)
            for j in (0, 1):
                p = pairs[u0 + j]
                s = s + (p & 0xFFFFFFFF) + (p >> 32)
            return s

        bench("words64", "words64", take_w64, _wrap(n - 64),
              idx0 % (n - 64), 8 * (nw // 2))
        del pairs
        release()
    if "argsort" in which:
        for name, keys in (
                ("argsort64", put(rng.integers(0, n, lanes,
                                               dtype=np.int64))),
                ("argsort32", put(rng.integers(0, 1 << 31, lanes,
                                               dtype=np.int32)))):
            # the round's sort; the next keys shift by its first index
            bench(name, "argsort", lambda k: torch.argsort(k)[:1],
                  lambda k, p: k + p.to(k.dtype), keys,
                  keys.numel() * keys.itemsize)
    for g in gb:
        m = int(g * (1 << 30) / 4)
        for mode in ("randref", "sorted"):
            if mode not in which:
                continue
            dev = _hashed(m, device)
            i0 = rng.integers(0, m - 64 * iters, lanes, dtype=np.int64)
            if mode == "sorted":
                i0 = np.sort(i0)
            bench(f"{'rand' if mode == 'randref' else 'sort'} {g:5.2f}G",
                  mode, lambda ix, dev=dev: dev[ix], _drift(m), put(i0),
                  4 * m)
            del dev
            release()
    return rows


def main(argv):
    kv = parse_keyval_args(argv[1:])
    which = kv.get("which", ",".join(MODES)).split(",")
    unknown = sorted(set(which) - set(MODES))
    if unknown:
        raise SystemExit(f"unknown modes {unknown}; known: {', '.join(MODES)}")
    device = torch.device(kv.get("device", "cuda"))
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    run_modes(int(kv.get("n", 3_100_000_000)),
              int(kv.get("lanes", 5_000_000)), int(kv.get("iters", 8)),
              which, [float(s) for s in str(kv.get("gb", "12.4")).split(",")],
              device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
