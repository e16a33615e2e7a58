"""Wrapper of the hand-written CUDA Smith-Waterman kernels (csrc/sw.cu).

The kernels replace `sapling_tpu/ops/sw_pallas.py::_kernel` in both its
modes with one template, `sw_kernel<G, S, FULL>`: a row-strip wavefront of
G lanes a pair, in row tiles of at most 1,024 rows, so there is no cap on W
or R. The full mode records each column's maxima in a workspace and
resolves ref_end, read_end, terminate and score2 from the records after
the sweep, keyed in int32 or, where H could reach KEY_LIMIT, in int64.
Both return exactly what the plain PyTorch `ops.sw.sw_pass` returns.
`sw_pass_cuda` is the one entry point every SW pass of the port goes
through:

  * a tensor on the CPU takes the plain version (there is no CUDA there);
  * a tensor on the card launches a kernel, or raises — there is no
    fallback to the plain version.

The kernels are compiled with nvcc at first use into
`sapling_tpu_torch/_build` (gitignored), keyed by a hash of the source and
flags, and bound with ctypes: pointers from `data_ptr()`, the stream from
PyTorch's current stream. `LAUNCHES` counts kernel launches per mode.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "sw.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
TILE_ROWS = 1024                  # rows of a pair a group sweeps at once
KEY_LIMIT = 1 << 20               # full mode: H below it, or the int64 key
                                  # (a column's max and its row share a key)
H_LIMIT = (1 << 31) - 1           # int32 H

# kernel launches per mode, counted where the kernel is launched
LAUNCHES = {"full": 0, "score_only": 0}
_LOCK = threading.Lock()
_LIB = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit (nvcc) not found; set CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_kernel(source: str = SOURCE) -> str:
    """Compile csrc/sw.cu, or another CUDA source at `source` (csrc/
    query.cu, another version of sw.cu), into lib<stem>-<hash>.so (or
    reuse the build of the same source and flags); returns the shared
    library's path. nvcc's -Xptxas -v report (registers, spills, shared
    memory) is kept beside it as a .log."""
    with open(source, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + src).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}-{tag}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = out + f".tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed:\n{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        with open(out[:-3] + ".log", "w") as f:
            f.write(res.stdout + res.stderr)
        os.replace(tmp, out)
    return out


def bind_lib(path: str, signatures: dict) -> ctypes.CDLL:
    """The library at `path` with each C entry point of `signatures`
    ({name: argtypes}) typed, returning an int (a cudaError_t)."""
    lib = ctypes.CDLL(path)
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def bind(path: str) -> ctypes.CDLL:
    """The library at `path` with its C entry point `sw_pass_launch` typed."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return bind_lib(path, {"sw_pass_launch": [vp] * 7 + [ci] * 11 + [vp]})


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = bind(build_kernel())
    return _LIB


def h_bound(w: int, r: int, pad_to: int, match: int, mismatch: int,
            gap_open: int, gap_extend: int) -> int:
    """The most H can reach over W x R cells: the largest gain of a cell
    (match, -mismatch, -gap_open, -gap_extend, 0) a row and a column."""
    step = max(match, -mismatch, -gap_open, -gap_extend, 0)
    return step * (-(-w // pad_to) * pad_to + r)


def workspace_ints(b: int, w: int, r: int, pad_to: int, score_only: bool,
                   key64: bool = False) -> int:
    """int32 the kernel needs beside its output: in full mode a record of
    three a column a pair (its real max key, tile and pad max), four with
    the int64 key; past TILE_ROWS padded rows, two alternating tile
    boundaries of two a column a pair (H and F)."""
    tiled = -(-w // pad_to) * pad_to > TILE_ROWS
    return ((0 if score_only else (4 if key64 else 3) * r * b)
            + (4 * r * b if tiled else 0))


def _check(name, t, dtype, ndim, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, query on {device}")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-D {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


def sw_pass_cuda(query, qlen, ref, rlen, terminate, *, match: int = 2,
                 mismatch: int = 2, gap_open: int = 3, gap_extend: int = 1,
                 mask_len: int = 15, pad_to: int = 16,
                 second_inclusive: bool = False, score_only: bool = False):
    """ops.sw.sw_pass with the same arguments and results, on the CUDA
    kernel for tensors on the card.

    On the card: query int8 [B, W] and ref int8 [B, R] base codes, qlen /
    rlen / terminate int32 [B], all contiguous on one device, any W and R;
    in full mode H must stay an int32 (h_bound < 2^31); from KEY_LIMIT on
    the full mode keys a column's max and its row in int64. pad_to does
    not change the score-only result (pad rows lie below every real row);
    it changes only which strip shape the kernel is built for.
    """
    if query.device.type == "cpu":
        from .sw import sw_pass

        return sw_pass(query, qlen, ref, rlen, terminate, match=match,
                       mismatch=mismatch, gap_open=gap_open,
                       gap_extend=gap_extend, mask_len=mask_len,
                       pad_to=pad_to, second_inclusive=second_inclusive,
                       score_only=score_only)
    dev = query.device
    if dev.type != "cuda":
        raise ValueError(f"sw_pass_cuda: unsupported device {dev}")
    if gap_open < gap_extend:
        raise ValueError("decayed-max F factorization requires gapO >= gapE")
    if pad_to < 1:
        raise ValueError("pad_to must be positive")
    _check("query", query, torch.int8, 2, dev)
    _check("ref", ref, torch.int8, 2, dev)
    b, w = query.shape
    r = ref.shape[1]
    for name, t in (("qlen", qlen), ("rlen", rlen), ("terminate", terminate)):
        _check(name, t, torch.int32, 1, dev)
        if t.shape[0] != b:
            raise ValueError(f"{name} has {t.shape[0]} rows, query {b}")
    if ref.shape[0] != b:
        raise ValueError(f"ref has {ref.shape[0]} rows, query {b}")
    hmax = h_bound(w, r, pad_to, match, mismatch, gap_open, gap_extend)
    if not score_only and hmax > H_LIMIT:
        raise ValueError(f"scores over {w} x {r} cells may reach {hmax}, "
                         "past an int32")
    out = torch.empty((1 if score_only else 5, b), dtype=torch.int32,
                      device=dev)
    ws = torch.empty(workspace_ints(b, w, r, pad_to, score_only,
                                    hmax >= KEY_LIMIT),
                     dtype=torch.int32, device=dev)
    if b:
        lib = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.sw_pass_launch(
                query.data_ptr(), ref.data_ptr(), qlen.data_ptr(),
                rlen.data_ptr(), terminate.data_ptr(), out.data_ptr(),
                ws.data_ptr(), b, w, r, match, mismatch, gap_open,
                gap_extend, mask_len, pad_to, int(second_inclusive),
                int(score_only), stream)
        if rc != 0:
            raise RuntimeError(f"SW kernel launch failed: cudaError {rc}")
        with _LOCK:
            LAUNCHES["score_only" if score_only else "full"] += 1
    if score_only:
        return {"score": out[0]}
    return dict(zip(("score", "ref_end", "read_end", "score2", "ref_end2"),
                    out))
