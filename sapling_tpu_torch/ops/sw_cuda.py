"""Wrapper of the hand-written CUDA Smith-Waterman kernels (csrc/sw.cu).

The kernels replace `sapling_tpu/ops/sw_pallas.py::_kernel`: the full mode
runs `sw_pass_kernel` (one warp a pair), the score_only mode
`sw_score_kernel` (a row-strip wavefront of G lanes a pair, real cells
only). Both return exactly what the plain PyTorch `ops.sw.sw_pass` returns.
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
MAX_ROWS = 1024                   # query rows (after pad_to) of a pair
MAX_SMEM = 232448                 # bytes of shared memory one block may use
                                  # (full mode: R column maxima a warp)

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
    """Compile csrc/sw.cu, or another version of it at `source` (or reuse
    the build of the same source and flags); returns the shared library's
    path. nvcc's -Xptxas -v report (registers, spills, shared memory) is
    kept beside it as a .log."""
    with open(source, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + src).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libsw-{tag}.so")
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


def bind(path: str) -> ctypes.CDLL:
    """The library at `path` with its C entry point `sw_pass_launch` typed."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sw_pass_launch.argtypes = [vp] * 6 + [ci] * 11 + [vp]
    lib.sw_pass_launch.restype = ci
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = bind(build_kernel())
    return _LIB


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
    rlen / terminate int32 [B], all contiguous on one device;
    ceil(W / pad_to) * pad_to <= 1024 and, in full mode, R <= 58112.
    pad_to does not change the score-only result (pad rows lie below every
    real row); it changes only which strip shape the kernel is built for.
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
    if -(-w // pad_to) * pad_to > MAX_ROWS:
        raise ValueError(f"query width {w} (padded to {pad_to}) exceeds "
                         f"the kernel's {MAX_ROWS} rows")
    if not score_only and 4 * r > MAX_SMEM:
        raise ValueError(f"ref width {r} exceeds the kernel's "
                         f"{MAX_SMEM // 4} columns")
    out = torch.empty((1 if score_only else 5, b), dtype=torch.int32,
                      device=dev)
    if b:
        lib = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.sw_pass_launch(
                query.data_ptr(), ref.data_ptr(), qlen.data_ptr(),
                rlen.data_ptr(), terminate.data_ptr(), out.data_ptr(),
                b, w, r, match, mismatch, gap_open, gap_extend, mask_len,
                pad_to, int(second_inclusive), int(score_only), stream)
        if rc != 0:
            raise RuntimeError(f"SW kernel launch failed: cudaError {rc}")
        with _LOCK:
            LAUNCHES["score_only" if score_only else "full"] += 1
    if score_only:
        return {"score": out[0]}
    return dict(zip(("score", "ref_end", "read_end", "score2", "ref_end2"),
                    out))
