"""The NN predictor's rank prediction: its plain PyTorch version and the
wrapper of its hand-written CUDA kernel (csrc/nn_predict.cu).

`nn_predict` is the plain version of `models.serve.NNServing.
predict_ranks` (the JAX package's `sapling_tpu/models/serve.py::
NNServing.predict_ranks`, :63, an XLA program there); `nn_predict_kernel`
computes the same ranks, bit for bit, in one launch a call: persistent
blocks, each grouping a tile of kTile lanes by chunk before the MLP, so
that a warp's parameter loads are broadcasts. `nn_predict_cuda` takes
the plain function's arguments:

  * tensors on the CPU take the plain version (there is no CUDA there);
  * tensors on the card launch the kernel, or raise: there is no fallback.

`NNPredictPlan` is that call cut in two for a caller that predicts with one
model many times (NNServing.predict_ranks on the card): the model's arrays
checked once, then a request that checks only its x, allocates its output
and launches; `PLANS` counts the plans made and the requests launched from
one. The library is built with nvcc at first use (ops.sw_cuda.build_kernel,
into the gitignored `_build/`); `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import os
import re
import threading

import torch

from .sw_cuda import bind_lib, build_kernel

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "nn_predict.cu")
F64 = torch.float64

# kernel launches, counted where the kernel is launched
LAUNCHES = {"nn_predict": 0}
# serving plans made (NNPredictPlan) and requests launched from one
PLANS = {"made": 0, "served": 0}
_LOCK = threading.Lock()
_LIB = None

_P, _LL, _I, _D = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_double
SIGNATURES = {"nn_predict_launch": [_P] * 7 + [_LL, _LL, _I, _I]
              + [_D] * 5 + [_P]}


def bind(path: str) -> ctypes.CDLL:
    """The library at `path` with its C entry point typed."""
    return bind_lib(path, SIGNATURES)


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = bind(build_kernel(SOURCE))
    return _LIB


def nn_route(x, xb, x_max: float):
    """nn_predict's routing of [B] int64 x: (x / x_max in float64, that
    rounded to float32, the chunk: searchsorted over the boundaries xb,
    clamped to [0, C-1])."""
    xs64 = x.to(F64) / torch.full((), x_max, dtype=F64, device=x.device)
    xs = xs64.to(torch.float32)
    c = torch.clamp(torch.searchsorted(xb, xs, right=True) - 1, 0,
                    xb.shape[0] - 1)
    return xs64, xs, c


def kernel_tile(source: str = SOURCE) -> int:
    """The lanes a block of the kernel at `source` groups by chunk at once
    (its kTile)."""
    with open(source) as f:
        return int(re.search(r"constexpr int kTile = (\d+);",
                             f.read()).group(1))


def nn_predict(x, xb, w1, b1, w2, b2, *, x_max: float, line_m: float,
               line_c: float, res_ptp: float, res_min: float, n: int):
    """[B] int64 adjusted k-mer values -> [B] int64 predicted ranks, with
    torch ops on x's device.

    As in the JAX package: x / x_max in float64, routed (a searchsorted
    over the C chunk boundaries xb) and run through the chunk's 1 -> s ->
    1 MLP (w1 [C,1,s], b1 [C,s], w2 [C,s,1], b2 [C,1]) as float32 scaled
    values promoted to float64 (the precision of training and of the
    audit), un-scaled in float64, rounded half to even and clipped to [0,
    n-1]. Two choices make every device round alike: x_max is a tensor on
    x's device (PyTorch's CUDA division by a Python number multiplies by
    its reciprocal), and the s hidden units are summed one after the
    other, separate multiplies and adds, not by one sum(dim=1), whose
    order is the device's."""
    xs64, xs, c = nn_route(x, xb, x_max)
    h = torch.relu(xs.to(F64)[:, None] * w1[c, 0, :] + b1[c])   # [B, s]
    prod = h * w2[c, :, 0]
    res = prod[:, 0]
    for j in range(1, prod.shape[1]):
        res = res + prod[:, j]
    res = res + b2[c, 0]
    rows = (xs64 * line_m + line_c) - (res * res_ptp + res_min)
    return torch.clamp(torch.round(rows), 0, n - 1).to(torch.int64)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {shape}, got {t.dtype} {tuple(t.shape)}")


def _check_model(xb, w1, b1, w2, b2, dev) -> None:
    """nn_predict_cuda's checks of a model's arrays on `dev`: w1 [C, 1,
    s], the rest of the shapes it gives, each contiguous."""
    if w1.dim() != 3 or w1.shape[1] != 1 or w1.shape[0] < 1 \
            or w1.shape[2] < 1:
        raise ValueError(f"w1 must be [C, 1, s], got {tuple(w1.shape)}")
    c, s = w1.shape[0], w1.shape[2]
    _check("xb", xb, torch.float32, (c,), dev)
    _check("w1", w1, F64, (c, 1, s), dev)
    _check("b1", b1, F64, (c, s), dev)
    _check("w2", w2, F64, (c, s, 1), dev)
    _check("b2", b2, F64, (c, 1), dev)


def _launched(rc: int, planned: bool = False) -> None:
    """Raise unless a launch returned cudaSuccess; count it (and, where
    it was launched from a plan, count it served)."""
    if rc != 0:
        raise RuntimeError(f"nn_predict kernel launch failed: cudaError {rc}")
    with _LOCK:
        LAUNCHES["nn_predict"] += 1
        PLANS["served"] += planned


def launch_nn_predict(lib, stream, x, xb, w1, b1, w2, b2, out, *,
                      x_max: float, line_m: float, line_c: float,
                      res_ptp: float, res_min: float, n: int) -> int:
    """nn_predict_launch of `lib` on checked tensors, on `stream`; returns
    its cudaError_t."""
    c, s = w1.shape[0], w1.shape[2]
    return lib.nn_predict_launch(
        x.data_ptr(), xb.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), x.shape[0], n, c, s,
        x_max, line_m, line_c, res_ptp, res_min, stream)


def nn_predict_cuda(x, xb, w1, b1, w2, b2, *, x_max: float, line_m: float,
                    line_c: float, res_ptp: float, res_min: float, n: int):
    """nn_predict with the same arguments and results, on nn_predict_kernel
    for tensors on the card: x int64 [B], xb float32 [C] ascending, w1
    float64 [C,1,s], b1 [C,s], w2 [C,s,1], b2 [C,1], all contiguous on one
    device."""
    kw = dict(x_max=float(x_max), line_m=float(line_m), line_c=float(line_c),
              res_ptp=float(res_ptp), res_min=float(res_min), n=int(n))
    if x.device.type == "cpu":
        return nn_predict(x, xb, w1, b1, w2, b2, **kw)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"nn_predict_cuda: unsupported device {dev}")
    _check_model(xb, w1, b1, w2, b2, dev)
    _check("x", x, torch.int64, (x.shape[0],), dev)
    out = torch.empty(x.shape[0], dtype=torch.int64, device=dev)
    if x.shape[0]:
        with torch.cuda.device(dev):
            rc = launch_nn_predict(
                _lib(), torch.cuda.current_stream(dev).cuda_stream, x, xb,
                w1, b1, w2, b2, out, **kw)
        _launched(rc)
    return out


class NNPredictPlan:
    """nn_predict_cuda's calls on one model cut in two, as
    query_cuda.PlqueryPlan cuts plquery's: the plan is made once, with
    every check nn_predict_cuda makes of the model's arrays (_check_model);
    a request (`__call__`) then checks only its x, allocates its output and
    launches nn_predict_kernel (launch_nn_predict): nn_predict_cuda's
    ranks. The plan keeps the arrays it was made of alive and reads them as
    they are: a caller whose model changes makes a new plan
    (NNServing.plan). `lib`: the NN library (default: this module's, built
    on first use)."""

    def __init__(self, xb, w1, b1, w2, b2, *, x_max: float, line_m: float,
                 line_c: float, res_ptp: float, res_min: float, n: int,
                 lib=None):
        self.device = w1.device
        _check_model(xb, w1, b1, w2, b2, self.device)
        self.arrays = (xb, w1, b1, w2, b2)
        self._kw = dict(x_max=float(x_max), line_m=float(line_m),
                        line_c=float(line_c), res_ptp=float(res_ptp),
                        res_min=float(res_min), n=int(n))
        self._lib = lib or _lib()
        with _LOCK:
            PLANS["made"] += 1

    def launch(self, stream, x, out) -> int:
        """launch_nn_predict of the plan's model for a checked x into out,
        on `stream`; returns its cudaError_t."""
        return launch_nn_predict(self._lib, stream, x, *self.arrays, out,
                                 **self._kw)

    def __call__(self, x):
        """A request: int64 [B] adjusted k-mers on the plan's device,
        checked as nn_predict_cuda checks x -> int64 [B] predicted ranks in
        a new tensor."""
        dev = self.device
        _check("x", x, torch.int64, (x.shape[0],), dev)
        out = x.new_empty(x.shape[0])
        if x.shape[0]:
            # the raw stream, as PlqueryPlan reads it
            stream = torch._C._cuda_getCurrentRawStream(dev.index)
            if torch.cuda.current_device() == dev.index:
                rc = self.launch(stream, x, out)
            else:
                with torch.cuda.device(dev):
                    rc = self.launch(stream, x, out)
            _launched(rc, planned=True)
        return out
