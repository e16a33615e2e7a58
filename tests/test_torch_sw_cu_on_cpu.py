"""The CUDA source of the SW kernels, compiled for the CPU and held against
the plain sw_pass.

sapling_tpu_torch/csrc/sw.cu is compiled with g++ against a stand-in
`cuda_runtime.h` (tests/csrc/cuda_mock/: one std::thread a lane, a
barrier a warp for the shuffles and warp reductions, the DPX intrinsics
as plain max/add), after each `kernel<<<...>>>(args)` launch is rewritten
into a call of the mock's `mock_launch`. The library's `sw_pass_launch`
then runs the kernels' own code on host arrays, so a fault in a kernel's
schedule, hand-offs or masks shows on the CPU. Every field must equal the
plain PyTorch `ops.sw.sw_pass` (itself held against sapling_tpu by
tests/test_torch_sw.py). Speed, registers and the card's compiler are
tested only on the card (tests/test_torch_sw_cuda.py, chip_smoke.py).
"""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from sapling_tpu_torch.ops import sw, sw_cuda

MOCK_DIR = os.path.join(os.path.dirname(__file__), "csrc", "cuda_mock")
_LAUNCH = re.compile(r"([A-Za-z_]\w*(?:<[^<>;]*>)?)<<<([^>]*)>>>\((.*?)\);",
                     re.S)


def _for_the_cpu(src: str) -> str:
    """sw.cu with its launches and its dynamic shared memory mocked."""
    def launch(m):
        grid, block, smem, _stream = (x.strip() for x in m.group(2).split(","))
        return (f"mock_launch({grid}, {block}, {smem}, "
                f"[=] {{ {m.group(1)}({m.group(3)}); }});")

    src = src.replace("extern __shared__ int32_t smem[];",
                      "int32_t* smem = mock_smem;")
    src, n = _LAUNCH.subn(launch, src)
    assert n == 2, "sw.cu should launch two kernels"
    return src


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    d = tmp_path_factory.mktemp("sw_cu_on_cpu")
    probe = d / "probe.cpp"
    probe.write_text("#include <barrier>\nstd::barrier<> b(1);\n")
    if subprocess.run([gxx, "-std=c++20", "-fsyntax-only", str(probe)],
                      capture_output=True).returncode != 0:
        pytest.skip("the mock needs a g++ with C++20 <barrier>")
    cpp, so = d / "sw_on_cpu.cpp", d / "libsw_on_cpu.so"
    with open(sw_cuda.SOURCE) as f:
        cpp.write_text(_for_the_cpu(f.read()))
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-Wno-unknown-pragmas", "-I", MOCK_DIR, "-o", str(so),
                    str(cpp)], check=True)
    lib = sw_cuda.bind(str(so))

    def run(q, ql, ref, rl, tm, *, score_only=False, match=2, mismatch=2,
            gap_open=3, gap_extend=1, mask_len=15, pad_to=16,
            second_inclusive=False):
        b, w = q.shape
        out = np.full((1 if score_only else 5, b), -777, np.int32)
        rc = lib.sw_pass_launch(
            q.ctypes.data, ref.ctypes.data, ql.ctypes.data, rl.ctypes.data,
            tm.ctypes.data, out.ctypes.data, b, w, ref.shape[1], match,
            mismatch, gap_open, gap_extend, mask_len, pad_to,
            int(second_inclusive), int(score_only), None)
        assert rc == 0
        return out
    return run


def _batch(seed, b, w, r):
    """Seeded pairs: every third ref holds its query; qlen 0, 1 and W and
    rlen 0 and 1 among the ragged lengths."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (b, w)).astype(np.int8)
    ref = rng.integers(0, 5, (b, r)).astype(np.int8)
    for i in range(0, b, 3):
        ln = min(w, r - 2)
        if ln > 0:
            ref[i, 2:2 + ln] = q[i, :ln]
    ql = rng.integers(0, w + 1, b).astype(np.int32)
    rl = rng.integers(0, r + 1, b).astype(np.int32)
    ql[:3] = (0, 1, w)
    rl[3:5] = (0, min(1, r))
    return q, ql, ref, rl


SCORING = {"default": {},
           "nondefault": dict(match=3, mismatch=1, gap_open=5, gap_extend=2),
           "negative": dict(match=1, mismatch=-1, gap_open=2, gap_extend=1)}

# (B, W, R, pad_to, scoring): the score-only kernel at strips of G = 1 to 32
# lanes, a mismatch that scores, the aligner's width in both pads
SCORE_CASES = [(40, 100, 128, 16, "default"), (40, 100, 128, 8, "default"),
               (40, 100, 128, 16, "negative"), (30, 7, 30, 1, "default"),
               (30, 17, 21, 8, "nondefault"), (24, 33, 40, 8, "negative"),
               (16, 65, 20, 16, "default"), (12, 129, 20, 8, "nondefault"),
               (8, 257, 16, 8, "default"), (6, 1024, 12, 16, "default")]


@pytest.mark.parametrize("b,w,r,pad_to,scoring", SCORE_CASES)
def test_score_only_kernel_source_matches_plain(launch, b, w, r, pad_to,
                                                scoring):
    kw = dict(SCORING[scoring], pad_to=pad_to)
    q, ql, ref, rl = _batch(w + r, b, w, r)
    tm = np.full(b, -1, np.int32)
    got = launch(q, ql, ref, rl, tm, score_only=True, **kw)[0]
    want = sw.sw_pass(*map(torch.from_numpy, (q, ql, ref, rl, tm)),
                      score_only=True, **kw)["score"].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["pad16", "pad8", "terminate", "negative"])
def test_full_kernel_source_matches_plain(launch, case):
    b, w, r = 24, 100, 128
    q, ql, ref, rl = _batch(7, b, w, r)
    tm = np.full(b, -1, np.int32)
    kw = {"pad16": {}, "pad8": dict(pad_to=8, second_inclusive=True),
          "terminate": {}, "negative": SCORING["negative"]}[case]
    t = [torch.from_numpy(a) for a in (q, ql, ref, rl)]
    if case == "terminate":
        tm = sw.sw_pass(*t, torch.from_numpy(tm))["score"].numpy()
    got = launch(q, ql, ref, rl, tm, **kw)
    want = sw.sw_pass(*t, torch.from_numpy(tm), **kw)
    for i, k in enumerate(("score", "ref_end", "read_end", "score2",
                           "ref_end2")):
        np.testing.assert_array_equal(got[i], want[k].numpy(), err_msg=k)
