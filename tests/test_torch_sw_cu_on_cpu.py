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
The full mode's int64-key instantiation, which takes passes whose H could
pass the int32 key's 2^20, is also held against sapling_tpu's sw_pass.
"""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from sapling_tpu.ops import sw as jsw
from sapling_tpu_torch.ops import sw, sw_cuda

MOCK_DIR = os.path.join(os.path.dirname(__file__), "csrc", "cuda_mock")
_LAUNCH = re.compile(r"([A-Za-z_]\w*(?:<[^<>;]*>)?)<<<([^>]*)>>>\((.*?)\);",
                     re.S)


def _for_the_cpu(src: str) -> str:
    """sw.cu with its kernel launch mocked."""
    def launch(m):
        grid, block, smem, _stream = (x.strip() for x in m.group(2).split(","))
        return (f"mock_launch({grid}, {block}, {smem}, "
                f"[=] {{ {m.group(1)}({m.group(3)}); }});")

    src, n = _LAUNCH.subn(launch, src)
    assert n == 1, "sw.cu should launch one kernel template"
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
        r = ref.shape[1]
        out = np.full((1 if score_only else 5, b), -777, np.int32)
        key64 = sw_cuda.h_bound(w, r, pad_to, match, mismatch, gap_open,
                                gap_extend) >= sw_cuda.KEY_LIMIT
        ws = np.full(max(sw_cuda.workspace_ints(b, w, r, pad_to, score_only,
                                                key64), 1), -555, np.int32)
        rc = lib.sw_pass_launch(
            q.ctypes.data, ref.ctypes.data, ql.ctypes.data, rl.ctypes.data,
            tm.ctypes.data, out.ctypes.data, ws.ctypes.data, b, w, r, match,
            mismatch, gap_open, gap_extend, mask_len, pad_to,
            int(second_inclusive), int(score_only), None)
        assert rc == 0
        return out
    return run


def _batch(seed, b, w, r):
    """Seeded pairs: every third ref holds its query; qlen 0, 1 and W and
    rlen 0 and 1 among the ragged lengths. Past one tile of 1,024 rows
    (b >= 8), pair 6 holds a query segment with a gap across each tile
    boundary and pair 7 one that repeats in the first and the last tile,
    so the best path crosses tiles and ties between them."""
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
    if w > 1024 and b >= 9:
        ln, h = (r - 2) // 2, (r - 2) // 4
        for k, top in enumerate(range(1024, w, 1024)):
            at = slice(2 + k * ln, 2 + (k + 1) * ln)
            ref[6, at] = q[6, top - h:top - h + ln]
            # pair 8 skips query rows [top - 3, top + 3): a vertical gap
            # through the tile edge
            ref[8, at] = np.concatenate([q[8, top - h:top - 3],
                                         q[8, top + 3:top + 6 + ln - h]])
        q[7, w - ln:] = q[7, :ln]
        ref[7, 2:2 + ln] = q[7, :ln]
        ql[6:9], rl[6:9] = w, r
    return q, ql, ref, rl


SCORING = {"default": {},
           "nondefault": dict(match=3, mismatch=1, gap_open=5, gap_extend=2,
                              mask_len=7),
           "negative": dict(match=1, mismatch=-1, gap_open=2, gap_extend=1)}

# (B, W, R, pad_to, scoring): strips of G = 1 to 32 lanes, a mismatch that
# scores, the aligner's width in both pads, and row tiles: W = 1,100 and
# 2,100 sweep two and three tiles of 1,024 rows
SCORE_CASES = [(40, 100, 128, 16, "default"), (40, 100, 128, 8, "default"),
               (40, 100, 128, 16, "negative"), (30, 7, 30, 1, "default"),
               (30, 17, 21, 8, "nondefault"), (24, 33, 40, 8, "negative"),
               (16, 65, 20, 16, "default"), (12, 129, 20, 8, "nondefault"),
               (8, 257, 16, 8, "default"), (6, 1024, 12, 16, "default"),
               (9, 1100, 40, 16, "default"), (9, 2100, 40, 8, "negative")]


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


# (B, W, R, pad_to, scoring, terminate): pad 8 runs with second_inclusive
# as the aligner's word pass does; terminate at each pair's forward score
FULL_CASES = [
    pytest.param(24, 100, 128, 16, "default", False, id="pad16"),
    pytest.param(24, 100, 128, 8, "default", False, id="pad8"),
    pytest.param(24, 100, 128, 16, "default", True, id="terminate"),
    pytest.param(24, 100, 128, 16, "negative", False, id="negative"),
    pytest.param(24, 100, 128, 8, "negative", True, id="negative-pad8-term"),
    pytest.param(30, 7, 30, 1, "default", True, id="g1-term"),
    pytest.param(30, 7, 30, 16, "nondefault", False, id="g1-pad16"),
    pytest.param(30, 17, 21, 8, "nondefault", False, id="g2"),
    pytest.param(24, 33, 40, 8, "negative", True, id="g4-term"),
    pytest.param(16, 65, 20, 16, "default", True, id="g8-term"),
    pytest.param(12, 129, 20, 8, "nondefault", True, id="g16-term"),
    pytest.param(9, 257, 16, 8, "default", False, id="g32"),
    pytest.param(6, 1024, 12, 16, "default", True, id="g32-s32-term"),
    pytest.param(9, 1100, 40, 16, "default", True, id="tiles2-term"),
    pytest.param(9, 1100, 40, 8, "negative", False, id="tiles2-pad8"),
    pytest.param(9, 2100, 40, 8, "nondefault", True, id="tiles3-pad8-term"),
    pytest.param(9, 2100, 40, 16, "default", False, id="tiles3")]


@pytest.mark.parametrize("b,w,r,pad_to,scoring,terminate", FULL_CASES)
def test_full_kernel_source_matches_plain(launch, b, w, r, pad_to, scoring,
                                          terminate):
    kw = dict(SCORING[scoring], pad_to=pad_to, second_inclusive=pad_to == 8)
    q, ql, ref, rl = _batch(w + r + b, b, w, r)
    t = [torch.from_numpy(a) for a in (q, ql, ref, rl)]
    tm = np.full(b, -1, np.int32)
    if terminate:
        tm = sw.sw_pass(*t, torch.from_numpy(tm), **kw)["score"].numpy()
    got = launch(q, ql, ref, rl, tm, **kw)
    want = sw.sw_pass(*t, torch.from_numpy(tm), **kw)
    for i, k in enumerate(("score", "ref_end", "read_end", "score2",
                           "ref_end2")):
        np.testing.assert_array_equal(got[i], want[k].numpy(), err_msg=k)


# (B, W, R, pad_to, scoring, terminate) whose H passes 2^21, where an
# int32 key H * 1024 + row overflows: match 2,000 over two row tiles, and
# match 25,000 over one tile at the aligner's width (both take the
# int64-key instantiation)
KEY64_CASES = [
    pytest.param(6, 1100, 1100, 16, dict(match=2000), False, id="tiles2"),
    pytest.param(6, 1100, 1100, 8, dict(match=2000, mismatch=1400,
                                        gap_open=1800, gap_extend=600,
                                        mask_len=40), True,
                 id="tiles2-pad8-term"),
    pytest.param(12, 100, 128, 16, dict(match=25000, mismatch=6000), True,
                 id="w100-term")]


@pytest.mark.parametrize("b,w,r,pad_to,scoring,terminate", KEY64_CASES)
def test_full_kernel_source_past_the_int32_key(launch, b, w, r, pad_to,
                                               scoring, terminate):
    """Inputs that the int32 key's limit once refused, where JAX aligns:
    every field equal to the plain sw_pass and to sapling_tpu's."""
    kw = dict(scoring, pad_to=pad_to, second_inclusive=pad_to == 8)
    q, ql, ref, rl = _batch(w + r + b, b, w, r)
    ln = min(w, r - 2)
    q[0] %= 4                           # no N: one pair whose H passes 2^20
    ref[0, 2:2 + ln] = q[0, :ln]
    ql[0], rl[0] = w, r
    t = [torch.from_numpy(a) for a in (q, ql, ref, rl)]
    tm = np.full(b, -1, np.int32)
    if terminate:
        tm = sw.sw_pass(*t, torch.from_numpy(tm), **kw)["score"].numpy()
    got = launch(q, ql, ref, rl, tm, **kw)
    want = sw.sw_pass(*t, torch.from_numpy(tm), **kw)
    jax = jsw.sw_pass(q, ql, ref, rl, tm, **kw)
    assert want["score"].max() >= 1 << 21
    for i, k in enumerate(("score", "ref_end", "read_end", "score2",
                           "ref_end2")):
        np.testing.assert_array_equal(got[i], want[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(got[i], np.asarray(jax[k]), err_msg=k)
