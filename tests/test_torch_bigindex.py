"""The chromosome-scale index path of the port against the JAX package's.

The port's twins of tools/build_big_index.py (main and build_split),
tools/retable_index.py, tools/swap_table_artifact.py and
tools/add_bucket_bounds.py write the same arrays as the JAX tools on the
same seeded benchmark genome; SaplingIndex.load(skip, mmap) and
swap_table answer queries as sapling_tpu's do.
"""

import os
import shutil
import sys
import warnings

import numpy as np
import pytest

from sapling_tpu.index.sapling import SaplingIndex as JaxIndex
from sapling_tpu_torch.index.sapling import SaplingIndex
from sapling_tpu_torch.tools import (add_bucket_bounds, build_big_index,
                                     retable_index, swap_table_artifact)
from sapling_tpu_torch.tools.retable_index import load_table

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import add_bucket_bounds as jax_add_bounds  # noqa: E402
import build_big_index as jax_build  # noqa: E402
import retable_index as jax_retable  # noqa: E402
import swap_table_artifact as jax_swap  # noqa: E402

N, K, NB = 300_000, 16, 12
QUERY_SKIP = ("inv", "inv_hi", "lcpk_fwd", "lcpk_bwd")


def assert_same_npz(a: str, b: str):
    """Every member of two .npz files equal, dtype and shape included."""
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for name in za.files:
            x, y = za[name], zb[name]
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The port's and JAX's build_big_index main, aligner=1 bounds=1."""
    d = tmp_path_factory.mktemp("big")
    args = [f"n={N}", f"k={K}", f"nb={NB}", "aligner=1", "bounds=1",
            "stage=0", "workers=2"]
    ours, theirs = str(d / "torch.stpu.npz"), str(d / "jax.stpu.npz")
    assert build_big_index.main(["b", *args, f"out={ours}"]) == 0
    assert jax_build.main(["b", *args, f"out={theirs}"]) == 0
    return ours, theirs


def _copy(src, dst):
    shutil.copy(src, dst)
    return str(dst)


def _queries(idx, lengths=(16, 31), nq=1500, seed=0):
    rng = np.random.default_rng(seed)
    for length in lengths:
        starts = rng.integers(0, idx.n - length, nq)
        codes = idx.codes[starts[:, None] + np.arange(length)].copy()
        codes[:100] = rng.integers(0, 4, (100, length))
        yield length, codes


def test_build_big_index_main_matches_jax(built):
    ours, theirs = built
    assert_same_npz(ours, theirs)
    with np.load(ours) as z:
        assert z["bounds"].size and z["lcpk_fwd"].size == N - 1
        assert z["rev"].dtype == np.uint32


def test_build_split_matches_jax(tmp_path):
    n, k, nb = 250_000, 21, 10
    ours, theirs = str(tmp_path / "t.stpu.npz"), str(tmp_path / "j.stpu.npz")
    build_big_index.build_split(n, k, nb, workers=2, out=ours)
    jax_build.build_split(n, k, nb, workers=2, out=theirs)
    assert_same_npz(ours, theirs)
    with np.load(ours) as z:
        assert int(z["format_version"]) == 4 and z["rev_hi"].size == n


@pytest.mark.parametrize("full", [0, 1])
def test_retable_then_swap_matches_jax(built, tmp_path, full):
    """retable_index (table-only or full=1) and then, on the table-only
    output, swap_table_artifact: both tools give the JAX tools' files."""
    src = built[0]
    outs = []
    for name, tool in (("t", retable_index), ("j", jax_retable)):
        out = str(tmp_path / (f"{name}_nb14" + (".stpu.npz" if full
                                                else ".table.npz")))
        assert tool.main(["r", src, "nb=14", "workers=2", f"full={full}",
                          f"out={out}"]) == 0
        outs.append(out)
    assert_same_npz(*outs)
    if full:
        return
    arts = [_copy(src, tmp_path / f"{name}.stpu.npz") for name in "tj"]
    assert swap_table_artifact.main(["s", arts[0], outs[0]]) == 0
    assert jax_swap.main(["s", arts[1], outs[1]]) == 0
    assert_same_npz(*arts)
    with np.load(arts[0]) as z:
        # the JAX tool drops the per-bucket bounds; so does the twin
        assert int(z["buckets"]) == 14 and z["bounds"].size == 0


def test_add_bucket_bounds_matches_jax(built, tmp_path):
    src = built[0]
    table = str(tmp_path / "nb13.table.npz")
    assert retable_index.main(["r", src, "nb=13", "workers=2",
                               f"out={table}"]) == 0
    arts = [_copy(src, tmp_path / f"{name}.stpu.npz") for name in "tj"]
    swap_table_artifact.main(["s", arts[0], table])
    swap_table_artifact.main(["s", arts[1], table])
    assert add_bucket_bounds.main(["a", arts[0]]) == 0
    assert jax_add_bounds.main(["a", arts[1]]) == 0
    assert_same_npz(*arts)
    with np.load(arts[0]) as z:
        assert z["bounds"].size == 1 << 13


def test_load_skip_mmap(built, monkeypatch):
    """Skipped members load as None or empty and mapped members equal the
    eager load's; queries answer as an eager load and as sapling_tpu's
    load with the same skip and mmap; no tensor is made of a read-only
    map. The port maps members with numpy's public header readers only
    (newer numpy has no private np.lib.format._check_version, which the
    JAX package's copy calls)."""
    src = built[0]
    jidx = JaxIndex.load(src, skip=QUERY_SKIP, mmap=True)
    eager = SaplingIndex.load(src, device="cpu")
    monkeypatch.delattr(np.lib.format, "_check_version", raising=False)
    lazy = SaplingIndex.load(src, skip=QUERY_SKIP, mmap=True, device="cpu")
    assert lazy.inv.size == 0 and lazy.lcpk_fwd is None
    assert lazy.lcpk_bwd is None and lazy.inv_hi is None
    assert isinstance(lazy.rev, np.memmap) and not lazy.rev.flags.writeable
    for f in ("packed", "rev", "codes"):
        np.testing.assert_array_equal(getattr(lazy, f), getattr(eager, f))
    for f in ("xlist", "ylist", "bounds"):
        np.testing.assert_array_equal(getattr(lazy.table, f),
                                      getattr(eager.table, f))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        dev = lazy.device_arrays()
    assert all(t is None or t.numpy().flags.writeable for t in dev.values())
    for length, codes in _queries(lazy):
        got = lazy.query_positions(codes)
        np.testing.assert_array_equal(got, eager.query_positions(codes))
        np.testing.assert_array_equal(
            got, np.asarray(jidx.query_positions(codes)), err_msg=length)
        assert lazy.verify_hits(codes[100:], got[100:]).all()


def test_swap_table_after_device_arrays(built, tmp_path):
    """swap_table on an index whose device arrays exist: the positions
    equal a fresh index carrying that table and sapling_tpu's swap_table
    result, and rev and packed stay the same tensors."""
    src = built[0]
    table_path = str(tmp_path / "nb14.table.npz")
    # serial: this process has run JAX queries, so it forks no workers
    assert retable_index.main(["r", src, "nb=14", "workers=1",
                               f"out={table_path}"]) == 0
    idx = SaplingIndex.load(src, skip=QUERY_SKIP, mmap=True, device="cpu")
    dev = idx.device_arrays()
    rev, packed, xlist = dev["rev"], dev["packed"], dev["xlist"]
    table = load_table(table_path, idx.n, idx.k)
    idx.swap_table(table)
    dev = idx.device_arrays()
    assert dev["rev"] is rev and dev["packed"] is packed
    assert dev["rev"].data_ptr() == rev.data_ptr()
    assert dev["xlist"] is not xlist and idx.buckets == 14
    assert dev["bounds"] is None          # the table-only npz has none
    np.testing.assert_array_equal(dev["xlist"].numpy(), table.xlist)

    fresh = SaplingIndex.load(src, device="cpu")
    fresh.table, fresh.buckets = table, table.buckets
    jidx = JaxIndex.load(src)
    jidx.device_arrays()
    jidx.swap_table(table)
    for length, codes in _queries(idx, seed=1):
        got = idx.query_positions(codes)
        np.testing.assert_array_equal(got, fresh.query_positions(codes))
        np.testing.assert_array_equal(
            got, np.asarray(jidx.query_positions(codes)), err_msg=length)
