"""Parity: the port's probes == sapling_tpu's, field by field.

`probe_at` (packed 2-bit genome compare) and both forms of
`make_rank_probe` (packed genome; per-rank prefix64) give match, smaller,
off_end and lcp for the same seeded positions and queries as the JAX
functions, at random positions and at the genome's end (n-1, n-L), where
the compare runs off the genome. The clz helper is checked on its edge
words.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sapling_tpu.ops import query as jq
from sapling_tpu_torch.config import IndexConfig
from sapling_tpu_torch.index.sapling import SaplingIndex
from sapling_tpu_torch.ops import pack as packops
from sapling_tpu_torch.ops import query as tq
from sapling_tpu_torch.sim.genomes import repeat_genome, uniform_genome

FIELDS = ("match", "smaller", "off_end", "lcp")


@pytest.fixture(scope="module")
def index():
    seq = np.concatenate([uniform_genome(5000, seed=3),
                          repeat_genome(1003, period=17, seed=4)])
    return SaplingIndex.build(seq, IndexConfig(k=12, buckets=8),
                              device="cpu")


def _queries(idx, pos, length, rng):
    """Half the lanes copy the genome at pos (then one base changed in a
    quarter of them), half are random; tails past n stay random."""
    b = pos.shape[0]
    codes = rng.integers(0, 4, (b, length)).astype(np.uint8)
    for i in range(0, b, 2):
        m = min(length, idx.n - int(pos[i]))
        codes[i, :m] = idx.codes[pos[i]:pos[i] + m]
        if i % 4 == 0:
            j = int(rng.integers(0, length))
            codes[i, j] = (codes[i, j] + 1) % 4
    return codes


def _positions(idx, length, rng):
    return np.concatenate([rng.integers(0, idx.n, 300),
                           [idx.n - 1, idx.n - length, 0,
                            idx.n - length + 1, idx.n - 2]]).astype(np.int64)


def _same(got, want, msg):
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)),
            err_msg=f"{msg} field {f}")


@pytest.mark.parametrize("length", [1, 7, 16, 17, 21, 32, 33, 50])
def test_probe_at_matches_jax(index, length):
    rng = np.random.default_rng(length)
    pos = _positions(index, length, rng)
    codes = _queries(index, pos, length, rng)
    qw = packops.pack_queries(codes)
    want = jq.probe_at(jnp.asarray(index.packed), jnp.asarray(pos),
                       jnp.asarray(qw), n=index.n, length=length)
    got = tq.probe_at(torch.from_numpy(index.packed.astype(np.int64)),
                      torch.from_numpy(pos),
                      torch.from_numpy(qw.astype(np.int64)), n=index.n,
                      length=length)
    _same(got, want, f"L={length}")


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix64", "packed"])
@pytest.mark.parametrize("length", [5, 16, 21, 32, 40])
def test_rank_probe_matches_jax(index, prefix, length):
    """Both make_rank_probe forms (prefix64 only serves length <= 32)
    against JAX's, at random ranks and the ranks of the genome's last
    suffixes."""
    rng = np.random.default_rng(100 + length)
    tail = index.inv[[index.n - 1, index.n - length, index.n - 2]]
    ranks = np.concatenate([rng.integers(0, index.n, 300),
                            tail, [0, index.n - 1]]).astype(np.int64)
    pos = index.rev[ranks].astype(np.int64)
    codes = _queries(index, pos, length, rng)
    qw = packops.pack_queries(codes)
    dev = index.device_arrays()
    jpref = jnp.asarray(index.prefix64) if prefix else None
    jprobe = jq.make_rank_probe(
        jnp.asarray(index.packed), jnp.asarray(index.rev), jpref,
        jnp.asarray(qw), n=index.n, length=length, idt=jnp.int32)
    tprobe = tq.make_rank_probe(
        dev["packed"], dev["rev"], dev["prefix64"] if prefix else None,
        torch.from_numpy(qw.astype(np.int64)), n=index.n, length=length)
    want_pos, want = jprobe(jnp.asarray(ranks))
    got_pos, got = tprobe(torch.from_numpy(ranks))
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    _same(got, want, f"L={length}")


def test_clz32_edge_words():
    words = [0, 1, 2, 3, 0x7FFF, 0x8000, 0xFFFF, 0x10000, 0x7FFFFFFF,
             0x80000000, 0xFFFFFFFF] + [1 << s for s in range(32)]
    got = tq._clz32(torch.tensor(words, dtype=torch.int64)).tolist()
    want = [32 - w.bit_length() for w in words]
    assert got == want
    jw = np.asarray(jq._clz32(jnp.asarray(np.array(words, np.uint32))))
    assert got == jw.tolist()


def test_gather64_reads_uint32_bits():
    a = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    t = torch.from_numpy(a.view(np.int32))
    got = tq.gather64(t, torch.arange(5))
    assert got.dtype == torch.int64
    assert got.tolist() == a.astype(np.int64).tolist()
