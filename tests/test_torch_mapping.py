"""Prefix mapping on the port against the JAX package: FM-index search and
the whole ``PrefixMapper`` result, bitwise, on fixed prefixes."""
import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_util as U
from repro.core import fm_index as jfm
from repro.realtime import mapper as jmap
from repro_torch.core import fm_index as tfm
from repro_torch.realtime import mapper as tmap

GENOME_LEN = 3_000


@pytest.fixture(scope="module")
def genome():
    return np.random.default_rng(11).integers(1, 5, GENOME_LEN).astype(
        np.int32)


def test_index_build_is_a_copy(genome):
    j, t = jfm.FMIndex.build(genome), tfm.FMIndex.build(genome)
    for f in ("sa", "occ", "counts"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))


def test_backward_search_bitwise(genome):
    rng = np.random.default_rng(12)
    starts = rng.integers(0, GENOME_LEN - 10, 40)
    seeds = np.stack([genome[s:s + 10] for s in starts])
    seeds[:8] = rng.integers(1, 5, (8, 10))      # mostly absent
    seeds[8:12, :3] = 0                          # zero-padded prefix seeds
    seeds[12:16, :] = genome[100:103].repeat(4)[:10]
    j = jfm.FMIndex.build(genome)
    t = tfm.FMIndex.build(genome)
    jc, jp = jfm.backward_search(j.device_arrays(), jnp.asarray(seeds),
                                 max_hits=8)
    tc, tp = tfm.backward_search(t.device_arrays(U.CPU), U.t(seeds),
                                 max_hits=8)
    np.testing.assert_array_equal(U.n(tc), np.asarray(jc))
    np.testing.assert_array_equal(U.n(tp), np.asarray(jp))
    assert U.n(tc)[16:].min() >= 1               # true substrings found


def _prefixes(genome, rng, lanes=16, length=32):
    """Called-prefix windows: exact, noisy, short (zero-padded tail), and
    random, as the runtime hands them to the mapper."""
    out = np.zeros((lanes, length), np.int32)
    for i in range(lanes):
        s = int(rng.integers(0, GENOME_LEN - length))
        w = genome[s:s + length].copy()
        kind = i % 4
        if kind == 1:
            err = rng.random(length) < 0.08
            w = np.where(err, rng.integers(1, 5, length), w)
        elif kind == 2:
            w[20:] = 0
        elif kind == 3:
            w = rng.integers(1, 5, length)
        out[i] = w
    return out


def test_map_prefixes_bitwise(genome):
    rng = np.random.default_rng(13)
    intervals = [(0, GENOME_LEN // 2)]
    jm = jmap.PrefixMapper(jmap.TargetPanel.build(genome, intervals),
                           fabric="reference")
    tm = tmap.PrefixMapper(tmap.TargetPanel.build(genome, intervals),
                           device=U.CPU)
    for _ in range(2):
        prefixes = _prefixes(genome, rng)
        jr, tr = jm.map_prefixes(prefixes), tm.map_prefixes(prefixes)
        for f in ("mapped", "on_target", "positions", "mapq", "scores"):
            got, want = getattr(tr, f), getattr(jr, f)
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
        assert tr.mapped.any() and not tr.mapped.all()
