"""Edit distance, the port against the JAX package on the CPU: the row-scan
DP (``kernels/ref.py::edit_distance``, with and without per-pair lengths),
the op (``kernels/ops.py::edit_distance``) under both JAX targets, and the
classic numpy DP, all bitwise.  Then the metric properties of
``tests/test_edit_distance_props.py`` on the port's op."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from optional_hypothesis import given, settings, strategies as st
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import edit_distance as ked
from repro_torch.kernels import fabric as tfabric
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SHAPES = [(12, 12), (7, 13), (16, 5), (1, 9)]


def _pairs(seed, m, n, p=9):
    rng = np.random.default_rng(seed)
    q = rng.integers(1, 5, (p, m)).astype(np.int32)
    t = q[:, :n].copy() if n <= m else np.concatenate(
        [q, rng.integers(1, 5, (p, n - m))], axis=1).astype(np.int32)
    mut = rng.random(t.shape) < 0.3
    t = np.where(mut, rng.integers(1, 5, t.shape), t).astype(np.int32)
    t[0] = rng.integers(1, 5, n)            # one unrelated pair
    return q, t


@pytest.mark.parametrize("m,n", SHAPES)
def test_ref_edit_distance_matches_jax_and_numpy(m, n):
    q, t = _pairs(m * 31 + n, m, n)
    got = U.n(tref.edit_distance(U.t(q), U.t(t)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, np.asarray(jref.edit_distance(jnp.asarray(q), jnp.asarray(t))))
    np.testing.assert_array_equal(
        got, [jref.edit_distance_np(a, b) for a, b in zip(q, t)])
    np.testing.assert_array_equal(
        got, [tref.edit_distance_np(a, b) for a, b in zip(q, t)])


@pytest.mark.parametrize("m,n", SHAPES)
def test_ref_edit_distance_with_lengths_matches_jax(m, n):
    q, t = _pairs(m * 17 + n, m, n)
    rng = np.random.default_rng(m + n)
    q_len = rng.integers(0, m + 1, len(q)).astype(np.int32)
    t_len = rng.integers(0, n + 1, len(q)).astype(np.int32)
    q_len[0], t_len[0] = m, n
    got = U.n(tref.edit_distance(U.t(q), U.t(t), U.t(q_len), U.t(t_len)))
    want = jref.edit_distance(jnp.asarray(q), jnp.asarray(t),
                              jnp.asarray(q_len), jnp.asarray(t_len))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(
        got, [tref.edit_distance_np(a[:lq], b[:lt])
              for a, b, lq, lt in zip(q, t, q_len, t_len)])


@pytest.mark.parametrize("target", ["reference", "pallas_interpret"])
def test_op_matches_jax_op_under_both_targets(target):
    q, t = _pairs(5, 12, 12, p=24)
    before = tfabric.counters().get("fabric.dispatch.edit_distance.reference",
                                    0)
    got = U.n(tops.edit_distance(U.t(q), U.t(t)))
    after = tfabric.counters()["fabric.dispatch.edit_distance.reference"]
    assert after == before + 1
    want = jops.edit_distance(jnp.asarray(q), jnp.asarray(t), block_p=8,
                              fabric=target)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_levenshtein_wrapper_on_cpu_runs_the_plain_dp():
    q, t = _pairs(8, 10, 14)
    before = ked.levenshtein.launches
    got = ked.levenshtein(U.t(q), U.t(t))
    assert ked.levenshtein.launches == before      # no kernel on the CPU
    assert torch.equal(got, tref.edit_distance(U.t(q), U.t(t)))
    # the op casts any integer tokens to int32 first
    got64 = tops.edit_distance(U.t(q.astype(np.int64)), U.t(t))
    assert got64.dtype == torch.int32 and torch.equal(got64, got)


def test_levenshtein_is_the_unit_cost_banded_dp():
    """What the card computes: global NW with match 0, mismatch -1, gap -1
    and band = max(m, n) is minus the edit distance."""
    q, t = _pairs(9, 11, 15)
    score = tref.banded_align(U.t(q), U.t(t), band=15, match=0, mismatch=-1,
                              gap=-1, local=False)
    assert torch.equal(-score, tref.edit_distance(U.t(q), U.t(t)))


def test_empty_batch():
    q = torch.zeros((0, 6), dtype=torch.int32)
    assert tops.edit_distance(q, q).shape == (0,)


# ------------------------------------------- metric properties (hypothesis) --
seq = st.lists(st.integers(1, 4), min_size=1, max_size=24)


def dist(a, b):
    qa = torch.tensor([a], dtype=torch.int32)
    ta = torch.tensor([b], dtype=torch.int32)
    return int(tops.edit_distance(qa, ta)[0])


def _symmetry(a, b):
    assert dist(a, b) == dist(b, a)


def _bounds(a, b):
    d = dist(a, b)
    assert abs(len(a) - len(b)) <= d <= max(len(a), len(b))


def _classic_dp(a, b):
    assert dist(a, b) == jref.edit_distance_np(np.array(a), np.array(b))


@pytest.mark.parametrize("prop", [_symmetry, _bounds, _classic_dp],
                         ids=["symmetry", "bounds", "classic_dp"])
@settings(max_examples=25, deadline=None)
@given(seq, seq)
def test_pair_property(prop, a, b):
    prop(a, b)


@settings(max_examples=25, deadline=None)
@given(seq)
def test_identity(a):
    assert dist(a, a) == 0


@settings(max_examples=15, deadline=None)
@given(seq, seq, seq)
def test_triangle_inequality(a, b, c):
    assert dist(a, c) <= dist(a, b) + dist(b, c)


@settings(max_examples=20, deadline=None)
@given(seq, st.integers(0, 3))
def test_single_edit_distance_one(a, kind):
    b = list(a)
    if kind == 0:                            # substitution
        b[0] = (b[0] % 4) + 1
    elif kind == 1:                          # insertion
        b.insert(len(b) // 2, 1)
    elif kind == 2 and len(b) > 1:           # deletion
        b.pop()
    assert dist(a, b) == (0 if b == list(a) else 1)
