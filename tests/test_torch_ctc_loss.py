"""The port's CTC loss and decoders (``repro_torch.core.ctc``) against
``repro.core.ctc`` on the CPU, on the same seeded numpy inputs: the loss and
its gradient (JAX's ``jax.grad``) on ``tests/test_ctc.py``'s cases, the
brute-force path sums (its property draws as seeded cases), trailing-pad
invariance, infeasible labels, and the decoders and token strings.

Bars: the loss within 1e-5 relative (one f32 log-space recursion, summed
in the same order, agrees to a few ulps), the gradient within 1e-5 of its
largest entry."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro.core import ctc as jctc
from repro_torch.core import ctc as tctc

RTOL = 1e-5



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops throughout: one intra-op thread (``U.one_thread``)."""
    with U.one_thread():
        yield

def _losses(logits, lpad, labels, lbl_pad):
    want = np.asarray(jctc.ctc_loss(jnp.asarray(logits), jnp.asarray(lpad),
                                    jnp.asarray(labels),
                                    jnp.asarray(lbl_pad)))
    got = U.n(tctc.ctc_loss(U.t(logits), U.t(lpad), U.t(labels),
                            U.t(lbl_pad)))
    return got, want


def _brute(logits, label):
    """-log of the summed probability of every path that collapses to
    ``label`` (the JAX suite's ``brute_ctc``), in float64."""
    t, c = logits.shape
    lp = torch.log_softmax(torch.as_tensor(logits, dtype=torch.float64),
                           -1).numpy()
    total = -np.inf
    for path in itertools.product(range(c), repeat=t):
        out, prev = [], -1
        for p in path:
            if p != prev and p != 0:
                out.append(p)
            prev = p
        if tuple(out) == tuple(label):
            total = np.logaddexp(total, sum(lp[i, p]
                                            for i, p in enumerate(path)))
    return -total


def _one(logits, label, lpad_to=4):
    labels = np.zeros((1, lpad_to), np.int32)
    labels[0, :len(label)] = label
    lbl_pad = np.ones((1, lpad_to), np.float32)
    lbl_pad[0, :len(label)] = 0
    return _losses(logits[None], np.zeros((1, logits.shape[0]), np.float32),
                   labels, lbl_pad)


@pytest.mark.parametrize("seed", range(20))
def test_vs_brute_force_and_jax(seed):
    """``test_ctc.py::test_vs_brute_force``'s draws (T 3-6, labels 0-3 long
    over 2 classes), as seeded cases: equal to JAX within 1e-5, and to the
    path sum within its 1e-3 (an impossible label costs > 1e5)."""
    draw = np.random.default_rng(1000 + seed)
    t, n = int(draw.integers(3, 7)), int(draw.integers(0, 4))
    rng = np.random.default_rng(int(draw.integers(0, 10_000)))
    logits = rng.normal(size=(t, 3)).astype(np.float32)
    label = rng.integers(1, 3, size=n).astype(np.int32)
    got, want = _one(logits, label)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    brute = _brute(logits, label)
    if np.isinf(brute):
        assert got[0] > 1e5
    else:
        assert abs(brute - got[0]) < 1e-3


def test_trailing_pad_invariance():
    """Padded frames carry alpha: appending padded frames leaves the loss
    unchanged (``test_ctc.py::test_trailing_pad_invariance``)."""
    rng = np.random.default_rng(5)
    t = 6
    logits = rng.normal(size=(1, t, 3)).astype(np.float32)
    lab = np.array([[1, 2, 0]], np.int32)
    lp = np.array([[0.0, 0.0, 1.0]], np.float32)
    base, jbase = _losses(logits, np.zeros((1, t), np.float32), lab, lp)
    logits2 = np.concatenate(
        [logits, rng.normal(size=(1, 3, 3)).astype(np.float32)], 1)
    pad2 = np.concatenate([np.zeros((1, t)), np.ones((1, 3))],
                          1).astype(np.float32)
    padded, jpadded = _losses(logits2, pad2, lab, lp)
    assert abs(base[0] - padded[0]) < 1e-4
    np.testing.assert_allclose([base[0], padded[0]], [jbase[0], jpadded[0]],
                               rtol=RTOL)


def test_infeasible_and_empty_labels():
    """Labels longer than the frames cost exactly 1e6 (not inf, not
    ``zero_infinity``'s 0); an empty label is the all-blank path."""
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(3, 4, 5)).astype(np.float32)
    labels = np.array([[1, 2, 3, 4, 1, 2], [1, 2, 0, 0, 0, 0],
                       [0, 0, 0, 0, 0, 0]], np.int32)
    lbl_pad = np.array([[0] * 6, [0, 0, 1, 1, 1, 1], [1] * 6], np.float32)
    got, want = _losses(logits, np.zeros((3, 4), np.float32), labels,
                        lbl_pad)
    assert got[0] == np.float32(1e6) == want[0]
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("b,t,n,seed", [(2, 8, 3, 0), (4, 30, 7, 1),
                                        (3, 17, 5, 2)])
def test_loss_and_gradient_equal_jax_grad(b, t, n, seed):
    """``test_ctc.py::test_loss_differentiable``'s batch, and longer ones
    with ragged frames and labels: the mean loss and d(loss)/d(logits)
    against ``jax.grad``."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, t, 5)).astype(np.float32)
    labels = rng.integers(1, 5, (b, n)).astype(np.int32)
    lbl_pad = np.zeros((b, n), np.float32)
    lpad = np.zeros((b, t), np.float32)
    if b > 2:
        lbl_pad[1, n - 2:] = 1.0
        lpad[2, t - 4:] = 1.0

    def jloss(lg):
        return jctc.ctc_loss(lg, jnp.asarray(lpad), jnp.asarray(labels),
                             jnp.asarray(lbl_pad)).mean()
    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = U.t(logits).requires_grad_()
    tl = tctc.ctc_loss(x, U.t(lpad), U.t(labels), U.t(lbl_pad)).mean()
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL)
    g, jg = U.n(x.grad), np.asarray(jg)
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-5 * np.abs(jg).max())


def test_greedy_viterbi_and_beam():
    """Greedy collapse, Viterbi's path score and tokens, and the prefix
    beam search on peaked and on random logits."""
    logits = np.full((1, 7, 5), -5.0, np.float32)
    for t, c in enumerate([1, 1, 0, 2, 0, 3, 3]):
        logits[0, t, c] = 5.0
    toks, lens = tctc.greedy_decode(U.t(logits))
    assert U.n(toks[0][:int(lens[0])]).tolist() == [1, 2, 3]
    peaked = np.full((8, 5), -8.0, np.float32)
    for t, c in enumerate([1, 0, 2, 2, 0, 3, 4, 4]):
        peaked[t, c] = 8.0
    assert tctc.beam_decode_np(peaked, beam=4).tolist() == [1, 2, 3, 4]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 5)).astype(np.float32)
    jt, jn, js = jctc.viterbi_decode(jnp.asarray(x))
    tt, tn, ts = tctc.viterbi_decode(U.t(x))
    np.testing.assert_array_equal(U.n(tt), np.asarray(jt))
    np.testing.assert_array_equal(U.n(tn), np.asarray(jn))
    np.testing.assert_allclose(U.n(ts), np.asarray(js), rtol=RTOL)
    for i in range(4):
        lg = rng.normal(size=(12, 5)).astype(np.float32) * 2
        got = tctc.beam_decode_np(lg, beam=8)
        want = jctc.beam_decode_np(lg, beam=8)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_token_strings():
    s = "ACGTTGCA"
    toks = tctc.str_to_tokens(s)
    np.testing.assert_array_equal(toks, jctc.str_to_tokens(s))
    assert tctc.tokens_to_str(toks) == s == jctc.tokens_to_str(toks)
    padded = np.array([1, 0, 2, 9, 3, 4, 0], np.int32)
    for length in (None, 4):
        assert (tctc.tokens_to_str(torch.as_tensor(padded), length)
                == jctc.tokens_to_str(padded, length))
