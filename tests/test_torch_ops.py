"""The port's plain kernel versions and ops wrappers against the JAX package
(``repro.kernels.ops`` / ``ref``) on the CPU.

Float ops are held at rtol/atol 2e-5, the JAX suite's own f32 bar
(tests/test_kernels.py); banded alignment scores are int32 and must be
bitwise equal, against both the JAX oracle and its Pallas kernel run in
interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import fabric as tfabric
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = 2e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("act", ["none", "relu", "squared_relu", "silu",
                                 "gelu"])
def test_mat_mul_activations(act):
    rng = np.random.default_rng(0)
    a, b, bias = _rand(rng, 37, 24), _rand(rng, 24, 5), _rand(rng, 5)
    want = jops.mat_mul(jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias),
                        activation=act, fabric="reference")
    got = tops.mat_mul(U.t(a), U.t(b), U.t(bias), activation=act)
    np.testing.assert_allclose(U.n(got), np.asarray(want), rtol=TOL, atol=TOL)


def test_gelu_is_the_tanh_form():
    x = torch.linspace(-4, 4, 101)
    got = tref.ACTIVATIONS["gelu"](x)
    want = np.asarray(jref._ACTIVATIONS["gelu"](jnp.asarray(U.n(x))))
    np.testing.assert_allclose(U.n(got), want, rtol=TOL, atol=TOL)
    erf = torch.nn.functional.gelu(x)
    assert float((got - erf).abs().max()) > 1e-4   # not the erf form


@pytest.mark.parametrize("cin,cout,k,stride,padding", [
    (1, 5, 2, 2, "valid"),      # the step codec's conv1
    (1, 16, 5, 1, "same"),      # Cin = 1
    (8, 5, 7, 2, "same"),       # Cout = 5, stride 2
    (6, 12, 9, 2, "valid"),
])
def test_conv1d(cin, cout, k, stride, padding):
    rng = np.random.default_rng(1)
    x, w, b = _rand(rng, 3, 41, cin), _rand(rng, k, cin, cout), _rand(rng, cout)
    want = jops.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                       stride=stride, padding=padding, activation="relu",
                       fabric="reference")
    got = tops.conv1d(U.t(x), U.t(w), U.t(b), stride=stride, padding=padding,
                      activation="relu")
    assert got.shape == want.shape
    np.testing.assert_allclose(U.n(got), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("fabric", ["reference", "pallas_interpret"])
def test_conv1d_stream_carry(fabric):
    """Three chunks with the K - stride carry equal the JAX stream op chunk
    for chunk, carries included."""
    rng = np.random.default_rng(2)
    w, b = _rand(rng, 7, 4, 5), _rand(rng, 5)
    sig = _rand(rng, 2, 96, 4)
    jc, tc = None, None
    for lo in range(0, 96, 32):
        x = sig[:, lo:lo + 32]
        jy, jc = jops.conv1d_stream(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b), jc, stride=2,
                                    activation="relu", fabric=fabric)
        ty, tc = tops.conv1d_stream(U.t(x), U.t(w), U.t(b), tc, stride=2,
                                    activation="relu")
        np.testing.assert_allclose(U.n(ty), np.asarray(jy), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(U.n(tc), np.asarray(jc))
    with pytest.raises(ValueError, match="K - stride"):
        tops.conv1d_stream(U.t(sig[:, :32]), U.t(w), U.t(b),
                           torch.zeros((2, 3, 4)), stride=2)


def _pairs(rng, p, m, n):
    q = rng.integers(1, 5, size=(p, m)).astype(np.int32)
    tail = rng.integers(0, 5, size=(p, n - m)).astype(np.int32)
    t = np.concatenate([q, tail], axis=1)
    mut = rng.random(t.shape) < 0.2
    t = np.where(mut, rng.integers(0, 5, size=t.shape), t).astype(np.int32)
    return q, t


@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("band,m,n", [(0, 12, 12), (3, 12, 20), (11, 12, 20),
                                      (32, 16, 48)])
def test_banded_align_bitwise(local, band, m, n):
    """Band 0, a narrow band, the band that just reaches the corner
    (|m - n| <= band fails or holds at the edge), and the mapper's band."""
    rng = np.random.default_rng(3 + band)
    q, t = _pairs(rng, 9, m, n)
    kw = dict(band=band, match=2, mismatch=-4, gap=-2, local=local)
    want_ref = np.asarray(jref.banded_align(jnp.asarray(q), jnp.asarray(t),
                                            **kw))
    want_pallas = np.asarray(jops.banded_align(
        jnp.asarray(q), jnp.asarray(t), fabric="pallas_interpret", **kw))
    got = U.n(tops.banded_align(U.t(q), U.t(t), **kw))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_array_equal(got, want_pallas)


def test_dispatch_counts_reference_target_on_cpu():
    base = tfabric.counters()
    scope = tfabric.ScopedCounters()
    with tfabric.scoped(scope):
        tops.mat_mul(torch.ones((4, 3)), torch.ones((3, 2)))
        tops.conv1d(torch.ones((1, 8, 1)), torch.ones((2, 1, 5)),
                    padding="valid")
    delta = tfabric.counters_delta(base)
    assert delta["fabric.dispatch.matmul.reference"] == 1
    assert delta["fabric.dispatch.conv1d.reference"] == 1
    assert scope.snapshot() == {"fabric.dispatch.matmul.reference": 1,
                                "fabric.dispatch.conv1d.reference": 1}


def test_plain_versions_are_float32_only():
    with pytest.raises(TypeError, match="float32"):
        tref.matmul(torch.ones((2, 2), dtype=torch.int8),
                    torch.ones((2, 2), dtype=torch.int8))
    with pytest.raises(TypeError, match="int32"):
        tref.banded_align(torch.ones((2, 2)), torch.ones((2, 2)), band=1)
