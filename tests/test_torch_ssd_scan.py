"""The port's plain SSD versions against the JAX package: the recurrence
(``kernels/ref.py::ssd_scan``, what ``ops.ssd_scan`` runs on a CPU tensor)
and the chunked scan (``models/mamba2.py::ssd_chunked``) against JAX's
oracle, its Pallas kernel in interpret mode (which zero-pads a ragged T)
and its ``ssd_chunked``; the closed-form final state against the
recurrence's.  Bar: 2e-4, the JAX suite's own (tests/test_kernels.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro.kernels import fabric as jfabric
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import mamba2 as jm
from repro_torch.kernels import fabric as tfabric
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.models import mamba2 as tm

TOL = 2e-4


def _inputs(t, seed=0, bh=3, dh=16, ds=32):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((bh, t, dh)) * 0.5).astype(np.float32)
    la = -np.logaddexp(rng.standard_normal((bh, t)), 0).astype(np.float32)
    b = (rng.standard_normal((bh, t, ds)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((bh, t, ds)) * 0.3).astype(np.float32)
    return x, la, b, c


def _close(got, want):
    np.testing.assert_allclose(U.n(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("t,chunk", [(64, 16), (100, 32), (32, 32)])
def test_ops_ssd_scan_vs_pallas_interpret_and_oracle(t, chunk):
    arrs = _inputs(t)
    jarrs = [jnp.asarray(a) for a in arrs]
    with jfabric.use("pallas_interpret"):
        want = jops.ssd_scan(*jarrs, chunk=chunk)
    ye, se = jref.ssd_scan(*jarrs)
    before = tfabric.counters()
    got = tops.ssd_scan(*[U.t(a) for a in arrs], chunk=chunk)
    assert tfabric.counters_delta(before) == {
        "fabric.dispatch.ssd_scan.reference": 1}
    _close(got, want)
    y, s = tref.ssd_scan(*[U.t(a) for a in arrs])
    _close(y, ye)
    _close(s, se)


@pytest.mark.parametrize("t,chunk", [(64, 16), (96, 32), (32, 32)])
def test_ssd_chunked_vs_jax_and_recurrence(t, chunk):
    arrs = _inputs(t, seed=1)
    ta = [U.t(a) for a in arrs]
    ye, se = jm.ssd_chunked(*[jnp.asarray(a) for a in arrs], chunk)
    y, s = tm.ssd_chunked(*ta, chunk)
    _close(y, ye)
    _close(s, se)
    yr, sr = tref.ssd_scan(*ta)
    _close(y, yr)
    _close(s, sr)


def test_ssd_chunked_carries_an_incoming_state():
    arrs = _inputs(64, seed=2)
    s0 = np.random.default_rng(3).standard_normal((3, 32, 16)).astype(
        np.float32)
    ye, se = jm.ssd_chunked(*[jnp.asarray(a) for a in arrs], 16,
                            state0=jnp.asarray(s0))
    y, s = tm.ssd_chunked(*[U.t(a) for a in arrs], 16, state0=U.t(s0))
    _close(y, ye)
    _close(s, se)
    yr, sr = tref.ssd_scan(*[U.t(a) for a in arrs], state0=U.t(s0))
    _close(y, yr)
    _close(s, sr)


def test_strong_decay_forgets():
    # with log_a ~ -inf the scan reduces to per-step (c . b) x
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, 8)).astype(np.float32)
    la = np.full((2, 32), -40.0, np.float32)
    b = rng.standard_normal((2, 32, 8)).astype(np.float32)
    c = rng.standard_normal((2, 32, 8)).astype(np.float32)
    want = np.einsum("pts,pts->pt", c, b)[..., None] * x
    _close(tops.ssd_scan(U.t(x), U.t(la), U.t(b), U.t(c), chunk=8), want)
    _close(tm.ssd_chunked(U.t(x), U.t(la), U.t(b), U.t(c), 8)[0], want)
    with jfabric.use("pallas_interpret"):
        _close(jops.ssd_scan(*[jnp.asarray(a) for a in (x, la, b, c)],
                             chunk=8), want)


@pytest.mark.parametrize("t", [64, 100])
def test_closed_form_final_state_equals_recurrence(t):
    arrs = _inputs(t, seed=5)
    ta = [U.t(a) for a in arrs]
    _, sr = tref.ssd_scan(*ta)
    _close(tm.final_state(ta[0], ta[1], ta[2]), sr)
    # and JAX's closed form (mamba2.py:158-163) on the same inputs
    cum = jnp.cumsum(jnp.asarray(arrs[1]), axis=1)
    w = jnp.exp(cum[:, -1:] - cum)
    want = jnp.einsum("pls,pld->psd", jnp.asarray(arrs[2]) * w[..., None],
                      jnp.asarray(arrs[0]))
    _close(tm.final_state(ta[0], ta[1], ta[2]), want)


def test_bf16_inputs_compute_in_f32():
    arrs = _inputs(64, seed=6)
    jb = [jnp.asarray(a, jnp.bfloat16) if i != 1 else jnp.asarray(a)
          for i, a in enumerate(arrs)]
    tb = [U.t(a, torch.bfloat16) if i != 1 else U.t(a)
          for i, a in enumerate(arrs)]
    with jfabric.use("pallas_interpret"):
        want = jops.ssd_scan(*jb, chunk=16)
    got = tops.ssd_scan(*tb, chunk=16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    U.assert_bf16_close(got.float(), np.asarray(want.astype(jnp.float32)),
                        1, "bf16 ssd")


@pytest.mark.parametrize("chunk,t,want", [(256, 4096, 256), (256, 100, 128),
                                          (32, 64, 64), (256, 32768, 256),
                                          (16, 1, 64)])
def test_kernel_chunk(chunk, t, want):
    assert kssd.kernel_chunk(chunk, t) == want
