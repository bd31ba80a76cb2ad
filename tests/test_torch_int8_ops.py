"""The port's int8 MAC path (``ops.conv1d`` / ``conv1d_stream`` /
``mat_mul`` with a ``QuantizedTensor`` weight, and the plain int8 kernels)
against ``repro.kernels.ops`` on the CPU, bitwise.

JAX's engines run every op under ``jax.jit``, where XLA contracts the
dequant epilogue ``acc * scale + bias`` into one fused multiply-add; eager
JAX rounds twice.  The port computes the fused form on every device, so
the JAX side of each comparison here runs under ``jax.jit``, on the
reference target and on the Pallas kernels in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro import quant as jq
from repro.kernels import fabric as jfabric
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import quant as tq
from repro_torch.core import basecaller as tbc
from repro_torch.kernels import fabric as tfabric
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

FABRICS = ["reference", "pallas_interpret"]


def _eq(got, want):
    got, want = U.n(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _qw(rng, shape, act_scale):
    """A quantized weight in both packages (JAX's carried across)."""
    w = (rng.standard_normal(shape) * 0.2).astype(np.float32)
    jw = jq.quantize_tensor(jnp.asarray(w), axis=len(shape) - 1,
                            act_scale=act_scale)
    return jw, tbc.load_numpy_params(jax.tree.map(np.asarray, jw), U.CPU)


def _midpoint_triples():
    """a * b exactly halfway between two float32 values in [1, 2), plus a
    tiny c: rounding a * b + c in float64 and then to float32 lands on the
    tie, one fused rounding does not."""
    k = np.arange(1, 64, 2, dtype=np.float64)
    a = (1 + k[:, None] * 2.0 ** -12).astype(np.float32)
    b = (1 + k[None, :] * 2.0 ** -12).astype(np.float32)
    a, b = np.broadcast_arrays(a, b)
    sign = np.where(np.arange(a.size).reshape(a.shape) % 2, 1.0, -1.0)
    c = (sign * 2.0 ** -60).astype(np.float32)
    return a.ravel(), b.ravel(), c.ravel()


def test_fma_f32_rounds_once_like_jitted_xla():
    a, b, c = _midpoint_triples()
    rng = np.random.default_rng(0)
    a = np.concatenate([a, rng.standard_normal(4000).astype(np.float32)])
    b = np.concatenate([b, rng.standard_normal(4000).astype(np.float32)])
    c = np.concatenate([c, rng.standard_normal(4000).astype(np.float32)
                        * np.float32(1e-3)])
    want = np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, b, c))
    got = U.n(tref.fma_f32(U.t(a), U.t(b), U.t(c)))
    np.testing.assert_array_equal(got, want)
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (twice != want).sum() > 100          # the ties were exercised
    _eq(tref.fma_f32(U.t(a), U.t(b)), (a.astype(np.float64) * b)
        .astype(np.float32))


@pytest.mark.parametrize("fab", FABRICS)
@pytest.mark.parametrize("cin,cout,k,stride,padding", [
    (16, 128, 7, 2, "same"),      # the Pallas int8 kernel runs (Cout >= 128)
    (1, 64, 5, 1, "same"),        # conv1: Cin = 1
    (8, 5, 7, 2, "valid"),        # Cout = 5, stride 2
    (6, 12, 9, 2, "valid"),       # Cin % 4 != 0
])
def test_conv1d_int8_bitwise(fab, cin, cout, k, stride, padding):
    rng = np.random.default_rng(cin + cout)
    x = rng.standard_normal((3, 41, cin)).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.3).astype(np.float32)
    jw, tw = _qw(rng, (k, cin, cout), 0.021)
    want = jax.jit(lambda v: jops.conv1d(
        v, jw, jnp.asarray(b), stride=stride, padding=padding,
        activation="relu", fabric=fab))(jnp.asarray(x))
    got = tops.conv1d(U.t(x), tw, U.t(b), stride=stride, padding=padding,
                      activation="relu")
    _eq(got, want)
    # the int32 accumulator of the plain kernel against JAX's int8 conv
    aq = np.clip(np.round(x / np.float32(0.021)), -127, 127).astype(np.int8)
    _eq(tq.quantize(U.t(x), tw.act_scale), aq)
    acc = tref.conv1d_int8(U.t(aq), tw.q, stride=stride)
    _eq(acc, jref.conv1d(jnp.asarray(aq), jw.q, stride=stride))
    _eq(acc, jops.conv1d(jnp.asarray(aq), jw.q, stride=stride,
                         padding="valid", fabric=fab))


@pytest.mark.parametrize("fab", FABRICS)
@pytest.mark.parametrize("m,k,n", [(40, 128, 128), (37, 24, 5), (9, 5, 5)])
def test_mat_mul_int8_bitwise(fab, m, k, n):
    """(40, 128, 128) runs JAX's Pallas int8 GEMM; the head's N = 5 and
    the step codec's K = 5 fall back to its reference."""
    rng = np.random.default_rng(m * n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal(n) * 0.3).astype(np.float32)
    jw, tw = _qw(rng, (k, n), 0.03)
    want = jax.jit(lambda v: jops.mat_mul(v, jw, jnp.asarray(b),
                                          fabric=fab))(jnp.asarray(a))
    _eq(tops.mat_mul(U.t(a), tw, U.t(b)), want)
    aq = tq.quantize(U.t(a), tw.act_scale)
    acc = tref.matmul_int8(aq, tw.q)
    _eq(acc, jref.matmul(jnp.asarray(U.n(aq)), jw.q))
    _eq(acc, jops.mat_mul(jnp.asarray(U.n(aq)), jw.q, fabric=fab))


def test_dynamic_act_scale_bitwise():
    """Weight-only quantization: the activation scale comes from this
    call's absmax."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 30, 8)).astype(np.float32) * 4
    jw, tw = _qw(rng, (5, 8, 16), None)
    want = jax.jit(lambda v: jops.conv1d(v, jw, None, fabric="reference"))(
        jnp.asarray(x))
    _eq(tops.conv1d(U.t(x), tw), want)
    jw, tw = _qw(rng, (8, 5), None)
    a = x.reshape(-1, 8)
    want = jax.jit(lambda v: jops.mat_mul(v, jw, fabric="reference"))(
        jnp.asarray(a))
    _eq(tops.mat_mul(U.t(a), tw), want)


@pytest.mark.parametrize("fab", FABRICS)
def test_conv1d_stream_int8_carries(fab):
    """Three chunks: outputs and carries bitwise; the carry is the float
    input, taken before quantization."""
    rng = np.random.default_rng(2)
    b = (rng.standard_normal(16) * 0.3).astype(np.float32)
    jw, tw = _qw(rng, (7, 4, 16), 0.05)
    sig = rng.standard_normal((2, 96, 4)).astype(np.float32)
    step = jax.jit(lambda v, c: jops.conv1d_stream(
        v, jw, jnp.asarray(b), c, stride=2, activation="relu", fabric=fab))
    jc = jnp.zeros((2, 5, 4), jnp.float32)
    tc = None
    for lo in range(0, 96, 32):
        x = sig[:, lo:lo + 32]
        jy, jc = step(jnp.asarray(x), jc)
        ty, tc = tops.conv1d_stream(U.t(x), tw, U.t(b), tc, stride=2,
                                    activation="relu")
        _eq(ty, jy)
        _eq(tc, jc)


def test_int8_counters_match_jax_key_for_key():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 20, 4)).astype(np.float32)
    jw, tw = _qw(rng, (3, 4, 8), 0.05)
    jh, th = _qw(rng, (8, 5), 0.04)
    jbase = jfabric.counters()
    y = jops.conv1d(jnp.asarray(x), jw, fabric="reference")
    jops.mat_mul(y.reshape(-1, 8), jh, fabric="reference")
    jax.effects_barrier()
    jd = jfabric.counters_delta(jbase)
    tbase = tfabric.counters()
    y = tops.conv1d(U.t(x), tw)
    tops.mat_mul(y.reshape(-1, 8), th)
    td = tfabric.counters_delta(tbase)
    assert td == {k: v for k, v in jd.items()
                  if k.startswith(("fabric.dispatch.", "fabric.precision."))}
    assert td["fabric.precision.conv1d.int8"] == 1
    assert td["fabric.precision.matmul.act_static"] == 1


def test_scale_off_the_output_axis_raises():
    w = torch.ones((3, 4, 8))
    qw = tq.quantize_tensor(w, axis=1, act_scale=0.1)
    with pytest.raises(ValueError, match="output"):
        tops.conv1d(torch.ones((1, 9, 4)), qw, padding="valid")
    with pytest.raises(TypeError, match="int8"):
        tref.matmul_int8(torch.ones((2, 2)), torch.ones((2, 2)))
