"""The port's int8 numerics (``repro_torch.quant``) against ``repro.quant``
on the CPU, bitwise: quantize (exact .5 ties included), scales, the
observers, ``quantize_params`` on the paper CNN, and the port's own
calibration (its act scales within one histogram bin of JAX's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro import quant as jq
from repro.core import basecaller as jbc
from repro.engine.base import quantize_edge_params as jquantize_edge
from repro_torch import quant as tq
from repro_torch.core import basecaller as tbc
from repro_torch.engine.base import quantize_edge_params as tquantize_edge


def _eq(got, want):
    got, want = U.n(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def test_quantize_ties_round_half_to_even():
    """x / s lands exactly on k + 0.5: both round to the even neighbour,
    and the clip holds at +-127."""
    s = np.float32(0.5)
    x = (np.arange(-140, 141, dtype=np.float32) * 0.25).astype(np.float32)
    got = tq.quantize(U.t(x), U.t(s))
    want = jq.quantize(jnp.asarray(x), jnp.asarray(s))
    _eq(got, want)
    assert U.n(tq.quantize(U.t(np.float32([1.25, 1.75, -1.25])), U.t(s))
               ).tolist() == [2, 4, -2]
    assert U.n(tq.quantize(U.t(np.float32([1e9, -1e9])), U.t(s))
               ).tolist() == [127, -127]


@pytest.mark.parametrize("axis", [None, 0, 2, -1])
def test_quantize_tensor_and_dequantize(axis):
    rng = np.random.default_rng(abs(axis or 7))
    w = (rng.standard_normal((5, 6, 9)) * 0.3).astype(np.float32)
    w[:, :, 3] = 0.0                                  # an all-zero channel
    jt = jq.quantize_tensor(jnp.asarray(w), axis=axis, act_scale=0.02)
    tt = tq.quantize_tensor(U.t(w), axis=axis, act_scale=0.02)
    _eq(tt.q, jt.q)
    _eq(tt.scale, jt.scale)
    _eq(tt.act_scale, jt.act_scale)
    assert tt.axis == jt.axis
    _eq(tt.dequantize(), jt.dequantize())
    _eq(tq.absmax(U.t(w), axis), jq.absmax(jnp.asarray(w), axis))


def test_symmetric_scale_and_eps():
    for amax in (0.0, 1e-12, 0.3, 5.7):
        _eq(tq.symmetric_scale(torch.tensor(amax)),
            jq.symmetric_scale(amax))


def test_packed_words_feed_dp4a():
    """Word (k, i, c) of ``packed()`` holds input channels 4i..4i+3 of
    (k, c), lowest byte first."""
    rng = np.random.default_rng(0)
    q = rng.integers(-127, 128, size=(3, 8, 5)).astype(np.int8)
    words = tq.QuantizedTensor(U.t(q), torch.ones(5), 2).packed()
    assert words.dtype == torch.int32 and words.shape == (3, 2, 5)
    back = U.n(words).view(np.int8).reshape(3, 2, 5, 4)
    np.testing.assert_array_equal(back.transpose(0, 1, 3, 2).reshape(3, 8, 5),
                                  q)


def _chunks(n=3, t=300, seed=4):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((2, t)) * 3).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("kind,kw", [("minmax", {}),
                                     ("percentile", {"pct": 99.9}),
                                     ("percentile", {"pct": 50.0,
                                                     "bins": 64})])
def test_observers_bitwise(kind, kw):
    """Range doubling: later chunks are wider than the first."""
    jo, to = jq.make_observer(kind, **kw), tq.make_observer(kind, **kw)
    for i, c in enumerate(_chunks()):
        c = c * (1 + 3 * i)
        jo.update(c)
        to.update(U.t(c))
    assert np.asarray(to.observed_absmax) == np.asarray(jo.observed_absmax)
    assert to.scale().dtype == np.float32
    _eq(to.scale(), jo.scale())


def test_observer_axis_and_errors():
    jo, to = jq.MinMaxObserver(axis=1), tq.MinMaxObserver(axis=1)
    for c in _chunks():
        jo.update(c)
        to.update(c)
    _eq(to.scale(), jo.scale())
    with pytest.raises(ValueError):
        tq.PercentileObserver(pct=0.0)
    with pytest.raises(KeyError):
        tq.make_observer("nope")


@pytest.fixture(scope="module")
def paper_cnn():
    cfg = jbc.BasecallerConfig()
    jp = jbc.init(jax.random.key(0), cfg)
    tp = tbc.load_numpy_params(jax.tree.map(np.asarray, jp), U.CPU)
    return jp, tp


def test_quantize_params_on_paper_cnn(paper_cnn):
    jp, tp = paper_cnn
    scales = {f"conv{i}": np.float32(0.01 * i) for i in range(1, 7)}
    jqp = jq.quantize_params(jp, jq.Calibration(scales))
    tqp = tq.quantize_params(tp, tq.Calibration(scales))
    for name in jp:
        jw, tw = jqp[name]["w"], tqp[name]["w"]
        assert tq.is_quantized(tw) and tw.axis == jw.axis == 2
        _eq(tw.q, jw.q)
        _eq(tw.scale, jw.scale)
        _eq(tw.act_scale, jw.act_scale)
        _eq(tqp[name]["b"], jqp[name]["b"])
    assert tq.params_precision(tqp) == jq.params_precision(jqp) == "int8"
    assert tq.params_precision(tp) == jq.params_precision(jp) == "fp32"
    assert tq.quantized_fraction(tqp) == jq.quantized_fraction(jqp)
    deq = tq.dequantize_params(tqp)
    for name in jp:
        _eq(deq[name]["w"], jq.dequantize_params(jqp)[name]["w"])
    # idempotent, and weight-only without a calibration
    assert tq.quantize_params(tqp)["conv1"]["w"] is tqp["conv1"]["w"]
    assert tq.quantize_params(tp)["conv3"]["w"].act_scale is None


@pytest.mark.parametrize("chunk", [512, 2048])
def test_edge_calibration_within_one_bin_of_jax(paper_cnn, chunk):
    """The port's own build-time calibration (the float forward pass in
    torch, a percentile histogram of 2,048 bins) against JAX's on the same
    float weights.  What was found: conv1-conv4 equal bitwise; conv5 and
    conv6 can sit 1-2 float32 ulps apart, because the histogram's range is
    the first chunk's max, which float sums in another order move by an
    ulp.  That is far inside the bar of one bin (range / 2048, at least
    1/2048 of the scale)."""
    jp, tp = paper_cnn
    cfg_j, cfg_t = jbc.BasecallerConfig(), tbc.BasecallerConfig()
    jqp = jquantize_edge(jp, cfg_j, chunk=chunk, seed=0)
    tqp = tquantize_edge(tp, cfg_t, chunk=chunk, seed=0)
    for name in jp:
        got = U.n(tqp[name]["w"].act_scale)
        want = np.asarray(jqp[name]["w"].act_scale)
        if name in ("conv1", "conv2", "conv3", "conv4"):
            _eq(got, want)
        assert abs(float(got) - float(want)) <= float(want) / 2048, name
        _eq(tqp[name]["w"].q, jqp[name]["w"].q)
        _eq(tqp[name]["w"].scale, jqp[name]["w"].scale)


def test_load_numpy_params_takes_jax_quantized_leaves(paper_cnn):
    jp, _ = paper_cnn
    jqp = jq.quantize_params(jp, jq.Calibration({"conv2": np.float32(0.5)}))
    as_obj = tbc.load_numpy_params(jax.tree.map(np.asarray, jqp), U.CPU)
    as_dict = tbc.load_numpy_params(
        {name: {"w": {"q": np.asarray(layer["w"].q),
                      "scale": np.asarray(layer["w"].scale),
                      "axis": layer["w"].axis,
                      "act_scale": (None if layer["w"].act_scale is None
                                    else np.asarray(layer["w"].act_scale))},
                "b": np.asarray(layer["b"])} for name, layer in jqp.items()},
        U.CPU)
    for tree in (as_obj, as_dict):
        for name in jqp:
            w = tree[name]["w"]
            assert tq.is_quantized(w) and w.axis == 2
            _eq(w.q, jqp[name]["w"].q)
            _eq(w.scale, jqp[name]["w"].scale)
        assert tree["conv1"]["w"].act_scale is None
        _eq(tree["conv2"]["w"].act_scale, jqp["conv2"]["w"].act_scale)
    assert tbc.num_params(as_obj) == 460_261
