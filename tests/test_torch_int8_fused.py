"""The fused flowcell tick with int8 layers: the port's plain version
against JAX's ``fused_stream_step`` (reference target and the Pallas kernel
in interpret mode, both under ``jax.jit``, as the JAX runtime runs it), and
against the port's own unfused int8 chain.  Tokens, lens and counters are
bitwise; the carries are the float inputs, taken before quantization, and
bitwise too."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro.core import basecaller as jbc
from repro.kernels import fused_stream as jfs
from repro_torch import quant as tq
from repro_torch.core import basecaller as tbc
from repro_torch.kernels import fabric as tfabric
from repro_torch.kernels import fused_stream as tfs
from repro_torch.realtime import runtime as trt

# two carried conv layers (one strided) and the GEMM head, narrow; Cin of
# the second layer a multiple of 4 (the packed dp4a path on the card)
NARROW = dict(kernels=(5, 7, 1), channels=(8, 16, 5), strides=(1, 2, 1))


def _qparams():
    jcfg = jbc.BasecallerConfig(**NARROW)
    jp = jbc.init(jax.random.key(1), jcfg)
    rng = np.random.default_rng(9)
    for name in jp:     # nonzero biases, so the epilogue is a real fma
        jp[name]["b"] = jnp.asarray(
            (rng.standard_normal(jp[name]["b"].shape) * 0.2).astype(
                np.float32))
    chunks = [rng.standard_normal((2, 512)).astype(np.float32)
              for _ in range(4)]
    jqp = jbc.quantize(jp, jcfg, chunks=chunks, observer="percentile",
                       pct=99.9)
    tqp = tbc.load_numpy_params(jax.tree.map(np.asarray, jqp), U.CPU)
    return jcfg, tbc.BasecallerConfig(**NARROW), jqp, tqp


def _tick_inputs(cfg, lanes, chunk, seed):
    rng = np.random.default_rng(seed)
    n_frames = chunk // cfg.total_stride
    rows = rng.standard_normal((lanes, chunk)).astype(np.float32)
    pads = np.zeros((lanes, n_frames), np.float32)
    pads[2, n_frames // 2:] = 1.0
    reset = np.zeros((lanes,), np.float32)
    reset[[1, 5]] = 1.0
    conv = [np.abs(rng.standard_normal((lanes, s.carry_rows, s.cin)))
            .astype(np.float32) for s in jbc.stream_layer_specs(cfg)]
    prev = rng.integers(0, 5, size=lanes).astype(np.int32)
    bases = rng.integers(0, 90, size=lanes).astype(np.int32)
    ticks = rng.integers(0, 9, size=lanes).astype(np.int32)
    return rows, pads, reset, conv, prev, bases, ticks


@pytest.mark.parametrize("fabric", ["reference", "pallas_interpret"])
def test_fused_int8_step_matches_jax(fabric):
    jcfg, tcfg, jqp, tqp = _qparams()
    lanes, chunk = 8, 32
    rows, pads, reset, conv, prev, bases, ticks = _tick_inputs(jcfg, lanes,
                                                               chunk, 4)
    jlane = {"conv": [jnp.asarray(c) for c in conv],
             "prev_class": jnp.asarray(prev), "bases": jnp.asarray(bases),
             "ticks": jnp.asarray(ticks)}
    tlane = {"conv": [U.t(c) for c in conv], "prev_class": U.t(prev),
             "bases": U.t(bases), "ticks": U.t(ticks)}
    jstep = jax.jit(lambda lane, r, p, rs: jfs.fused_stream_step(
        jqp, lane, r, p, rs, cfg=jcfg, fabric=fabric))
    for tick in range(3):
        rs = reset if tick == 0 else np.zeros_like(reset)
        jt, jl, jlane = jstep(jlane, jnp.asarray(rows), jnp.asarray(pads),
                              jnp.asarray(rs))
        tt, tl, tlane = tfs.fused_stream_step(
            tqp, tlane, U.t(rows), U.t(pads), U.t(rs), cfg=tcfg)
        np.testing.assert_array_equal(U.n(tt), np.asarray(jt))
        np.testing.assert_array_equal(U.n(tl), np.asarray(jl))
        for key in ("prev_class", "bases", "ticks"):
            np.testing.assert_array_equal(U.n(tlane[key]),
                                          np.asarray(jlane[key]))
        for a, b in zip(tlane["conv"], jlane["conv"]):
            np.testing.assert_array_equal(U.n(a), np.asarray(b))
        assert int(U.n(tl).sum()) > 0
        rows = rows[:, ::-1].copy()


def test_fused_int8_equals_unfused_int8_chain():
    """The fused plain tick, reset folded in, equals the unfused int8 step
    after the runtime's lane reset, bit for bit, and counts like JAX's
    fused reference (its own int8 counter plus the per-layer ones)."""
    _, cfg, _, params = _qparams()
    rows, pads, reset, conv, prev, bases, ticks = _tick_inputs(cfg, 8, 32, 6)

    def lane():
        return {"conv": [U.t(c) for c in conv], "prev_class": U.t(prev),
                "bases": U.t(bases), "ticks": U.t(ticks)}
    base = tfabric.counters()
    ft, fl, flane = trt.build_step_fn(cfg, fused=True)(
        params, lane(), U.t(rows), U.t(pads), U.t(reset))
    d = tfabric.counters_delta(base)
    assert d == {"fabric.dispatch.fused_stream.reference": 1,
                 "fabric.precision.fused_stream.int8": 1,
                 "fabric.precision.conv1d.act_static": 2,
                 "fabric.precision.conv1d.int8": 2,
                 "fabric.precision.matmul.act_static": 1,
                 "fabric.precision.matmul.int8": 1}
    ul = lane()
    idx = torch.as_tensor(np.flatnonzero(reset))
    for leaf in (*ul["conv"], ul["prev_class"], ul["bases"], ul["ticks"]):
        leaf[idx] = 0
    ut, ulen, ulane = trt.build_step_fn(cfg)(params, ul, U.t(rows),
                                             U.t(pads))
    assert torch.equal(ft, ut) and torch.equal(fl, ulen)
    for key in ("prev_class", "bases", "ticks"):
        assert torch.equal(flane[key], ulane[key])
    for a, b in zip(flane["conv"], ulane["conv"]):
        assert torch.equal(a, b)


def test_fused_int8_kernel_refuses_what_it_cannot_take():
    """No quiet fallback: uncalibrated weights (JAX's int8_dynamic_act) and
    scales off the output axis (int8_axis) raise before any launch."""
    _, cfg, _, params = _qparams()
    rows, pads, reset, conv, prev, bases, ticks = _tick_inputs(cfg, 8, 32, 6)
    args = (U.t(rows), U.t(pads), U.t(reset), U.t(prev), U.t(bases),
            U.t(ticks), tuple(U.t(c) for c in conv))
    w = params["conv2"]["w"]
    dyn = dict(params, conv2={"w": tq.QuantizedTensor(w.q, w.scale, w.axis),
                              "b": params["conv2"]["b"]})
    with pytest.raises(ValueError, match="int8_dynamic_act"):
        tfs.fused_stream_cuda(*args, dyn, cfg=cfg)
    off = dict(params, conv2={"w": tq.QuantizedTensor(w.q, w.scale[0], 0,
                                                      w.act_scale),
                              "b": params["conv2"]["b"]})
    with pytest.raises(ValueError, match="int8_axis"):
        tfs.fused_stream_cuda(*args, off, cfg=cfg)


def test_int8_buffer_fits_at_full_width():
    """The int8 kernel keeps each quantized layer's input as int8 in the
    scratch between its fp32 input and output: conv2's (5 + 256) x 64
    bytes right after its output, conv3's input (6 + 128) x 64 floats,
    at the low end.  conv2-conv5 run on the tensor cores, their scratch in
    whole 32-word lines.  The largest layer (conv4: input, output and its
    int8 input) comes to ~118 KB, under 227 KB; an fp32 plan has no int8
    scratch."""
    cfg = tbc.BasecallerConfig()
    plan = tfs.smem_plan(cfg, 256, [True] * 6)
    conv2 = plan.layers[1]
    assert (conv2.out_off, conv2.scratch_off) == (0, (6 + 128) * 64)
    assert [lp.tc for lp in plan.layers] == [False] + [True] * 4 + [False]
    conv4 = (7 + 128) * 96 + (8 + 64) * 192 + -(-(7 + 128) * 96 // 128) * 32
    assert plan.cls_off == conv4
    assert plan.bytes == (conv4 + 64) * 4 <= 227 * 1024
