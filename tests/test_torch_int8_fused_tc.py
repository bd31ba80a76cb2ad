"""The fused int8 tick's tensor-core design (``csrc/fused_stream.cu``
``tc_layer_int8``), on the CPU.

* ``fused_stream.on_tensor_cores(sp, quantized=True)``: whole 32-channel
  k-steps and Cout in the MMA's 8 columns (the paper CNN's conv2-conv5; not
  conv1, the head, the step codec or narrow layers), and only int8 layers
  in an int8 launch.
* ``fused_stream.smem_plan`` for int8 launches: the quantized input of a
  tensor-core layer padded to whole 32-frame tiles, in whole 32-word lines,
  every region apart and inside the block's shared memory.
* ``quant.core.pack_fragments``: the ``mma.sync.m16n8k32`` B fragment of
  each lane, by index.
* The tick with conv2-conv5 emulated as the kernel sums them (per 32-channel
  slice and tap, from the packed fragments, exact integer sums, then the
  one-rounding epilogue) equals JAX's jitted fused reference bit for bit.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro.core import basecaller as jbc
from repro.kernels import fused_stream as jfs
from repro_torch.core import basecaller as tbc
from repro_torch.core import ctc as tctc
from repro_torch.kernels import _build
from repro_torch.kernels import fused_stream as tfs
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.quant import core as qcore

STEP = dict(kernels=(2, 1), channels=(5, 5), strides=(2, 1))
NARROW = dict(kernels=(5, 7, 1), channels=(8, 16, 5), strides=(1, 2, 1))


@pytest.mark.parametrize("cfg_kw,want", [
    ({}, [False, True, True, True, True, False]),
    (STEP, [False, False]),
    (NARROW, [False, False, False]),
    (dict(kernels=(3, 5, 1), channels=(32, 40, 5), strides=(1, 1, 1)),
     [False, True, False])], ids=["paper", "step_codec", "narrow", "cin32"])
def test_int8_variant_predicate(cfg_kw, want):
    specs = tbc.stream_layer_specs(tbc.BasecallerConfig(**cfg_kw))
    assert [tfs.on_tensor_cores(sp, quantized=True) for sp in specs] == want
    plan = tfs.smem_plan(tbc.BasecallerConfig(**cfg_kw), 64,
                         [True] * len(specs))
    assert [lp.tc for lp in plan.layers] == want


def test_int8_launch_keeps_fp32_layers_off_the_tensor_cores():
    """A float layer in an int8 launch runs the CUDA cores; the int8 ones
    beside it keep the tensor cores."""
    cfg = tbc.BasecallerConfig()
    q = [True, False, True, True, True, True]
    assert [lp.tc for lp in tfs.smem_plan(cfg, 256, q).layers] == [
        False, False, True, True, True, False]


def _regions(plan, cfg, chunk):
    """Each int8 layer's fp32 input, output and quantized scratch in floats
    (words): the scratch of a tensor-core layer spans its rows padded to
    whole 32-frame tiles, in whole 32-word lines."""
    specs = tbc.stream_layer_specs(cfg)
    out, t = [], chunk
    ins = []
    for sp, lp in zip(specs, plan.layers):
        rows = sp.carry_rows + t
        t_out = t // sp.stride
        padded = max(rows, (-(-t_out // 32) * 32 - 1) * sp.stride + sp.ksize)
        words = (-(-padded * sp.cin // 128) * 32 if lp.tc
                 else -(-rows * sp.cin // 4))
        ins.append(rows * sp.cin)
        out.append(words)
        t = t_out
    outs = ins[1:] + [t * specs[-1].cout]
    return [((lp.in_off, lp.in_off + i), (lp.out_off, lp.out_off + o),
             (lp.scratch_off, lp.scratch_off + w))
            for lp, i, o, w in zip(plan.layers, ins, outs, out)]


@pytest.mark.parametrize("chunk", [256, 64, 200, 260])
def test_int8_smem_plan_regions_are_disjoint_and_fit(chunk):
    cfg = tbc.BasecallerConfig()
    plan = tfs.smem_plan(cfg, chunk, [True] * 6)
    assert plan.bytes == (plan.cls_off + chunk // 4) * 4
    assert plan.bytes <= _build.SMEM_LIMIT
    for lp, regions in zip(plan.layers, _regions(plan, cfg, chunk)):
        spans = sorted(r for r in regions if r[1] > r[0])
        assert spans[0][0] >= 0 and spans[-1][1] <= plan.cls_off
        for a, b in zip(spans, spans[1:]):
            assert a[1] <= b[0]
        # float4 loads of the input, float2 stores of the output
        assert lp.in_off % 4 == 0 and lp.out_off % 2 == 0


def test_pack_fragments_by_index():
    w = torch.from_numpy(np.random.default_rng(3).integers(
        -127, 128, (3, 64, 16)).astype(np.int8))
    frags = qcore.pack_fragments(w)
    assert frags.shape == (3, 2, 2, 32, 2) and frags.dtype == torch.int32
    got = frags.view(torch.int8).reshape(3, 2, 2, 32, 2, 4)
    for k, s, j, g, t, r, byte in itertools.product(
            range(3), range(2), range(2), range(8), range(4), range(2),
            range(4)):
        assert got[k, s, j, 4 * g + t, r, byte] == w[
            k, 32 * s + 16 * r + 4 * t + byte, 8 * j + g]
    qt = qcore.QuantizedTensor(w, torch.ones(16), 2, torch.tensor(0.5))
    assert qt.fragments() is qt.fragments()
    with pytest.raises(ValueError, match="Cin % 32"):
        qcore.pack_fragments(w[:, :48])
    with pytest.raises(ValueError, match="Cout % 8"):
        qcore.pack_fragments(w[..., :12])


def _unpack(frags, cin, cout):
    """The (K, Cin, Cout) weights the fragments hold, by their lanes."""
    k = frags.shape[0]
    b = frags.view(torch.int8).reshape(k, cin // 32, cout // 8, 8, 4, 2, 4)
    # (k, slice, n-tile, g, t, register, byte) -> (k, slice, register, t,
    # byte, n-tile, g)
    return b.permute(0, 1, 5, 4, 6, 2, 3).reshape(k, cin, cout)


def _tc_int8_layer(x, w, bias, stride, activation):
    """The kernel's int8 tensor-core layer: the input quantized with the
    calibrated scale, then per 32-channel slice and tap the products of
    the slice's A rows and the B fragments', summed exactly, then the
    epilogue fma(float(acc), act_scale * w_scale, bias) with one rounding
    and the activation."""
    k, cin, cout = w.q.shape
    q = qcore.quantize(x, w.act_scale).double()
    wk = _unpack(w.fragments(), cin, cout).double()
    t_out = (x.shape[1] - k) // stride + 1
    acc = torch.zeros((x.shape[0], t_out, cout), dtype=torch.float64)
    for sl in range(cin // 32):
        c = slice(32 * sl, 32 * sl + 32)
        for tap in range(k):
            rows = q[:, tap: tap + (t_out - 1) * stride + 1: stride, c]
            acc += rows @ wk[tap, c]
    assert bool((acc.abs() < 2 ** 31).all())
    out = ref.fma_f32(acc.to(torch.int32).float(), w.dequant_scale(), bias)
    return ref.ACTIVATIONS[activation](out)


def _emulated_tick(params, cfg, rows, pads, reset, prev, conv):
    rmask = reset > 0
    x = rows[..., None]
    new_conv = []
    for i, sp in enumerate(tbc.stream_layer_specs(cfg)):
        p = params[sp.name]
        if sp.is_head:
            b, t, c = x.shape
            x = ops.int8_reference(x.reshape(b * t, c),
                                   p["w"].head_matrix(), p["b"],
                                   activation=sp.activation).reshape(
                b, t, sp.cout)
            new_conv.append(conv[i])
            continue
        carry = torch.where(rmask[:, None, None], 0.0, conv[i])
        buf = torch.cat([carry, x], 1)
        layer = (_tc_int8_layer if tfs.on_tensor_cores(sp, quantized=True)
                 else ops.int8_reference)
        x = layer(buf, p["w"], p["b"], stride=sp.stride,
                  activation=sp.activation)
        new_conv.append(buf[:, buf.shape[1] - sp.carry_rows:])
    tok, lens, new_prev = tctc.greedy_decode_stream(
        x, torch.where(rmask, 0, prev), pads)
    return tok, lens, new_prev, new_conv


def test_emulated_int8_tensor_core_tick_equals_jax_bitwise():
    jcfg, tcfg = jbc.BasecallerConfig(), tbc.BasecallerConfig()
    jp = jbc.init(jax.random.key(2), jcfg)
    rng = np.random.default_rng(23)
    for name in jp:     # nonzero biases, so the epilogue is a real fma
        jp[name]["b"] = jnp.asarray(
            (rng.standard_normal(jp[name]["b"].shape) * 0.1).astype(
                np.float32))
    chunks = [rng.standard_normal((2, 512)).astype(np.float32)
              for _ in range(2)]
    jqp = jbc.quantize(jp, jcfg, chunks=chunks, observer="percentile",
                       pct=99.9)
    tqp = tbc.load_numpy_params(jax.tree.map(np.asarray, jqp), U.CPU)
    specs = tbc.stream_layer_specs(tcfg)
    lanes, chunk = 4, 64
    rows = rng.standard_normal((lanes, chunk)).astype(np.float32)
    pads = np.zeros((lanes, chunk // 4), np.float32)
    pads[1, 9:] = 1.0
    reset = np.zeros((lanes,), np.float32)
    reset[2] = 1.0
    conv = [np.abs(rng.standard_normal((lanes, s.carry_rows, s.cin)))
            .astype(np.float32) for s in specs]
    prev = rng.integers(0, 5, lanes).astype(np.int32)
    bases = rng.integers(0, 90, lanes).astype(np.int32)
    ticks = rng.integers(0, 9, lanes).astype(np.int32)
    jlane = {"conv": [jnp.asarray(c) for c in conv],
             "prev_class": jnp.asarray(prev), "bases": jnp.asarray(bases),
             "ticks": jnp.asarray(ticks)}
    jstep = jax.jit(lambda lane, r, p, rs: jfs.fused_stream_step(
        jqp, lane, r, p, rs, cfg=jcfg, fabric="reference"))
    jt, jl, jlane = jstep(jlane, jnp.asarray(rows), jnp.asarray(pads),
                          jnp.asarray(reset))
    tt, tl, tprev, tconv = _emulated_tick(
        tqp, tcfg, *(U.t(a) for a in (rows, pads, reset, prev)),
        [U.t(c) for c in conv])
    np.testing.assert_array_equal(U.n(tt), np.asarray(jt))
    np.testing.assert_array_equal(U.n(tl), np.asarray(jl))
    np.testing.assert_array_equal(U.n(tprev), np.asarray(jlane["prev_class"]))
    rmask = reset > 0
    np.testing.assert_array_equal(np.where(rmask, 0, bases) + U.n(tl),
                                  np.asarray(jlane["bases"]))
    for a, b in zip(tconv, jlane["conv"]):
        np.testing.assert_array_equal(U.n(a), np.asarray(b))
    assert int(U.n(tl).sum()) > 0
