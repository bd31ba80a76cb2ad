"""The fused fp32 tick's tensor-core design, on the CPU.

* ``fused_stream.smem_plan``: each layer's input and output at the two ends
  of the block's shared memory, an int8 layer's quantized input in the
  gap, 105 KB at the paper CNN's chunk of 256 (two lanes an SM),
  ``ValueError`` past a block's 227 KB.
* ``fused_stream.on_tensor_cores``: the per-layer variant predicate, the
  unfused conv's (``conv1d.tensor_core_shape``) for every conv layer of the
  paper CNN and of the step codec.
* The fused tick with its tensor-core layers emulated as the kernel
  computes them (``ref.split_tf32`` operands, three products, each slice
  of 8 input channels summed over all taps and added in fp32) gives JAX's
  ``_fused_reference`` tokens and counters away from near ties of the plain
  logits (top-2 margin 1e-4), and carries within 1e-4.
"""
import jax
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro.core import basecaller as jbc
from repro.kernels import fused_stream as jfs
from repro_torch.core import basecaller as tbc
from repro_torch.core import ctc as tctc
from repro_torch.kernels import _build
from repro_torch.kernels import conv1d as kc
from repro_torch.kernels import fused_stream as tfs
from repro_torch.kernels import ref

STEP = dict(kernels=(2, 1), channels=(5, 5), strides=(2, 1))


def _regions(plan, cfg, chunk):
    """Each layer's (input, output, scratch) float ranges in the plan: a
    tensor-core layer's input padded to whole 32-frame tiles, the output
    the next layer's input (or the logits), no scratch (fp32 layers)."""
    specs = tbc.stream_layer_specs(cfg)
    sizes, t = [], chunk
    for sp, lp in zip(specs, plan.layers):
        t_out = t // sp.stride
        rows = sp.carry_rows + t
        if lp.tc:
            rows = max(rows, (-(-t_out // 32) * 32 - 1) * sp.stride
                       + sp.ksize)
        sizes.append(rows * sp.cin)
        t = t_out
    outs = sizes[1:] + [t * specs[-1].cout]
    return [((lp.in_off, lp.in_off + n_in), (lp.out_off, lp.out_off + n_out),
             (lp.scratch_off, lp.scratch_off))
            for lp, n_in, n_out in zip(plan.layers, sizes, outs)]


@pytest.mark.parametrize("chunk", [256, 64, 68])
def test_smem_plan_regions_are_disjoint_and_fit(chunk):
    cfg = tbc.BasecallerConfig()
    plan = tfs.smem_plan(cfg, chunk)
    assert plan.bytes == (plan.cls_off + chunk // 4) * 4
    assert plan.bytes <= _build.SMEM_LIMIT
    for lp, (inp, outp, scratch) in zip(plan.layers,
                                        _regions(plan, cfg, chunk)):
        spans = sorted(r for r in (inp, outp, scratch) if r[1] > r[0])
        assert spans[0][0] >= 0 and spans[-1][1] <= plan.cls_off
        for a, b in zip(spans, spans[1:]):
            assert a[1] <= b[0]
        assert lp.scratch_off % 4 == 0 and lp.in_off % 4 == 0
        assert lp.out_off % 4 == 0
    # conv2-conv5 on the tensor cores
    assert [lp.tc for lp in plan.layers] == [False, True, True, True, True,
                                             False]


def test_smem_plan_at_full_width_and_past_it():
    """At chunk 256 two lanes' plans share an SM's 228 KB (less 1 KB a
    block the card keeps); chunk 768 needs more than a block may have."""
    cfg = tbc.BasecallerConfig()
    full = tfs.smem_plan(cfg, 256)
    assert full.bytes == ((7 + 128) * 96 + (8 + 64) * 192 + 64) * 4
    assert 2 * (full.bytes + 1024) <= 228 * 1024
    with pytest.raises(ValueError, match="over 232448"):
        tfs.smem_plan(cfg, 768)
    # int8 layers: conv2-conv5 on the tensor cores too; the scratch holds
    # the quantized input, conv4's (7 + 128) rows x 96 channels in whole
    # 32-word lines, past the room for a second lane
    int8 = tfs.smem_plan(cfg, 256, [True] * 6)
    assert [lp.tc for lp in int8.layers] == [lp.tc for lp in full.layers]
    assert int8.bytes == full.bytes + 4 * -(-(7 + 128) * 96 // 128) * 32
    assert 2 * (int8.bytes + 1024) > 228 * 1024


@pytest.mark.parametrize("quantized", [False, True])
def test_launch_meta_carries_the_plan(quantized):
    """The kernel's per-layer meta array (K, stride, Cin, Cout, activation,
    int8, tensor cores, input, output and scratch offsets) is the plan's,
    and is built once a shape."""
    cfg = tbc.BasecallerConfig()
    q = (quantized,) * 6
    plan, meta = tfs._launch_meta(cfg, 256, q)
    assert tfs._launch_meta(cfg, 256, q)[1] is meta
    assert plan == tfs.smem_plan(cfg, 256, q)
    rows = [list(meta[tfs.META * i: tfs.META * (i + 1)]) for i in range(6)]
    for sp, lp, row in zip(tbc.stream_layer_specs(cfg), plan.layers, rows):
        assert row == [sp.ksize, sp.stride, sp.cin, sp.cout,
                       ref.ACTIVATION_CODES[sp.activation], int(quantized),
                       int(lp.tc), lp.in_off, lp.out_off, lp.scratch_off]


@pytest.mark.parametrize("cfg_kw", [{}, STEP], ids=["paper", "step_codec"])
def test_variant_predicate_is_the_unfused_convs(cfg_kw):
    cfg = tbc.BasecallerConfig(**cfg_kw)
    for sp in tbc.stream_layer_specs(cfg):
        assert tfs.on_tensor_cores(sp) == kc.tensor_core_shape(
            sp.cin, sp.cout, sp.ksize, sp.stride), sp.name


def _tf32x3_conv(x, w, b, stride, activation):
    """The kernel's tensor-core layer in float32: per slice of 8 input
    channels, lo_x hi_w + hi_x lo_w + hi_x hi_w over every tap, the slice
    added to the running sum, then bias and activation."""
    xh, xl = ref.split_tf32(x)
    wh, wl = ref.split_tf32(w)
    acc = None
    for c in range(0, x.shape[-1], 8):
        s = slice(c, c + 8)
        part = ref.conv1d(xl[..., s], wh[:, s], None, stride=stride)
        part = part + ref.conv1d(xh[..., s], wl[:, s], None, stride=stride)
        part = part + ref.conv1d(xh[..., s], wh[:, s], None, stride=stride)
        acc = part if acc is None else acc + part
    return ref.ACTIVATIONS[activation](acc + b)


def _emulated_tick(params, cfg, rows, pads, reset, prev, conv):
    rmask = reset > 0
    x = rows[..., None]
    new_conv = []
    for i, sp in enumerate(tbc.stream_layer_specs(cfg)):
        p = params[sp.name]
        if sp.is_head:
            b, t, c = x.shape
            x = ref.matmul(x.reshape(b * t, c), p["w"][0], p["b"]).reshape(
                b, t, sp.cout)
            new_conv.append(conv[i])
            continue
        carry = torch.where(rmask[:, None, None], 0.0, conv[i])
        buf = torch.cat([carry, x], 1)
        conv_fn = _tf32x3_conv if tfs.on_tensor_cores(sp) else ref.conv1d
        x = conv_fn(buf, p["w"], p["b"], stride=sp.stride,
                    activation=sp.activation)
        new_conv.append(buf[:, buf.shape[1] - sp.carry_rows:])
    tok, lens, new_prev = tctc.greedy_decode_stream(
        x, torch.where(rmask, 0, prev), pads)
    return tok, lens, new_prev, new_conv, x


def test_emulated_tf32x3_tick_matches_jax_fused_reference():
    cfg_j, cfg_t = jbc.BasecallerConfig(), tbc.BasecallerConfig()
    jp = jbc.init(jax.random.key(0), cfg_j)
    tp = tbc.load_numpy_params(jax.tree.map(np.asarray, jp), U.CPU)
    rng = np.random.default_rng(17)
    lanes, chunk = 8, 256
    specs = tbc.stream_layer_specs(cfg_t)
    rows = rng.standard_normal((lanes, chunk)).astype(np.float32)
    pads = np.zeros((lanes, chunk // 4), np.float32)
    pads[2, 40:] = 1.0
    reset = np.zeros((lanes,), np.float32)
    reset[[1, 6]] = 1.0
    conv = [np.abs(rng.standard_normal((lanes, s.carry_rows, s.cin)))
            .astype(np.float32) for s in specs]
    prev = rng.integers(0, 5, lanes).astype(np.int32)
    bases = rng.integers(0, 90, lanes).astype(np.int32)
    ticks = rng.integers(0, 9, lanes).astype(np.int32)
    jt, jl, jlane = jfs._fused_reference(
        *(jax.numpy.asarray(a) for a in (rows, pads, reset, prev, bases,
                                         ticks)),
        tuple(jax.numpy.asarray(c) for c in conv), jp, cfg=cfg_j,
        precisions=("auto",) * len(specs))
    tt, tl, tprev, tconv, logits = _emulated_tick(
        tp, cfg_t, *(U.t(a) for a in (rows, pads, reset, prev)),
        [U.t(c) for c in conv])
    # near ties of the plain logits: the emulated and the plain float32
    # chains sum in other orders and may split them either way
    plain = _plain_logits(tp, cfg_t, U.t(rows), U.t(reset),
                          [U.t(c) for c in conv])
    top = torch.topk(plain, 2).values
    tie = U.n(((top[..., 0] - top[..., 1] < 1e-4)
               & (U.t(pads) <= 0)).any(dim=1))
    rmask = reset > 0
    differ = ((U.n(tt) != np.asarray(jt)).any(axis=1)
              | (U.n(tl) != np.asarray(jl))
              | (U.n(tprev) != np.asarray(jlane["prev_class"])))
    assert not (differ & ~tie).any()
    want_bases = np.where(rmask, 0, bases) + U.n(tl)
    np.testing.assert_array_equal(want_bases, np.asarray(jlane["bases"]))
    np.testing.assert_array_equal(np.where(rmask, 0, ticks) + 1,
                                  np.asarray(jlane["ticks"]))
    for a, b in zip(tconv, jlane["conv"]):
        np.testing.assert_allclose(U.n(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
    # the emulation is not the plain chain: the tensor-core layers moved
    # the logits, within the stack's 1e-4
    assert float((logits - plain).abs().max()) > 0
    torch.testing.assert_close(logits, plain, rtol=1e-4, atol=1e-4)


def _plain_logits(params, cfg, rows, reset, conv):
    """The plain float32 chain's logits (every layer ``ref``)."""
    rmask = reset > 0
    x = rows[..., None]
    for i, sp in enumerate(tbc.stream_layer_specs(cfg)):
        p = params[sp.name]
        if sp.is_head:
            b, t, c = x.shape
            x = ref.matmul(x.reshape(b * t, c), p["w"][0], p["b"]).reshape(
                b, t, sp.cout)
        else:
            carry = torch.where(rmask[:, None, None], 0.0, conv[i])
            x = ref.conv1d(torch.cat([carry, x], 1), p["w"], p["b"],
                           stride=sp.stride, activation=sp.activation)
    return x

