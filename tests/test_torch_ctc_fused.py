"""CTC decoding and the fused flowcell tick: the port's plain versions
against the JAX package (reference and Pallas interpret targets).

Integer outputs (tokens, lens, classes, counters) are bitwise; the new conv
carries are layer activations, held at 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro.core import basecaller as jbc
from repro.core import ctc as jctc
from repro.kernels import fused_stream as jfs
from repro_torch.core import basecaller as tbc
from repro_torch.core import ctc as tctc
from repro_torch.kernels import _build
from repro_torch.kernels import fused_stream as tfs
from repro_torch.realtime import runtime as trt


def _classes(seed, b=4, t=23):
    rng = np.random.default_rng(seed)
    # runs of repeats and blanks so the collapse has work to do
    return np.repeat(rng.integers(0, 5, size=(b, t)), 2, axis=1).astype(
        np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_collapse_bitwise(seed):
    best = _classes(seed)
    prev = np.concatenate([np.full((4, 1), 3, np.int32), best[:, :-1]], 1)
    jt, jl = jctc.collapse(jnp.asarray(best), jnp.asarray(prev))
    tt, tl = tctc.collapse(U.t(best), U.t(prev))
    assert tt.dtype == torch.int32 and tl.dtype == torch.int32
    np.testing.assert_array_equal(U.n(tt), np.asarray(jt))
    np.testing.assert_array_equal(U.n(tl), np.asarray(jl))


@pytest.mark.parametrize("seed", [2, 3])
def test_greedy_decode_stream_bitwise(seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((3, 3 * 16, 5)).astype(np.float32)
    pads = np.zeros((3, 16), np.float32)
    pads[1, 9:] = 1.0
    jprev = jnp.zeros((3,), jnp.int32)
    tprev = torch.zeros((3,), dtype=torch.int32)
    for lo in range(0, 48, 16):
        x = logits[:, lo:lo + 16]
        jt, jl, jprev = jctc.greedy_decode_stream(jnp.asarray(x), jprev,
                                                  jnp.asarray(pads))
        tt, tl, tprev = tctc.greedy_decode_stream(U.t(x), tprev, U.t(pads))
        np.testing.assert_array_equal(U.n(tt), np.asarray(jt))
        np.testing.assert_array_equal(U.n(tl), np.asarray(jl))
        np.testing.assert_array_equal(U.n(tprev), np.asarray(jprev))
    jt, jl = jctc.greedy_decode(jnp.asarray(logits))
    tt, tl = tctc.greedy_decode(U.t(logits))
    np.testing.assert_array_equal(U.n(tt), np.asarray(jt))
    np.testing.assert_array_equal(U.n(tl), np.asarray(jl))


def test_all_zero_logits_decode_to_blank():
    """The step decoder's gap frames ReLU to an all-zero tie, which must
    resolve to BLANK: torch.argmax returns the first maximum."""
    logits = torch.zeros((2, 7, 5))
    logits[1, 3] = torch.tensor([0.0, 0.0, 1.0, 1.0, 0.0])   # tie 2 vs 3
    assert tctc.argmax_classes(logits)[0].tolist() == [0] * 7
    assert int(tctc.argmax_classes(logits)[1, 3]) == 2
    tokens, lens, prev = tctc.greedy_decode_stream(
        logits, torch.zeros((2,), dtype=torch.int32))
    assert lens.tolist() == [0, 1] and int(prev[0]) == tctc.BLANK


def _tick_inputs(cfg, lanes, chunk, seed):
    rng = np.random.default_rng(seed)
    n_frames = chunk // cfg.total_stride
    rows = rng.standard_normal((lanes, chunk)).astype(np.float32)
    pads = np.zeros((lanes, n_frames), np.float32)
    pads[2, n_frames // 2:] = 1.0                # a read ending mid-chunk
    reset = np.zeros((lanes,), np.float32)
    reset[[1, 5]] = 1.0                          # lanes recycled this tick
    conv = [np.abs(rng.standard_normal((lanes, s.carry_rows, s.cin)))
            .astype(np.float32) for s in jbc.stream_layer_specs(cfg)]
    prev = rng.integers(0, 5, size=lanes).astype(np.int32)
    bases = rng.integers(0, 90, size=lanes).astype(np.int32)
    ticks = rng.integers(0, 9, size=lanes).astype(np.int32)
    return rows, pads, reset, conv, prev, bases, ticks


# two carried conv layers (one strided) and the GEMM head, narrow
NARROW = dict(kernels=(5, 7, 1), channels=(8, 16, 5), strides=(1, 2, 1))


@pytest.mark.parametrize("fabric", ["reference", "pallas_interpret"])
def test_fused_step_matches_jax(fabric):
    """The plain fused tick against JAX ``fused_stream_step`` with two lanes
    reset mid-run and a read ending mid-chunk, over two ticks."""
    jcfg = jbc.BasecallerConfig(**NARROW)
    tcfg = tbc.BasecallerConfig(**NARROW)
    jp = jbc.init(jax.random.key(1), jcfg)
    tp = tbc.load_numpy_params(jax.tree.map(np.asarray, jp), U.CPU)
    lanes, chunk = 8, 32
    rows, pads, reset, conv, prev, bases, ticks = _tick_inputs(jcfg, lanes,
                                                               chunk, 4)
    jlane = {"conv": [jnp.asarray(c) for c in conv],
             "prev_class": jnp.asarray(prev), "bases": jnp.asarray(bases),
             "ticks": jnp.asarray(ticks)}
    tlane = {"conv": [U.t(c) for c in conv], "prev_class": U.t(prev),
             "bases": U.t(bases), "ticks": U.t(ticks)}
    for tick in range(2):
        rs = reset if tick == 0 else np.zeros_like(reset)
        jt, jl, jlane = jfs.fused_stream_step(
            jp, jlane, jnp.asarray(rows), jnp.asarray(pads), jnp.asarray(rs),
            cfg=jcfg, fabric=fabric)
        tt, tl, tlane = tfs.fused_stream_step(
            tp, tlane, U.t(rows), U.t(pads), U.t(rs), cfg=tcfg)
        np.testing.assert_array_equal(U.n(tt), np.asarray(jt))
        np.testing.assert_array_equal(U.n(tl), np.asarray(jl))
        for key in ("prev_class", "bases", "ticks"):
            assert tlane[key].dtype == torch.int32
            np.testing.assert_array_equal(U.n(tlane[key]),
                                          np.asarray(jlane[key]))
        for a, b in zip(tlane["conv"], jlane["conv"]):
            np.testing.assert_allclose(U.n(a), np.asarray(b), rtol=1e-5,
                                       atol=1e-5)
        rows = rows[:, ::-1].copy()


def test_fused_equals_unfused_step_with_reset():
    """The fused plain step with the reset folded in equals the unfused
    step after the runtime's in-place lane reset (port only)."""
    cfg = tbc.BasecallerConfig(**NARROW)
    params = tbc.init(torch.Generator().manual_seed(3), cfg, device=U.CPU)
    rows, pads, reset, conv, prev, bases, ticks = _tick_inputs(cfg, 8, 32, 6)

    def lane():
        return {"conv": [U.t(c) for c in conv], "prev_class": U.t(prev),
                "bases": U.t(bases), "ticks": U.t(ticks)}
    ft, fl, flane = trt.build_step_fn(cfg, fused=True)(
        params, lane(), U.t(rows), U.t(pads), U.t(reset))
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


def test_fused_smem_plan_fits_at_full_width():
    """The CUDA kernel's shared memory at chunk 256: each layer's input and
    output at the two ends.  conv4 is the largest: its input (7 + 128) x
    96 and conv5's input (8 + 64) x 192, 105 KB with the class buffer, so
    two lanes share an SM; chunk 1024 does not fit."""
    cfg = tbc.BasecallerConfig()
    plan = tfs.smem_plan(cfg, 256)
    conv4 = (7 + 128) * 96 + (8 + 64) * 192
    assert plan.cls_off == conv4
    assert plan.bytes == (conv4 + 64) * 4 <= _build.SMEM_LIMIT
    assert plan.layers[3].in_off == conv4 - (7 + 128) * 96
    assert plan.layers[3].scratch_off == (8 + 64) * 192
    assert 2 * plan.bytes <= 228 * 1024 - 2 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        tfs.smem_plan(cfg, 1024)
