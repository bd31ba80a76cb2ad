"""The numerics and the variant choices of the port's redesigned kernels, on
the CPU.

* ``ref.split_tf32`` emulates the 3xTF32 split of ``csrc/mma.cuh``
  (``cvt.rna.tf32.f32``: 10 explicit mantissa bits, ties away from zero).
* The 3xTF32 conv, emulated as three float32 convs of the split operands,
  holds the fp32 bar of 2e-5 against a float64 conv at every conv layer of
  the paper's CNN; one TF32 pass (hi x hi) does not, so the bar has teeth.
* The pure-Python predicates that pick a kernel on the card: the
  tensor-core conv, the skinny-N matmul, the wavefront's stripes.
* The plain ``banded_align`` at m = n = 908 (a length that runs in
  stripes on the card) equals JAX's reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro.kernels import ref as jref
from repro_torch.core import basecaller as bc
from repro_torch.kernels import _build
from repro_torch.kernels import conv1d as kc
from repro_torch.kernels import edit_distance as ked
from repro_torch.kernels import matmul as km
from repro_torch.kernels import ref

F32_TOL = 2e-5      # the JAX suite's f32 bar per op (tests/test_kernels.py)


def _mantissa_tail(v):
    return v.view(torch.int32) & 0x1FFF


def test_split_tf32_keeps_ten_mantissa_bits_and_restores_v():
    rng = np.random.default_rng(0)
    v = U.t(rng.standard_normal(4096).astype(np.float32)
            * np.exp2(rng.integers(-20, 20, 4096)).astype(np.float32))
    hi, lo = ref.split_tf32(v)
    assert hi.dtype == lo.dtype == torch.float32
    assert int(_mantissa_tail(hi).abs().max()) == 0
    assert int(_mantissa_tail(lo).abs().max()) == 0
    exact = v.double()
    err = (exact - (hi.double() + lo.double())).abs()
    assert bool((err <= 2.0 ** -22 * exact.abs()).all())
    # hi alone is a TF32 rounding: within half its last place, 2^-11
    assert bool(((exact - hi.double()).abs() <= 2.0 ** -11 * exact.abs())
                .all())


@pytest.mark.parametrize("v,want", [
    (1 + 2 ** -11, 1 + 2 ** -10),           # a tie: away from zero, not even
    (-(1 + 2 ** -11), -(1 + 2 ** -10)),
    (1 + 3 * 2 ** -11, 1 + 2 ** -9),        # a tie rounding to even anyway
    (1 + 2 ** -11 - 2 ** -23, 1.0),         # below the tie: down
    (1 + 2 ** -11 + 2 ** -23, 1 + 2 ** -10),  # above it: up
    (-(2.0 ** 100) * (1 + 2 ** -11), -(2.0 ** 100) * (1 + 2 ** -10)),
])
def test_split_tf32_rounds_to_nearest_ties_away(v, want):
    hi, lo = ref.split_tf32(torch.tensor([v], dtype=torch.float32))
    assert hi.item() == np.float32(want)
    # lo is v - hi rounded to tf32 in turn
    assert lo.item() == ref.split_tf32(torch.tensor([v - want],
                                                    dtype=torch.float32))[0]


def _layers(lanes=4, chunk=256, seed=3):
    """Each conv layer of the paper's CNN with a numpy-seeded input of its
    streaming width ([carry | chunk] rows) and He-scaled weights."""
    rng = np.random.default_rng(seed)
    t = chunk
    out = []
    for sp in bc.stream_layer_specs(bc.BasecallerConfig()):
        if sp.is_head:
            break
        x = rng.standard_normal((lanes, t + sp.carry_rows, sp.cin))
        if sp.cin > 1:
            x = np.abs(x)                   # a ReLU layer's output
        w = rng.standard_normal((sp.ksize, sp.cin, sp.cout)) * np.sqrt(
            2.0 / (sp.ksize * sp.cin))
        b = rng.standard_normal(sp.cout) * 0.1
        out.append((sp, *(U.t(a.astype(np.float32)) for a in (x, w, b))))
        t //= sp.stride
    return out


def _conv64(x, w, b, stride):
    """The float64 'valid' conv: K shifted products."""
    k = w.shape[0]
    t_out = (x.shape[1] - k) // stride + 1
    acc = b.double().expand(x.shape[0], t_out, w.shape[2]).clone()
    for i in range(k):
        acc += x[:, i: i + (t_out - 1) * stride + 1: stride].double() @ (
            w[i].double())
    return acc


def _tf32_conv(x, w, b, stride, passes):
    """The tensor-core kernel's products in float32: lo_x hi_w + hi_x lo_w
    + hi_x hi_w (passes=3), or hi_x hi_w alone (passes=1)."""
    xh, xl = ref.split_tf32(x)
    wh, wl = ref.split_tf32(w)
    acc = ref.conv1d(xh, wh, b, stride=stride)
    if passes == 3:
        acc = acc + ref.conv1d(xl, wh, None, stride=stride)
        acc = acc + ref.conv1d(xh, wl, None, stride=stride)
    return acc


@pytest.mark.parametrize("layer", range(5))
def test_3xtf32_conv_holds_the_fp32_bar_and_1xtf32_breaks_it(layer):
    sp, x, w, b = _layers()[layer]
    want = _conv64(x, w, b, sp.stride)
    three = _tf32_conv(x, w, b, sp.stride, 3).double()
    one = _tf32_conv(x, w, b, sp.stride, 1).double()
    assert torch.allclose(three, want, rtol=F32_TOL, atol=F32_TOL), sp.name
    assert not torch.allclose(one, want, rtol=F32_TOL, atol=F32_TOL), sp.name


def test_conv1d_variant_choice():
    cfg = bc.BasecallerConfig()
    specs = bc.stream_layer_specs(cfg)
    tc = {sp.name: kc.tensor_core_shape(sp.cin, sp.cout, sp.ksize, sp.stride)
          for sp in specs if not sp.is_head}
    # the tick's conv2-conv5 on the tensor cores, conv1 (Cin 1) not
    assert tc == {"conv1": False, "conv2": True, "conv3": True,
                  "conv4": True, "conv5": True}
    # the step codec (Cin 1 -> 5, then 5 -> 5) and the calibration's head
    # as a k = 1 conv (128 -> 5) stay on the CUDA cores
    step = bc.BasecallerConfig(kernels=(2, 1), channels=(5, 5),
                               strides=(2, 1))
    assert not any(kc.tensor_core_shape(sp.cin, sp.cout, sp.ksize, sp.stride)
                   for sp in bc.stream_layer_specs(step))
    assert not kc.tensor_core_shape(128, 5, 1, 1)
    # the variant caller: 9 -> 48 on the CUDA cores, 48 -> 96 on the tensor
    # cores; a Cin of 512 (once too large for shared memory) on either
    assert not kc.tensor_core_shape(9, 48, 5, 1)
    assert kc.tensor_core_shape(48, 96, 5, 1)
    assert kc.tensor_core_shape(512, 64, 9, 2)
    assert not kc.tensor_core_shape(512, 5, 9, 2)
    # a ring too large for a block: a long kernel stays on the CUDA cores
    assert not kc.tensor_core_shape(64, 64, 31, 1)
    # conv4's ring: 2 stages x (2 x 2 phases x 68 rows x 12 + 2 x 72 x 72);
    # conv3's (Cout 96, 96 channels a block): 2 x (70 x 12 x 2 + 2 x 56 x 104)
    assert kc.tc_smem_bytes(9, 2, 192) == 109_056 <= _build.SMEM_LIMIT
    assert kc.tc_smem_bytes(7, 1, 96) == 106_624 <= _build.SMEM_LIMIT


@pytest.mark.parametrize("n,want", [(1, True), (5, True), (8, True),
                                    (9, False), (64, False)])
def test_matmul_variant_choice(n, want):
    assert km.skinny(n) is want


@pytest.mark.parametrize("m,want", [(48, False), (256, False), (907, True),
                                    (908, True), (2048, True)])
def test_banded_align_variant_choice(m, want):
    """Queries past 32 lanes x 8 rows run in stripes; at n = m every
    stripe hands its last row on through shared memory."""
    lay = ked.plan(m, m)
    assert (lay.stripes > 1) is want
    assert lay.handoff == ("shared" if want else "none")


@pytest.mark.parametrize("local", [False, True])
def test_plain_banded_align_at_908_matches_jax(local):
    rng = np.random.default_rng(908 + local)
    q = rng.integers(1, 5, (2, 908)).astype(np.int32)
    t = np.where(rng.random(q.shape) < 0.1, rng.integers(1, 5, q.shape),
                 q).astype(np.int32)
    kw = dict(band=16, match=2, mismatch=-4, gap=-2, local=local)
    got = U.n(ref.banded_align(U.t(q), U.t(t), **kw))
    want = np.asarray(jref.banded_align(jnp.asarray(q), jnp.asarray(t), **kw))
    np.testing.assert_array_equal(got, want)
    # and the wrapper takes the plain version for CPU tensors at this length
    np.testing.assert_array_equal(
        U.n(ked.banded_align(U.t(q), U.t(t), **kw)), want)
