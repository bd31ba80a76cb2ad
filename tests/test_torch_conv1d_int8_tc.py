"""The int8 conv1d's tensor-core kernel (``csrc/conv1d.cu``
``conv1d_int8_tc_kernel``), on the CPU.

* ``conv1d.int8_tensor_core_shape``: whole 32-channel k-steps, Cout in the
  MMA's 8 columns and a ring that fits a block (the paper CNN's
  conv2-conv5); not conv1, the head, the step codec, Cin 6 or 8, Cout 5 or
  70.
* ``conv1d.int8_tc_smem_bytes`` at the tick's and the basecall's layers,
  by hand, inside a block's shared memory.
* The kernel's implicit GEMM emulated on ``pack_fragments`` operands: each
  k-step one tap of one 32-channel slice, in (slice, tap) order, its A the
  staged rows f * s + k, its B read back from the lanes' registers by the
  ``mma.sync.m16n8k32`` fragment map, summed exactly.  It equals JAX's
  jitted int8 ``conv1d`` (the Pallas kernel, ``interpret=True``) and the
  plain version bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro.kernels import conv1d as jconv
from repro.kernels import ref as jref
from repro_torch.core import basecaller as bc
from repro_torch.kernels import _build
from repro_torch.kernels import conv1d as kc
from repro_torch.kernels import ref
from repro_torch.quant.core import pack_fragments


def implicit_gemm(xq, frags, stride):
    """int32 (B, T_out, Cout) from int8 x and the B fragments (K, Cin/32,
    Cout/8, 32, 2), k-step by k-step as the kernel sums them."""
    bsz, t, cin = xq.shape
    ksize, slices, n8 = frags.shape[:3]
    t_out = (t - ksize) // stride + 1
    # lane 4 g + t4, register r, byte b holds k-row 16 r + 4 t4 + b of the
    # k-step and column 8 j + g
    regs = frags.contiguous().view(torch.int8).reshape(
        ksize, slices, n8, 8, 4, 2, 4)                # k, sl, j, g, t4, r, b
    bmat = regs.permute(0, 1, 5, 4, 6, 2, 3).reshape(
        ksize, slices, 32, n8 * 8).long()              # k, sl, k-row, column
    rows = torch.arange(t_out) * stride
    acc = torch.zeros((bsz, t_out, n8 * 8), dtype=torch.int64)
    for sl in range(slices):
        for k in range(ksize):
            a = xq[:, rows + k, 32 * sl: 32 * sl + 32].long()
            acc += a @ bmat[k, sl]
    return acc.int()


SPECS = {sp.name: sp for sp in bc.stream_layer_specs(bc.BasecallerConfig())}


@pytest.mark.parametrize("name,want", [
    ("conv1", False), ("conv2", True), ("conv3", True), ("conv4", True),
    ("conv5", True), ("conv6", False)])
def test_predicate_at_the_paper_cnn(name, want):
    sp = SPECS[name]
    assert kc.int8_tensor_core_shape(sp.cin, sp.cout, sp.ksize,
                                     sp.stride) is want


@pytest.mark.parametrize("cin,cout,k,s", [
    (6, 64, 9, 2), (8, 64, 5, 1), (64, 5, 5, 1), (64, 70, 5, 1),
    (1, 5, 2, 2), (5, 5, 1, 1), (48, 64, 5, 1)])
def test_predicate_keeps_narrow_shapes_on_dp4a(cin, cout, k, s):
    assert not kc.int8_tensor_core_shape(cin, cout, k, s)


@pytest.mark.parametrize("name,want", [
    ("conv2", 54_400), ("conv3", 56_448), ("conv4", 62_976),
    ("conv5", 50_688)])
def test_smem_plan_fits(name, want):
    """2 stages x (2 sub-tiles x s phases x (63 + ceil(K / s)) rows x 48
    bytes + K x BN x 32 bytes of fragments); the basecall's layers are the
    tick's (padding changes T, not the plan)."""
    sp = SPECS[name]
    got = kc.int8_tc_smem_bytes(sp.ksize, sp.stride, sp.cout)
    assert got == want <= _build.SMEM_LIMIT
    # Cin does not enter: the limit case's 2,048 channels fit as conv4
    assert kc.int8_tensor_core_shape(2048, 64, 9, 2)


@pytest.mark.parametrize("cin,cout,k,s,t", [
    (64, 64, 7, 2, 40),      # conv2
    (64, 96, 7, 1, 37),      # conv3
    (96, 192, 9, 2, 41),     # conv4
    (192, 128, 9, 1, 30),    # conv5
    (32, 8, 1, 1, 9),        # one slice, one tap, one n-tile
    (64, 40, 5, 3, 50)])     # stride 3, Cout not a multiple of 32
def test_implicit_gemm_equals_jax_bitwise(cin, cout, k, s, t):
    rng = np.random.default_rng(cin * cout + k)
    xq = rng.integers(-127, 128, (3, t, cin)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, cin, cout)).astype(np.int8)
    got = implicit_gemm(U.t(xq), pack_fragments(U.t(wq)), s)
    want = np.asarray(jconv.conv1d(jnp.asarray(xq), jnp.asarray(wq),
                                   stride=s, block_n=cout, interpret=True))
    assert want.dtype == np.int32
    np.testing.assert_array_equal(U.n(got), want)
    np.testing.assert_array_equal(
        U.n(got), np.asarray(jref.conv1d(jnp.asarray(xq), jnp.asarray(wq),
                                         stride=s)))
    np.testing.assert_array_equal(
        U.n(got), U.n(ref.conv1d_int8(U.t(xq), U.t(wq), stride=s)))


def test_wrapper_on_cpu_runs_the_plain_conv():
    rng = np.random.default_rng(3)
    xq = U.t(rng.integers(-127, 128, (2, 20, 64)).astype(np.int8))
    wq = U.t(rng.integers(-127, 128, (5, 64, 64)).astype(np.int8))
    before = (kc.conv1d_int8.launches, kc.conv1d_int8.tc_launches)
    got = kc.conv1d_int8(xq, wq, stride=1,
                         w_fragments=pack_fragments(wq))
    assert (kc.conv1d_int8.launches, kc.conv1d_int8.tc_launches) == before
    assert torch.equal(got, ref.conv1d_int8(xq, wq, stride=1))
