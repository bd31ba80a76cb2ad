"""The port's plain bf16 GEMM (``ops.mat_mul`` on bf16 CPU tensors)
against the JAX package's matmul kernel in interpret mode and its oracle.

Both sum the bf16 products in float32, apply the activation to the
float32 sum and round once to bf16, but in different orders: outputs
agree within 1 bf16 ulp of the output's largest magnitude.  (An element
near zero can differ by more of its own ulps, since the float32 sums'
reordering error is absolute.)
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro.kernels import fabric as jfabric
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import fabric as tfabric
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _ab(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (300, 200, 260),
                                   (8, 128, 128), (64, 256, 128)])
def test_mat_mul_bf16_vs_pallas_interpret(m, k, n, act):
    a, b = _ab(m, k, n, m + k + n)
    with jfabric.use("pallas_interpret"):
        before = jfabric.counters()
        want = jops.mat_mul(jnp.asarray(a, jnp.bfloat16),
                            jnp.asarray(b, jnp.bfloat16), activation=act,
                            block_m=128, block_n=128, block_k=128)
        assert jfabric.counters_delta(before).get(
            "fabric.dispatch.matmul.pallas_interpret") == 1
    assert want.dtype == jnp.bfloat16
    before = tfabric.counters()
    got = tops.mat_mul(U.t(a, torch.bfloat16), U.t(b, torch.bfloat16),
                       activation=act)
    assert tfabric.counters_delta(before) == {
        "fabric.dispatch.matmul.reference": 1}
    assert got.dtype == torch.bfloat16
    U.assert_bf16_close(got.float(), np.asarray(want.astype(jnp.float32)),
                        1, f"{m}x{k}x{n} {act}")


@pytest.mark.parametrize("act", ["none", "silu", "gelu"])
def test_bf16_bias_epilogue_vs_oracle(act):
    a, b = _ab(33, 70, 45, 7)
    bias = np.random.default_rng(8).standard_normal(45).astype(np.float32)
    want = jref.matmul(jnp.asarray(a, jnp.bfloat16),
                       jnp.asarray(b, jnp.bfloat16),
                       jnp.asarray(bias, jnp.bfloat16), activation=act)
    got = tref.matmul(U.t(a, torch.bfloat16), U.t(b, torch.bfloat16),
                      U.t(bias, torch.bfloat16), activation=act)
    U.assert_bf16_close(got.float(), np.asarray(want.astype(jnp.float32)),
                        1, act)


def test_bf16_activation_applies_to_the_f32_sum():
    """silu on the float32 sum, then one rounding: not silu of the bf16
    product."""
    a, b = _ab(64, 96, 64, 3)
    ta, tb = U.t(a, torch.bfloat16), U.t(b, torch.bfloat16)
    got = tref.matmul(ta, tb, activation="silu")
    want = torch.nn.functional.silu(ta.float() @ tb.float()).bfloat16()
    assert torch.equal(got, want)


@pytest.mark.parametrize("k,n,offset,want", [
    (2560, 9728, 0, True),      # the qwen3-4b MLP GEMMs
    (200, 264, 0, True),        # ragged to the tile, 8-aligned
    (2558, 9728, 0, False),     # K % 8: a's rows are not 16-byte aligned
    (64, 260, 0, False),        # N % 8
    (64, 256, 1, False),        # a's base 2 bytes off 16-byte alignment
    (0, 256, 0, False)])        # K = 0: no tensor map; mma.sync writes bias
def test_tma_addressable_picks_the_wgmma_kernel(k, n, offset, want):
    """The wgmma kernel takes every shape TMA can address; the rest go to
    the mma.sync kernel (the wrapper's choice, tested here on CPU
    tensors: it reads only shapes and data pointers)."""
    a = torch.zeros(16 * k + 8, dtype=torch.bfloat16)[offset:offset + 16 * k]
    a = a.view(16, k)
    b = torch.zeros((k, n), dtype=torch.bfloat16)
    assert b.data_ptr() % 16 == 0
    assert tmm.tma_addressable(a, b) is want
