"""The port's plain attention (``kernels/ref.py::attention`` and
``ops.flash_attention`` on a CPU tensor) against the JAX package's oracle
and its Pallas flash kernel in interpret mode.

Bars are the JAX suite's own (tests/test_kernels.py): 2e-5 in float32,
3e-2 in bf16 (the kernel rounds P to bf16 before the PV product, the
oracle does not).
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
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = {"float32": 2e-5, "bfloat16": 3e-2}

# (b, hq, hkv, sq, skv, d, causal, block): GQA, causal and not, Sq < Skv
# (decode alignment), and lengths that are no multiple of 32
CASES = [
    (2, 4, 2, 64, 64, 32, True, 32),
    (2, 4, 2, 64, 64, 32, False, 32),
    (1, 4, 2, 32, 128, 32, True, 32),
    (1, 4, 1, 100, 100, 16, True, 512),
    (1, 4, 2, 37, 91, 16, False, 512),
]


def _inputs(case, dtype, seed=0):
    b, hq, hkv, sq, skv, d = case[:6]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jd) for a in arrs], [U.t(a, td) for a in arrs])


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(U.n(got.float())),
                               np.asarray(want, dtype=np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_plain_attention_vs_jax_oracle(case, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(case, dtype)
    causal = case[6]
    want = jref.attention(jq, jk, jv, causal=causal).astype(jnp.float32)
    got = tref.attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_ops_flash_attention_vs_pallas_interpret(case, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(case, dtype, seed=1)
    causal, block = case[6], case[7]
    scale = 0.3
    with jfabric.use("pallas_interpret"):
        before = jfabric.counters()
        want = jops.flash_attention(jq, jk, jv, causal=causal, scale=scale,
                                    block_q=block, block_k=block)
        jd = jfabric.counters_delta(before)
    assert jd.get("fabric.dispatch.flash_attention.pallas_interpret") == 1
    before = tfabric.counters()
    got = tops.flash_attention(q, k, v, causal=causal, scale=scale)
    assert tfabric.counters_delta(before) == {
        "fabric.dispatch.flash_attention.reference": 1}
    _close(got, want.astype(jnp.float32), dtype)


def test_default_scale_is_inverse_sqrt_head_dim():
    (_, _, _), (q, k, v) = _inputs(CASES[0], "float32", seed=2)
    torch.testing.assert_close(tref.attention(q, k, v),
                               tref.attention(q, k, v, scale=32 ** -0.5))
