"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``), on the CPU.

Parameters are JAX's own (``init_moe`` at a key), carried across with
``load_numpy_params``; inputs come from numpy seeds.  The JAX side runs
under ``jax.jit``.  Config: ``tests/test_model_components.py``'s
``moe_cfg`` (8 experts, d_model 32, d_ff 64, capacity factor 8).

Bars: float32 outputs within 2e-5, the aux loss within 1e-6, routing
(top-k indices, capacity slots, keep masks) equal; gradients within 1e-4
of their leaf's largest entry; bf16 within 2 bf16 ulps of max |y|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JConfig
from repro.models.param import ParamBuilder
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import load_numpy_params

TOL = 2e-5
AUX_TOL = 1e-6
GRAD_TOL = 1e-4

# (experts_per_token, shared expert, activation, gated)
VARIANTS = {"top2_silu": (2, False, "silu", True),
            "top1_shared_silu": (1, True, "silu", True),
            "top2_gelu": (2, False, "gelu", True),
            "top1_shared_gelu_ungated": (1, True, "gelu", False)}


def moe_cfg(**kw):
    base = dict(name="t", family="moe", num_layers=2, d_model=32,
                num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
                head_dim=8, num_experts=8, experts_per_token=2,
                moe_capacity_factor=8.0, dtype="float32")
    base.update(kw)
    return JConfig(**base)


def _variant(name, **kw):
    k, shared, act, gated = VARIANTS[name]
    return moe_cfg(experts_per_token=k, moe_shared_expert=shared,
                   activation=act, mlp_gated=gated, **kw)


def _setup(jcfg, dtype=jnp.float32, seed=0):
    pb = ParamBuilder(jax.random.key(seed), dtype=dtype)
    jmoe.init_moe(pb.scope("moe"), jcfg)
    jp = pb.params["moe"]
    tp = load_numpy_params(jax.tree.map(np.asarray, jp), "cpu")
    return jp, tp, ModelConfig(**dataclasses.asdict(jcfg))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_routing(jp, x, jcfg):
    """JAX's router and its slot assignment (``moe.py:95-100``), jitted."""
    @jax.jit
    def run(p, x):
        bsz, s, d = x.shape
        gates, idx, aux = jmoe._router(p, x.reshape(bsz * s, d), jcfg)
        e, k = jcfg.num_experts, jcfg.experts_per_token
        cap_row = max(int(s * k * jcfg.moe_capacity_factor / e), 1)
        idx_r = idx.reshape(bsz, s * k)
        onehot = jax.nn.one_hot(idx_r, e, dtype=jnp.int32)
        pos = jnp.cumsum(onehot, axis=1) - onehot
        slot = jnp.take_along_axis(pos, idx_r[..., None], axis=2)[..., 0]
        return idx, slot.reshape(bsz, s, k), (slot < cap_row).reshape(
            bsz, s, k), aux
    return [np.asarray(a) for a in run(jp, x)]


def _check_routing(jp, tp, x, jcfg, tcfg):
    jidx, jslot, jkeep, jaux = _jax_routing(jp, x, jcfg)
    bsz, s, d = x.shape
    with torch.no_grad():
        _, idx, aux = tmoe._router(tp, U.t(x).reshape(bsz * s, d), tcfg)
        slot, keep, _, _ = tmoe.routing(idx, bsz, s, tcfg)
    np.testing.assert_array_equal(U.n(idx), jidx)
    np.testing.assert_array_equal(U.n(slot), jslot)
    np.testing.assert_array_equal(U.n(keep), jkeep)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0,
                               atol=AUX_TOL)
    return jkeep


@pytest.mark.parametrize("impl", ["dense", "dispatch"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_equals_jax(impl, variant):
    jcfg = _variant(variant)
    jp, tp, tcfg = _setup(jcfg)
    x = _x((2, 16, 32))
    fn = jmoe.moe_dense if impl == "dense" else jmoe.moe_dispatch
    jy, jaux = jax.jit(lambda p, x: fn(p, x, jcfg))(jp, x)
    with torch.no_grad():
        y, aux = getattr(tmoe, f"moe_{impl}")(tp, U.t(x), tcfg)
    np.testing.assert_allclose(U.n(y), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0,
                               atol=AUX_TOL)
    keep = _check_routing(jp, tp, x, jcfg, tcfg)
    assert keep.all()          # capacity factor 8: nothing drops


def test_dispatch_drops_equal_jax_and_leak_into_the_next_row():
    """Capacity factor 0.5 on the grok-1 pattern (top-2 gated GELU):
    tokens overflow, and JAX adds each overflow of rows 0..B-2 into the
    next row's slot 0 (ROADMAP.md Queue 3 entry 8).  The port equals JAX
    on the batch, row 0 alone equals row 0 batched, and the last row
    batched differs from itself alone, as in JAX."""
    jcfg = moe_cfg(moe_capacity_factor=0.5, activation="gelu")
    jp, tp, tcfg = _setup(jcfg)
    x = _x((2, 16, 32), seed=3)
    jrun = jax.jit(lambda p, x: jmoe.moe_dispatch(p, x, jcfg))
    jy, jaux = jrun(jp, x)
    with torch.no_grad():
        y, aux = tmoe.moe_dispatch(tp, U.t(x), tcfg)
        y1, _ = tmoe.moe_dispatch(tp, U.t(x[1:]), tcfg)
        y0, _ = tmoe.moe_dispatch(tp, U.t(x[:1]), tcfg)
    np.testing.assert_allclose(U.n(y), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0,
                               atol=AUX_TOL)
    keep = _check_routing(jp, tp, x, jcfg, tcfg)
    assert not keep[0].all() and not keep[1].all()
    np.testing.assert_allclose(U.n(y0[0]), U.n(y[0]), rtol=TOL, atol=TOL)
    jy1, _ = jrun(jp, x[1:])
    np.testing.assert_allclose(U.n(y1), np.asarray(jy1), rtol=TOL, atol=TOL)
    assert float(np.abs(U.n(y1[0]) - U.n(y[1])).max()) > 1e-2


@pytest.mark.parametrize("impl", ["dense", "dispatch"])
def test_zero_router_ties_go_to_the_lower_index(impl):
    """Every probability ties: JAX's top_k takes experts 0 and 1 for
    every token; the aux loss is ~1 (JAX's bar) and equals JAX's."""
    jcfg = moe_cfg()
    jp, tp, tcfg = _setup(jcfg)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _x((2, 64, 32))
    fn = jmoe.moe_dense if impl == "dense" else jmoe.moe_dispatch
    jy, jaux = jax.jit(lambda p, x: fn(p, x, jcfg))(jp, x)
    with torch.no_grad():
        y, aux = getattr(tmoe, f"moe_{impl}")(tp, U.t(x), tcfg)
    assert 0.9 < float(aux) < 1.1
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0,
                               atol=AUX_TOL)
    np.testing.assert_allclose(U.n(y), np.asarray(jy), rtol=TOL, atol=TOL)
    _check_routing(jp, tp, x, jcfg, tcfg)
    _, idx = tmoe.top_k(torch.full((3, 8), 0.125), 2)
    assert idx.tolist() == [[0, 1]] * 3


def test_top_k_equals_jax_on_ties_and_distinct_values():
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.1],
                      [0.2, 0.2, 0.2, 0.2, 0.2],
                      [0.5, 0.1, 0.1, 0.2, 0.1]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(probs, k)
        tv, ti = tmoe.top_k(U.t(probs), k)
        np.testing.assert_array_equal(U.n(ti), np.asarray(ji))
        np.testing.assert_array_equal(U.n(tv), np.asarray(jv))


@pytest.mark.parametrize("factor", [8.0, 0.5])
def test_dispatch_gradients_equal_jax(factor):
    """d/d(params, x) of sum(y * r) + aux through ``moe_dispatch`` (top-2
    with the shared expert), with and without drops."""
    jcfg = moe_cfg(moe_capacity_factor=factor, moe_shared_expert=True)
    jp, tp, tcfg = _setup(jcfg)
    x = _x((2, 16, 32), seed=5)
    r = _x((2, 16, 32), seed=6)

    def jloss(p, x):
        y, aux = jmoe.moe_dispatch(p, x, jcfg)
        return jnp.sum(y * r) + aux
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, x)
    tp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = U.t(x).requires_grad_(True)
    y, aux = tmoe.moe_dispatch(tp, tx, tcfg)
    (torch.sum(y * U.t(r)) + aux).backward()
    grads = {k: (tp[k].grad, jgp[k]) for k in tp}
    grads["x"] = (tx.grad, jgx)
    for name, (got, want) in grads.items():
        want = np.asarray(want)
        bar = GRAD_TOL * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(U.n(got), want, rtol=0, atol=bar,
                                   err_msg=name)


@pytest.mark.parametrize("factor", [8.0, 0.5])
def test_dispatch_bf16_within_two_ulps(factor):
    """bf16 params and input: the scatter's colliding rows add in
    another order than XLA's, so the bar is bf16's, not equality."""
    jcfg = moe_cfg(moe_capacity_factor=factor, dtype="bfloat16")
    jp, tp, tcfg = _setup(jcfg, dtype=jnp.bfloat16)
    x = _x((2, 16, 32), seed=7)
    jx = jnp.asarray(x, jnp.bfloat16)
    jy, _ = jax.jit(lambda p, x: jmoe.moe_dispatch(p, x, jcfg))(jp, jx)
    with torch.no_grad():
        y, _ = tmoe.moe_dispatch(tp, U.t(x).to(torch.bfloat16), tcfg)
    assert y.dtype == torch.bfloat16
    U.assert_bf16_close(y.float(), np.asarray(jy.astype(jnp.float32)), 2,
                        "bf16 moe_dispatch")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_gradient_equals_jax_where_exp_overflows(dtype):
    """The experts' silu (``layers.silu``, JAX's rounding) differentiates
    by ``lax.logistic``'s own rule: where ``exp(-x)`` overflows (x < -88
    in float32, an expert row summing overflowed tokens) the gradient is
    JAX's finite one, not ``0 * inf``; elsewhere within one unit of the
    dtype of ``jax.grad(jax.nn.silu)``."""
    from repro_torch.models import layers as L
    x = np.concatenate([np.linspace(-120, 20, 281),
                        [-88.7, -89.0, -100.0]]).astype(np.float32)
    g = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    _, vjp = jax.vjp(jax.nn.silu, jnp.asarray(x, jdt))
    want = np.asarray(vjp(jnp.asarray(g, jdt))[0], np.float32)
    xt = torch.tensor(x).to(getattr(torch, dtype)).requires_grad_()
    y = L.silu(xt)
    (got,) = torch.autograd.grad(y, xt, torch.tensor(g).to(xt.dtype))
    got = got.float().numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    ulp = 2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -23
    np.testing.assert_allclose(got, want, rtol=2 * ulp, atol=2 * ulp)
