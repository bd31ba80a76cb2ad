"""Training on the port (``repro_torch.train``, ``utils.tree``,
``quant.fake_quant``, the new ``quantize_params`` keywords, ``ctc`` through
the basecaller) against the JAX package on the CPU, on the same seeded
numpy inputs and JAX's own params (``load_numpy_params``).

Bars: schedules and one AdamW update within f32 rounding (rtol 1e-6; bf16
moments within one bf16 ulp); fake-quant bitwise against jitted JAX; one
training step's loss within 1e-5 and its gradients within 1e-4 of their
largest entry (XLA's conv sums in another order than the port's per-tap
products); the trained micro basecaller held to JAX's own bar
(``tests/test_system.py``: last loss under half the first, accuracy >
0.55), never bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro import quant as jq
from repro.core import basecaller as jbc
from repro.core import ctc as jctc
from repro.core import variant_caller as jvc
from repro.data import nanopore as jnano
from repro.train import micro_basecaller as jmicro
from repro.train import optimizer as jopt
from repro.utils import tree as jtree
from repro_torch import quant as tq
from repro_torch.core import basecaller as tbc
from repro_torch.core import ctc as tctc
from repro_torch.core import variant_caller as tvc
from repro_torch.data import nanopore as tnano
from repro_torch.kernels import ref
from repro_torch.train import micro_basecaller as tmicro
from repro_torch.train import optimizer as topt
from repro_torch.utils import tree as ttree



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops throughout: one intra-op thread (``U.one_thread``)."""
    with U.one_thread():
        yield

def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cmp_tree(got, want, **tol):
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    for path, w in flat:
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_allclose(U.n(g.float()),
                                   np.asarray(w, np.float32), err_msg=str(path),
                                   **tol)


# ------------------------------------------------------------ schedules ---
@pytest.mark.parametrize("schedule", ["cosine", "wsd", "linear", "constant"])
def test_schedules_equal_jax(schedule):
    cfg = dict(lr=3e-3, warmup_steps=20, total_steps=220, schedule=schedule,
               wsd_decay_frac=0.2, min_lr_frac=0.1)
    jc, tc = jopt.OptimizerConfig(**cfg), topt.OptimizerConfig(**cfg)
    for step in (0, 1, 7, 20, 21, 100, 175, 200, 219, 220, 500):
        want = float(jopt.schedule_lr(jc, jnp.int32(step)))
        got = float(topt.schedule_lr(tc, torch.tensor(step,
                                                      dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step
    with pytest.raises(ValueError):
        topt.schedule_lr(dataclasses.replace(tc, schedule="nope"), 3)


def _update_inputs(seed):
    rng = np.random.default_rng(seed)
    params = {"conv1": {"w": rng.normal(size=(5, 1, 8)).astype(np.float32),
                        "b": rng.normal(size=(8,)).astype(np.float32)},
              "head": {"w": rng.normal(size=(8, 5)).astype(np.float32)}}
    grads = jax.tree.map(
        lambda p: (rng.normal(size=p.shape) * 3).astype(np.float32), params)
    return params, grads


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_apply_update_equals_jax(state_dtype):
    """Two AdamW steps (the second with nonzero moments): clipping, bias
    correction, decay on rank >= 2 leaves only."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
               clip_norm=1.0, state_dtype=state_dtype)
    jc, tc = jopt.OptimizerConfig(**cfg), topt.OptimizerConfig(**cfg)
    params, grads = _update_inputs(0)
    _, grads2 = _update_inputs(1)
    jp, jst = jax.tree.map(jnp.asarray, params), None
    jst = jopt.init_opt_state(jp, jc)
    tp = tbc.load_numpy_params(params, device="cpu")
    tst = topt.init_opt_state(tp, tc)
    for g in (grads, grads2):
        jp, jst, jm = jopt.apply_update(jp, jax.tree.map(jnp.asarray, g),
                                        jst, jc)
        tp, tst, tm = topt.apply_update(
            tp, tbc.load_numpy_params(g, device="cpu"), tst, tc)
        _cmp_tree(tp, jp, rtol=1e-6, atol=1e-7)
        moment_tol = (dict(rtol=2 ** -7, atol=0) if state_dtype == "bfloat16"
                      else dict(rtol=1e-6, atol=1e-9))
        for k in ("m", "v"):
            _cmp_tree(tst[k], jst[k], **moment_tol)
            assert all(x.dtype == getattr(torch, state_dtype)
                       for x in ttree.leaves(tst[k]))
        assert int(tst["step"]) == int(jst["step"])
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)


def test_tree_utilities_equal_jax():
    params, grads = _update_inputs(2)
    params["conv1"]["n"] = np.arange(6, dtype=np.int32)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tbc.load_numpy_params(params, device="cpu")
    assert ttree.tree_count(tp) == jtree.tree_count(jp)
    assert ttree.tree_bytes(tp) == jtree.tree_bytes(jp)
    assert float(ttree.tree_global_norm(tp)) == pytest.approx(
        float(jtree.tree_global_norm(jp)), rel=1e-6)
    assert float(ttree.tree_global_norm({})) == 0.0
    cast = ttree.tree_cast(tp, torch.bfloat16)
    assert cast["conv1"]["w"].dtype == torch.bfloat16
    assert cast["conv1"]["n"].dtype == torch.int32
    jcast = jtree.tree_cast(jp, jnp.bfloat16)
    np.testing.assert_array_equal(
        U.n(cast["head"]["w"].float()),
        np.asarray(jcast["head"]["w"].astype(jnp.float32)))
    z = ttree.tree_zeros_like(tp, torch.float64)
    assert all(x.dtype == torch.float64 and not x.any()
               for x in ttree.leaves(z))
    _cmp_tree(ttree.tree_add(tp, tp), jtree.tree_add(jp, jp), rtol=0)
    _cmp_tree(ttree.tree_scale(tp, 0.5), jtree.tree_scale(jp, 0.5), rtol=0)


# ------------------------------------------------------------ fake quant ---
@pytest.mark.parametrize("axis", [None, 0, 2, -1])
def test_fake_quant_bitwise_with_identity_gradient(axis):
    """The round trip equals jitted JAX bit for bit (exact .5 ties
    included), and the gradient is the identity (straight through)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 6, 9)) * 0.3).astype(np.float32)
    x[0, 0, :] = np.float32(0.25) * np.arange(9)        # ties at scale 0.5
    want = jax.jit(lambda v: jq.fake_quant(v, axis=axis))(jnp.asarray(x))
    xt = U.t(x).requires_grad_()
    got = tq.fake_quant(xt, axis=axis)
    np.testing.assert_array_equal(U.n(got), np.asarray(want))
    g = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    (got * U.t(g)).sum().backward()
    np.testing.assert_array_equal(U.n(xt.grad), g)
    pinned = jax.jit(lambda v: jq.fake_quant_activation(v, scale=0.01))(
        jnp.asarray(x))
    np.testing.assert_array_equal(
        U.n(tq.fake_quant_activation(U.t(x), scale=torch.tensor(0.01))),
        np.asarray(pinned))


def test_fake_quant_params_equal_jax():
    jp = jbc.init(jax.random.key(0), jmicro.DEMO_CFG)
    tp = tbc.load_numpy_params(_np_tree(jp), device="cpu")
    want = jax.jit(jq.fake_quant_params)(jp)
    got = tq.fake_quant_params(tp)
    for layer in jp:
        for k in ("w", "b"):
            np.testing.assert_array_equal(U.n(got[layer][k]),
                                          np.asarray(want[layer][k]))
    np.testing.assert_array_equal(U.n(got["conv1"]["b"]),
                                  np.asarray(jp["conv1"]["b"]))


@pytest.mark.parametrize("kw", [
    {}, {"per_channel": False}, {"weight_keys": frozenset({"wq"})},
    {"stack_dims": 1},
    {"predicate": lambda names, leaf: names[0] == "attn"}])
def test_quantize_params_keywords_equal_jax(kw):
    rng = np.random.default_rng(5)
    params = {"attn": {"wq": rng.normal(size=(3, 8, 6)).astype(np.float32),
                       "b": rng.normal(size=(6,)).astype(np.float32)},
              "mlp": {"w": rng.normal(size=(3, 6, 4)).astype(np.float32),
                      "norm": rng.normal(size=(4,)).astype(np.float32)}}
    want = jq.quantize_params(jax.tree.map(jnp.asarray, params), **kw)
    got = tq.quantize_params(tbc.load_numpy_params(params, device="cpu"),
                             **kw)
    for scope in params:
        for k in params[scope]:
            w, g = want[scope][k], got[scope][k]
            assert jq.is_quantized(w) == tq.is_quantized(g), (scope, k)
            if jq.is_quantized(w):
                assert g.axis == w.axis
                np.testing.assert_array_equal(U.n(g.q), np.asarray(w.q))
                np.testing.assert_array_equal(U.n(g.scale),
                                              np.asarray(w.scale))
                np.testing.assert_array_equal(U.n(g.dequantize()),
                                              np.asarray(w.dequantize()))
            else:
                np.testing.assert_array_equal(U.n(g), np.asarray(w))
    # idempotent: quantized leaves pass through under any predicate
    again = tq.quantize_params(got, predicate=lambda *_: True)
    assert all(again[s][k] is got[s][k] for s in got for k in got[s]
               if tq.is_quantized(got[s][k]))


def test_select_weight_leaf_equal_jax():
    w = np.zeros((2, 3), np.float32)
    for names, leaf in ((["conv1", "w"], w), (["conv1", "b"], w[0]),
                        (["attn", "wq"], w), (["x", "w"], w[0]),
                        ([], w), (["mlp", "scale"], w)):
        assert tq.select_weight_leaf(names, U.t(leaf)) == \
            jq.params.select_weight_leaf(names, jnp.asarray(leaf)), names
    qt = tq.quantize_tensor(U.t(w + 1), axis=1)
    assert not tq.select_weight_leaf(["conv1", "w"], qt)


# ------------------------------------------------------------ train step ---
OCFG = dict(lr=3e-3, warmup_steps=20, total_steps=220, schedule="cosine",
            weight_decay=0.0)


@pytest.fixture(scope="module")
def jax_step():
    cfg = jmicro.DEMO_CFG
    ocfg = jopt.OptimizerConfig(**OCFG)

    def step(params, state, signal, spad, labels, lpad, qat):
        def loss_fn(p):
            if qat:
                p = jq.fake_quant_params(p)
            logits = jbc.apply(p, signal, cfg)
            lp = spad[:, ::cfg.total_stride][:, :logits.shape[1]]
            return jctc.ctc_loss(logits, lp, labels, lpad).mean()
        loss, g = jax.value_and_grad(loss_fn)(params)
        params, state, _ = jopt.apply_update(params, g, state, ocfg)
        return params, state, loss, g
    return jax.jit(step, static_argnames=("qat",))


@pytest.mark.parametrize("qat", [False, True])
def test_train_step_equals_jax(jax_step, qat):
    """One step from JAX's params on one make_ctc_batch: the loss, every
    gradient, and the updated params (where a gradient's sign is clear:
    AdamW's first step moves each weight by lr x sign(g))."""
    cfg = tmicro.DEMO_CFG
    jp = jbc.init(jax.random.key(0), jmicro.DEMO_CFG)
    batch = jnano.make_ctc_batch(np.random.default_rng(0), batch=8,
                                 seq_len=30, pm=jmicro.DEMO_PORE)
    jst = jopt.init_opt_state(jp, jopt.OptimizerConfig(**OCFG))
    jp2, _, jloss, jg = jax_step(jp, jst, *(jnp.asarray(batch[k]) for k in
                                            tmicro.BATCH_KEYS), qat=qat)
    tp = tbc.load_numpy_params(_np_tree(jp), device="cpu")
    tb = tmicro.batch_to(batch, "cpu")
    loss, grads = tmicro.loss_and_grads(tp, tb, cfg, qat=qat)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    for layer in jp:
        for k in ("w", "b"):
            want = np.asarray(jg[layer][k])
            np.testing.assert_allclose(U.n(grads[layer][k]), want, rtol=0,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=f"{layer}.{k}")
    ocfg = topt.OptimizerConfig(**OCFG)
    tp2, tst, tl = tmicro.train_step(tp, topt.init_opt_state(tp, ocfg), tb,
                                     cfg=cfg, ocfg=ocfg, qat=qat)
    assert int(tst["step"]) == 1 and float(tl) == float(loss)
    lr = float(topt.schedule_lr(ocfg, 1))
    for layer in jp:
        for k in ("w", "b"):
            g = np.abs(np.asarray(jg[layer][k]))
            d = np.abs(U.n(tp2[layer][k]) - np.asarray(jp2[layer][k]))
            clear = g > 1e-3 * g.max()
            assert d[clear].max(initial=0) <= 1e-6, (layer, k)
            assert d.max() <= 2 * lr + 1e-6, (layer, k)


def test_variant_caller_loss_fn_equals_jax():
    """The genotype + masked alt-base loss and its gradient on JAX's
    params."""
    jcfg = jvc.CallerConfig()
    jp = jvc.init(jax.random.key(1), jcfg)
    tp = tbc.load_numpy_params(_np_tree(jp), device="cpu")
    rng = np.random.default_rng(8)
    win = rng.random((6, jcfg.window, 9)).astype(np.float32)
    gt = np.array([0, 1, 2, 0, 2, 1], np.int32)
    alt = rng.integers(0, 4, 6).astype(np.int32)
    jl, jg = jax.value_and_grad(jvc.loss_fn)(jp, jnp.asarray(win),
                                             jnp.asarray(gt),
                                             jnp.asarray(alt), jcfg)
    live = ttree.tree_map(lambda x: x.requires_grad_(), tp)
    tl = tvc.loss_fn(live, U.t(win), U.t(gt), U.t(alt), tvc.CallerConfig())
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    for layer in jp:
        for k in jp[layer]:
            want = np.asarray(jg[layer][k])
            np.testing.assert_allclose(U.n(live[layer][k].grad), want,
                                       rtol=0,
                                       atol=1e-4 * np.abs(want).max() + 1e-9)


def test_weight_concentration_and_stream_state_spec_equal_jax():
    for cfg_kw in ({}, dict(kernels=(5, 5, 3), channels=(48, 64, 5),
                            strides=(1, 2, 2))):
        jcfg, tcfg = jbc.BasecallerConfig(**cfg_kw), tbc.BasecallerConfig(
            **cfg_kw)
        assert tbc.stream_state_spec(tcfg) == jbc.stream_state_spec(jcfg)
        jp = jbc.init(jax.random.key(0), jcfg)
        tp = tbc.load_numpy_params(_np_tree(jp), device="cpu")
        assert tbc.weight_concentration(tp) == jbc.weight_concentration(jp)


# ---------------------------------------------------------------- learns ---
def read_accuracy(cfg, params, rng, n=16, seq_len=30):
    """``tests/test_system.py::read_accuracy`` on the port: n reads of
    seq_len bases simulated on DEMO_PORE, greedy-decoded, scored by edit
    distance."""
    correct = total = 0
    for _ in range(n):
        seq = rng.integers(1, 5, seq_len).astype(np.int32)
        sig, _ = jnano.simulate_read(rng, seq, jmicro.DEMO_PORE)
        sig = jnano.normalize(sig)
        with torch.no_grad():
            logits = tbc.apply(params, U.t(sig[None]), cfg)
        toks, lens = tctc.greedy_decode(logits)
        called = U.n(toks[0][:int(lens[0])])
        padded = np.pad(called, (0, max(seq_len - len(called), 0)))
        d = int(ref.edit_distance(U.t(padded[None, :seq_len]),
                                  U.t(seq[None]))[0])
        correct += seq_len - min(d, seq_len)
        total += seq_len
    return correct / total


@pytest.fixture(scope="module")
def trained():
    """``test_system.py``'s fixture on the port: 220 steps of
    ``train_step`` at seq_len 30, every step's loss kept."""
    cfg = tmicro.DEMO_CFG
    params = tbc.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    ocfg = topt.OptimizerConfig(lr=3e-3, warmup_steps=20, total_steps=220,
                                schedule="cosine", weight_decay=0.0)
    state = topt.init_opt_state(params, ocfg)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(220):
        b = tmicro.batch_to(tnano.make_ctc_batch(
            rng, batch=8, seq_len=30, pm=tmicro.DEMO_PORE), "cpu")
        params, state, loss = tmicro.train_step(params, state, b, cfg=cfg,
                                                ocfg=ocfg)
        losses.append(float(loss))
    return cfg, params, losses


def test_micro_basecaller_learns(trained):
    """JAX's bar (``test_system.py``): 220 steps at seq_len 30 halve the
    loss, and the reads of ``default_rng(77)`` come out > 55% right."""
    cfg, params, losses = trained
    assert len(losses) == 220
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
    acc = read_accuracy(cfg, params, np.random.default_rng(77), n=16)
    assert acc > 0.55, acc


def test_qat_micro_smoke():
    """``test_quant.py::test_qat_micro_smoke``: four QAT steps leave finite
    params, which quantize to int8."""
    cfg, params = tmicro.train_micro_basecaller(steps=4, qat=True, seed=0,
                                                device="cpu")
    assert all(bool(torch.isfinite(x).all()) for x in ttree.leaves(params))
    q = tq.quantize_params(params)
    assert tq.params_precision(q) == "int8"
