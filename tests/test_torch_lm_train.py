"""The port's LM training step against the JAX package, on the CPU.

JAX's ``make_train_step(model.loss, ...)`` under ``jax.jit`` and the port's
``make_train_step`` (plain versions) from the same params (JAX's own,
carried with ``load_numpy_params``) and JAX's batch fed in as numpy.  JAX
trains on its jnp paths (chunked attention, ``ssd_chunked``), the port on
its kernels' plain versions (the flash function, the SSD recurrence):
the same functions up to float32 rounding.

Bars: float32 loss within 1e-5 (relative), every updated param within
1e-5 of its leaf's largest entry (at lr 1e-4: an entry whose gradient
sits near AdamW's eps moves by up to lr, and the two packages' float32
gradients differ by ~1e-6 of the leaf's largest, which a larger lr
would amplify past the bar).  bf16 (the two packages round bf16 at
other places): the loss within 1e-3 (relative) and every updated param
within one bf16 ulp of its leaf's largest entry, or two learning rates in
a leaf that starts at zero (a near-zero gradient's sign is bf16 noise
there, and AdamW moves every entry by ~lr).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro.configs import ARCHS as JARCHS
from repro.data import tokens as jtokens
from repro.models import transformer as jtr
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.models import config as tconfig
from repro_torch.models import transformer as ttr
from repro_torch.models.param import load_numpy_params
from repro_torch.models.registry import get_model
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer
from repro_torch.utils.tree import leaves

ARCH_LIST = ["qwen3-4b", "mamba2-780m"]
SEQ = 64            # two SSD chunks of the smoke configs' 32; JAX chunks
BATCH = 4           # its attention at 64
F32_TOL = 1e-5
BF16_LOSS_RTOL = 1e-3
OPT = dict(lr=1e-4, warmup_steps=0, total_steps=10)


def _jcfg(arch, dtype, **kw):
    return dataclasses.replace(JARCHS[arch].smoke_config(), dtype=dtype, **kw)


def _tcfg(jcfg):
    return tconfig.ModelConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _params(arch, dtype):
    jp, _ = jtr.init(jax.random.key(0), _jcfg(arch, dtype))
    return jp


def _batch(vocab, seed=0):
    cfg = jtokens.TokenPipelineConfig(vocab_size=vocab, seq_len=SEQ,
                                      global_batch=BATCH, seed=seed)
    return jtokens.host_batch_at_step(cfg, 0)


def _jax_step(jcfg, jp, batch, accum):
    ocfg = jopt.OptimizerConfig(**OPT)
    step = jax.jit(jtrainer.make_train_step(
        jtr.loss_fn, jcfg, ocfg, jtrainer.TrainerConfig(grad_accum=accum)))
    state = {"params": jp, "opt": jopt.init_opt_state(jp, ocfg)}
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree.map(np.asarray, new["params"]), float(metrics["loss"])


def _port_step(tcfg, jp, batch, accum):
    ocfg = topt.OptimizerConfig(**OPT)
    params = load_numpy_params(jax.tree.map(np.asarray, jp), "cpu")
    state = {"params": params, "opt": topt.init_opt_state(params, ocfg)}
    step = ttrainer.make_train_step(
        get_model(tcfg).loss, tcfg, ocfg,
        ttrainer.TrainerConfig(grad_accum=accum))
    new, metrics = step(state, {k: U.t(v) for k, v in batch.items()})
    return new, float(metrics["loss"])


def _leaf_excess(got_tree, want_tree, bar_of):
    """The largest |got - want| over each leaf's bar, bar_of(max |want|)."""
    got = [U.n(x.float()) for x in leaves(got_tree)]
    want = [np.asarray(x, np.float32) for x in jax.tree.leaves(want_tree)]
    assert len(got) == len(want)
    worst = 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        worst = max(worst, float(np.abs(g - w).max())
                    / bar_of(float(np.abs(w).max())))
    return worst


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_train_step_f32_equals_jax(arch, accum):
    jcfg = _jcfg(arch, "float32")
    jp = _params(arch, "float32")
    batch = _batch(jcfg.vocab_size)
    want_p, want_l = _jax_step(jcfg, jp, batch, accum)
    with U.one_thread():
        got, got_l = _port_step(_tcfg(jcfg), jp, batch, accum)
    assert abs(got_l - want_l) <= F32_TOL * abs(want_l), (got_l, want_l)
    assert _leaf_excess(got["params"], want_p,
                        lambda m: F32_TOL * m) <= 1.0


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_train_step_bf16_equals_jax(arch):
    jcfg = _jcfg(arch, "bfloat16")
    jp = _params(arch, "bfloat16")
    batch = _batch(jcfg.vocab_size)
    want_p, want_l = _jax_step(jcfg, jp, batch, 1)
    with U.one_thread():
        got, got_l = _port_step(_tcfg(jcfg), jp, batch, 1)
    assert abs(got_l - want_l) <= BF16_LOSS_RTOL * abs(want_l), (got_l,
                                                                 want_l)
    lr2 = 2 * OPT["lr"]
    for g, w, p0 in zip(leaves(got["params"]), jax.tree.leaves(want_p),
                        jax.tree.leaves(jp)):
        w = np.asarray(w, np.float32)
        zero = not np.asarray(p0, np.float32).any()
        bar = lr2 if zero else U.bf16_ulp(np.abs(w).max())
        assert np.abs(U.n(g.float()) - w).max() <= bar


def test_loss_fn_with_loss_mask_equals_jax():
    """``loss_mask`` averages the NLL over the masked-in positions; the
    total and both metrics as JAX's (an all-zero mask divides by 1)."""
    jcfg = _jcfg("qwen3-4b", "float32")
    jp = _params("qwen3-4b", "float32")
    batch = _batch(jcfg.vocab_size, seed=1)
    rng = np.random.default_rng(2)
    tp = load_numpy_params(jax.tree.map(np.asarray, jp), "cpu")
    jloss = jax.jit(lambda p, b: jtr.loss_fn(p, b, jcfg))
    for mask in (rng.integers(0, 2, (BATCH, SEQ)).astype(np.float32),
                 np.zeros((BATCH, SEQ), np.float32)):
        b = dict(batch, loss_mask=mask)
        want, want_m = jloss(jp, {k: jnp.asarray(v) for k, v in b.items()})
        got, got_m = ttr.loss_fn(tp, {k: U.t(v) for k, v in b.items()},
                                 _tcfg(jcfg))
        np.testing.assert_allclose(float(got), float(want), rtol=F32_TOL)
        np.testing.assert_allclose(float(got_m["nll"]),
                                   float(want_m["nll"]), rtol=F32_TOL)
        assert float(got_m["moe_aux"]) == float(want_m["moe_aux"]) == 0.0
    assert float(ttr.loss_fn(tp, {k: U.t(v) for k, v in dict(
        batch, loss_mask=np.zeros((BATCH, SEQ), np.float32)).items()},
        _tcfg(jcfg))[0]) == 0.0


def _toy_loss_jax(params, batch, _cfg):
    pred = batch["x"] @ params["w"]
    return jnp.mean(jnp.square(pred - batch["y"])), {}


def _toy_loss_port(params, batch, _cfg):
    pred = batch["x"] @ params["w"]
    return torch.mean(torch.square(pred - batch["y"])), {}


def test_grad_accum_matches_full_batch_and_jax():
    """tests/test_train_runtime.py's toy loss: accumulation 1 and 4 agree
    (1e-5), and each equals JAX's step at the same accumulation."""
    ocfg = dict(lr=1e-2, warmup_steps=0, schedule="constant",
                weight_decay=0, clip_norm=0)
    x = np.random.default_rng(0).standard_normal((8, 4)).astype(np.float32)
    y = np.random.default_rng(1).standard_normal((8, 2)).astype(np.float32)
    w0 = np.full((4, 2), 0.1, np.float32)
    outs = {}
    for accum in (1, 4):
        jo = jopt.OptimizerConfig(**ocfg)
        jstep = jtrainer.make_train_step(
            _toy_loss_jax, None, jo, jtrainer.TrainerConfig(grad_accum=accum))
        jstate = {"params": {"w": jnp.asarray(w0)},
                  "opt": jopt.init_opt_state({"w": jnp.asarray(w0)}, jo)}
        jnew, jm = jstep(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
        to = topt.OptimizerConfig(**ocfg)
        tstep = ttrainer.make_train_step(
            _toy_loss_port, None, to, ttrainer.TrainerConfig(grad_accum=accum))
        params = {"w": U.t(w0)}
        tnew, tm = tstep({"params": params,
                          "opt": topt.init_opt_state(params, to)},
                         {"x": U.t(x), "y": U.t(y)})
        np.testing.assert_allclose(U.n(tnew["params"]["w"]),
                                   np.asarray(jnew["params"]["w"]),
                                   rtol=F32_TOL, atol=1e-7)
        assert abs(float(tm["loss"]) - float(jm["loss"])) < 1e-6
        outs[accum] = (U.n(tnew["params"]["w"]), float(tm["loss"]))
    np.testing.assert_allclose(outs[1][0], outs[4][0], rtol=1e-5, atol=1e-6)
    assert abs(outs[1][1] - outs[4][1]) < 1e-5


def test_remat_and_donation_change_no_bit():
    """``cfg.remat`` (each block under torch.utils.checkpoint) and the
    update written into the state's own tensors a few elements at a time
    (``optimizer.SLICE``) give the plain step's bits; the step returns the
    tensors it was given (the state is donated), updated."""
    jcfg = _jcfg("qwen3-4b", "float32")
    jp = _params("qwen3-4b", "float32")
    batch = _batch(jcfg.vocab_size)
    with U.one_thread():
        base, base_l = _port_step(_tcfg(jcfg), jp, batch, 1)
        remat, remat_l = _port_step(
            _tcfg(dataclasses.replace(jcfg, remat=True)), jp, batch, 1)
        ocfg = topt.OptimizerConfig(**OPT)
        params = load_numpy_params(jax.tree.map(np.asarray, jp), "cpu")
        state = {"params": params, "opt": topt.init_opt_state(params, ocfg)}
        ids = [id(t) for t in leaves(state)]
        step = ttrainer.make_train_step(ttr.loss_fn, _tcfg(jcfg), ocfg)
        old = topt.SLICE
        topt.SLICE = 100        # several slices a leaf
        try:
            sliced, sliced_m = step(state, {k: U.t(v)
                                            for k, v in batch.items()})
        finally:
            topt.SLICE = old
    assert [id(t) for t in leaves(sliced)] == ids
    assert int(sliced["opt"]["step"]) == 1
    assert base_l == remat_l == float(sliced_m["loss"])
    for other in (remat, sliced):
        for a, b in zip(leaves(base), leaves(other)):
            assert torch.equal(a, b)


def test_registry_loss_and_what_waits():
    jcfg = _jcfg("qwen3-4b", "float32")
    tcfg = _tcfg(jcfg)
    assert get_model(tcfg).loss is ttr.loss_fn
    params = load_numpy_params(jax.tree.map(np.asarray,
                                            _params("qwen3-4b", "float32")),
                               "cpu")
    tok = torch.zeros((1, 4), dtype=torch.int32)
    # input_embeds (the VLM frontend) replace the first embedding rows
    # (tests/test_torch_families.py holds the VLM's loss against JAX)
    emb = torch.zeros((1, 2, 64))
    loss, _ = ttr.loss_fn(params, {"tokens": tok, "labels": tok,
                                   "input_embeds": emb}, tcfg)
    plain, _ = ttr.loss_fn(params, {"tokens": tok, "labels": tok}, tcfg)
    assert bool(torch.isfinite(loss)) and float(loss) != float(plain)
    # a vocab-sliced (tensor-parallel) unembedding outside a TP context
    # (parallel CE needs the other ranks: tests/test_torch_tp.py)
    sliced = dict(params, embedding={"embed": params["embedding"]["embed"][
        :128]})
    with pytest.raises(ValueError, match="tensor-parallel context"):
        ttr.loss_fn(sliced, {"tokens": tok, "labels": tok}, tcfg)
    # the mesh step: a 1x1 mesh is make_train_step; a larger one runs in
    # the ranks of a process group (tests/test_torch_mesh_train.py)
    from repro_torch.launch.mesh import make_mesh
    ocfg = topt.OptimizerConfig(**OPT)
    one = ttrainer.jit_train_step(ttr.loss_fn, tcfg, ocfg,
                                  mesh=make_mesh((1, 1), ("data", "model")))
    ref = ttrainer.make_train_step(ttr.loss_fn, tcfg, ocfg)
    batch = {k: U.t(v) for k, v in _batch(jcfg.vocab_size).items()}
    got = [step({"params": dict(params),
                 "opt": topt.init_opt_state(params, ocfg)}, batch)[1]["loss"]
           for step, params in ((one, load_numpy_params(jax.tree.map(
               np.asarray, _params("qwen3-4b", "float32")), "cpu")),
               (ref, load_numpy_params(jax.tree.map(
                   np.asarray, _params("qwen3-4b", "float32")), "cpu")))]
    assert float(got[0]) == float(got[1])
    with pytest.raises(RuntimeError, match="launch.run"):
        ttrainer.jit_train_step(ttr.loss_fn, tcfg, ocfg,
                                mesh=make_mesh((2, 1), ("data", "model")))
