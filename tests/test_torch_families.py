"""The MoE, hybrid and VLM families (grok-1-314b, llama4-maverick-400b-a17b,
jamba-v0.1-52b, internvl2-76b) through the port's decoder stack, against
the JAX package, on the CPU.

Their smoke configs in float32: JAX's params (``transformer.init`` at a
key) carried across with ``load_numpy_params``, tokens (and internvl2's
patch embeddings) from numpy seeds, JAX's side under ``jax.jit``.  The
smoke configs run ``moe_impl="dense"``; the MoE archs run once more with
``"dispatch"``, the full configs' choice.

Bars: logits within 1e-4 (rtol and atol), the loss and the MoE aux loss
within 1e-5, gradients within 1e-4 of their leaf's largest entry, 8
``serve_step``s token for token; jamba's step-by-step decode against its
forward within JAX's 2e-2 (``tests/test_models.py``).
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
from repro.models import transformer as jtr
from repro_torch.configs import ARCHS
from repro_torch.launch import steps
from repro_torch.models import transformer as ttr
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import load_numpy_params
from repro_torch.models.registry import get_model

FAMILY_ARCHS = ["grok-1-314b", "llama4-maverick-400b-a17b",
                "jamba-v0.1-52b", "internvl2-76b"]
MOE_ARCHS = FAMILY_ARCHS[:3]
F32_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
EXACT_TOL = 2e-2
SEQ = 64
STEPS = 8


@functools.lru_cache(maxsize=None)
def _setup(arch, impl=None):
    jcfg = dataclasses.replace(JARCHS[arch].smoke_config(), dtype="float32")
    if impl is not None:
        jcfg = dataclasses.replace(jcfg, moe_impl=impl)
    jp, _ = jtr.init(jax.random.key(0), jcfg)
    tp = load_numpy_params(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg)), jp, tp


def _batch(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, jcfg.vocab_size, (2, SEQ)).astype(
        np.int32),
        "labels": rng.integers(0, jcfg.vocab_size, (2, SEQ)).astype(
            np.int32)}
    if jcfg.frontend_tokens:
        out["input_embeds"] = rng.standard_normal(
            (2, jcfg.frontend_tokens, jcfg.d_model)).astype(np.float32)
    return out


def _close(got, want, tol=F32_TOL, what=""):
    np.testing.assert_allclose(U.n(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_configs_and_param_tree_equal_jax(arch):
    for which in ("config", "smoke_config"):
        assert dataclasses.asdict(getattr(ARCHS[arch], which)()) == \
            dataclasses.asdict(getattr(JARCHS[arch], which)())
    jcfg, tcfg, jp, _ = _setup(arch)
    # the block pattern, layer for layer, smoke and published
    for t, j in ((tcfg, jcfg), (ARCHS[arch].config(),
                                JARCHS[arch].config())):
        assert [(s.mixer, s.ff) for s in t.block_pattern] == [
            (s.mixer, s.ff) for s in j.block_pattern]
        assert t.num_blocks == j.num_blocks
    _, jaxes = jtr.init(jax.random.key(0), jcfg)
    shapes, taxes = ttr.abstract_params(tcfg)
    assert taxes == jaxes
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert set(tflat) == set(jflat)
    for k, v in tflat.items():
        assert tuple(v.shape) == tuple(jflat[k].shape), k
        assert str(v.dtype).split(".")[-1] == str(jflat[k].dtype), k


@pytest.mark.parametrize("arch,impl", [(a, None) for a in FAMILY_ARCHS]
                         + [(a, "dispatch") for a in MOE_ARCHS])
def test_apply_and_prefill_equal_jax(arch, impl):
    jcfg, tcfg, jp, tp = _setup(arch, impl)
    batch = _batch(jcfg)
    emb = batch.get("input_embeds")
    jl, jaux = jax.jit(lambda p, t, e: jtr.apply(p, t, jcfg,
                                                 input_embeds=e))(
        jp, batch["tokens"], emb)
    temb = None if emb is None else U.t(emb)
    with torch.no_grad():
        tl, taux = ttr.apply(tp, U.t(batch["tokens"]).long(), tcfg,
                             input_embeds=temb)
        pre = steps.prefill(tp, batch["tokens"], tcfg, input_embeds=temb,
                            device="cpu")
    _close(tl, jl, what="apply")
    _close(pre, np.asarray(jl)[:, -1:], what="prefill")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=LOSS_TOL,
                               atol=1e-7)
    if tcfg.num_experts:
        assert float(taux) > 0


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_gradients_equal_jax(arch):
    jcfg, tcfg, jp, tp = _setup(arch)
    batch = _batch(jcfg, seed=1)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jtr.loss_fn(p, batch, jcfg), has_aux=True))(jp)
    tparams = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    tl, tm = ttr.loss_fn(tparams, {k: U.t(v) for k, v in batch.items()},
                         tcfg)
    tl.backward()
    for got, want in ((tl, jl), (tm["nll"], jm["nll"]),
                      (tm["moe_aux"], jm["moe_aux"])):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=LOSS_TOL, atol=1e-7)
    jflat = dict(jax.tree_util.tree_flatten_with_path(jg)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(tparams)[0]:
        want = np.asarray(jflat[path])
        bar = GRAD_TOL * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(U.n(leaf.grad), want, rtol=0, atol=bar,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_serve_steps_equal_jax(arch):
    """8 ``serve_step``s from tokens 3 and 5, each feeding back its
    argmax: token for token, logits within 1e-4."""
    jcfg, tcfg, jp, tp = _setup(arch)
    jstep = jax.jit(lambda p, c, t, pos: jtr.serve_step(p, c, t, pos, jcfg))
    jcache = jtr.init_cache(jcfg, 2, 16)
    tcache = get_model(tcfg).init_cache(tcfg, 2, 16, device="cpu")
    toks = np.array([[3], [5]], np.int32)
    for i in range(STEPS):
        pos = np.full((2,), i, np.int32)
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks), jnp.asarray(pos))
        with torch.inference_mode():
            tl, tcache = ttr.serve_step(tp, tcache, U.t(toks).long(),
                                        U.t(pos).long(), tcfg)
        want = np.asarray(jl)[:, -1]
        _close(U.n(tl)[:, -1], want, what=f"step {i}")
        np.testing.assert_array_equal(U.n(tl)[:, -1].argmax(-1),
                                      want.argmax(-1))
        toks = want.argmax(-1)[:, None].astype(np.int32)


def test_jamba_decode_matches_forward():
    """JAX's ``test_decode_matches_forward`` on the port: the hybrid's
    teacher-forced forward against step-by-step decode (attention, Mamba
    and MoE layers), f32, within 2e-2."""
    _, tcfg, _, tp = _setup("jamba-v0.1-52b")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        1, tcfg.vocab_size, (1, 8)))
    with torch.inference_mode():
        full, _ = ttr.apply(tp, toks, tcfg)
        cache = ttr.init_cache(tcfg, 1, 8, device="cpu")
        outs = []
        for i in range(8):
            logits, cache = ttr.serve_step(tp, cache, toks[:, i:i + 1],
                                           torch.full((1,), i), tcfg)
            outs.append(logits[:, 0])
    np.testing.assert_allclose(U.n(full), U.n(torch.stack(outs, dim=1)),
                               rtol=EXACT_TOL, atol=EXACT_TOL)


def test_vlm_embeds_change_the_logits():
    """JAX's ``test_vlm_embeds_injected``: shifting the patch embeddings
    moves the logits."""
    jcfg, tcfg, _, tp = _setup("internvl2-76b")
    batch = _batch(jcfg, seed=2)
    tok = U.t(batch["tokens"]).long()
    emb = U.t(batch["input_embeds"])
    with torch.no_grad():
        l1, _ = ttr.apply(tp, tok, tcfg, input_embeds=emb)
        l2, _ = ttr.apply(tp, tok, tcfg, input_embeds=emb + 1.0)
    assert float((l1 - l2).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ["grok-1-314b", "whisper-medium"])
def test_param_count_estimate_within_two_percent(arch):
    """JAX's ``test_param_count_estimates_match`` on the port's meta
    tensors (no allocation) at the published sizes."""
    cfg = ARCHS[arch].config()
    shapes, _ = get_model(cfg).abstract_params(cfg)
    actual = sum(int(t.numel()) for _, t in
                 jax.tree_util.tree_flatten_with_path(shapes)[0])
    assert abs(actual - cfg.param_count_estimate()) / actual < 0.02


def test_large_leaves_draw_in_runs_of_rows(monkeypatch):
    """A leaf past ``param.DRAW_ENTRIES`` is drawn a run of rows at a time
    (no float32 copy of the whole leaf): every row drawn, N(0, scale)
    in the leaf's dtype, a leaf under the limit as one draw."""
    from repro_torch.models import param
    monkeypatch.setattr(param, "DRAW_ENTRIES", 1000)
    gen = torch.Generator().manual_seed(0)
    big = param._normal((2, 3, 600), 0.5, torch.bfloat16, gen, "cpu")
    assert big.dtype == torch.bfloat16 and tuple(big.shape) == (2, 3, 600)
    rows = big.float().reshape(-1, 600)
    assert bool((rows.abs().sum(-1) > 0).all())
    assert abs(float(rows.std()) - 0.5) < 0.02
    assert not torch.equal(rows[0], rows[1])
    small = param._normal((4, 5), 1.0, torch.float32,
                          torch.Generator().manual_seed(1), "cpu")
    want = torch.randn((4, 5), generator=torch.Generator().manual_seed(1))
    assert torch.equal(small, want)
