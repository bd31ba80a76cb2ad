"""The port's encoder-decoder (``repro_torch.models.encdec``) and its
cross-attention pieces against the JAX package, on the CPU.

The whisper-medium smoke config in float32 (2 encoder and 2 decoder
layers, d_model 64, 4 heads of 16): JAX's params (``encdec.init`` at a
key) carried across with ``load_numpy_params``, frames and tokens from
numpy seeds, JAX's side under ``jax.jit``.

Bars: logits and encoder states within 1e-4 (rtol and atol, the f32 LM
bar), the loss within 1e-5, gradients within 1e-4 of their leaf's largest
entry; ``full_attention`` and cross-attention blocks within 2e-5.
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
from repro.models import attention as jattn
from repro.models import encdec as jed
from repro.models import registry as jreg
from repro_torch.configs import ARCHS
from repro_torch.launch import steps
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as ted
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttr
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import load_numpy_params

F32_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ATTN_TOL = 2e-5
FRAMES, DEC = 64, 16
STEPS = 8


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = dataclasses.replace(JARCHS["whisper-medium"].smoke_config(),
                               dtype="float32")
    jp, _ = jed.init(jax.random.key(0), jcfg)
    tp = load_numpy_params(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg)), jp, tp


def _inputs(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((2, FRAMES, jcfg.d_model)).astype(
        np.float32)
    tokens = rng.integers(1, jcfg.vocab_size, (2, DEC)).astype(np.int32)
    labels = rng.integers(1, jcfg.vocab_size, (2, DEC)).astype(np.int32)
    return frames, tokens, labels


def _close(got, want, tol=F32_TOL, what=""):
    np.testing.assert_allclose(U.n(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def test_config_and_param_tree_equal_jax():
    for which in ("config", "smoke_config"):
        assert dataclasses.asdict(getattr(ARCHS["whisper-medium"], which)()
                                  ) == dataclasses.asdict(
            getattr(JARCHS["whisper-medium"], which)())
    jcfg, tcfg, jp, _ = _setup()
    _, jaxes = jed.init(jax.random.key(0), jcfg)
    tparams, taxes = ted.init(torch.Generator().manual_seed(0), tcfg,
                              device="cpu")
    assert taxes == jaxes
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(tparams)[0]}
    assert set(tflat) == set(jflat)
    for k, v in tflat.items():
        assert tuple(v.shape) == tuple(jflat[k].shape), k
    # the registry's model, its abstract params on the meta device, and
    # JAX's cache axes and default cross-attention length
    model = treg.get_model(tcfg)
    assert model.init is ted.init and model.serve is ted.serve_step
    shapes, axes = model.abstract_params(tcfg)
    assert axes == jaxes and shapes["encoder"]["l0"]["attn"][
        "wq"].device.type == "meta"
    assert model.cache_axes(tcfg) == jreg.get_model(jcfg).cache_axes(jcfg)
    cache = model.init_cache(tcfg, 2, 16, device="cpu")
    jcache = jreg.get_model(jcfg).init_cache(jcfg, 2, 16)
    for k, v in cache.items():
        assert tuple(v.shape) == jcache[k].shape, k
        assert v.dtype == torch.bfloat16 and not v.any(), k


def test_encode_and_decode_train_equal_jax():
    jcfg, tcfg, jp, tp = _setup()
    frames, tokens, _ = _inputs(jcfg)
    jenc = jax.jit(lambda p, f: jed.encode(p, f, jcfg))(jp, frames)
    jlog = jax.jit(lambda p, e, t: jed.decode_train(p, e, t, jcfg))(
        jp, jenc, tokens)
    with torch.no_grad():
        enc = ted.encode(tp, U.t(frames), tcfg)
        log = ted.decode_train(tp, enc, U.t(tokens).long(), tcfg)
        # the prefill entry point of the family: the encoder's states
        pre = steps.prefill(tp, U.t(frames), tcfg, device="cpu")
    _close(enc, jenc, what="encode")
    _close(pre, jenc, what="prefill")
    _close(log, jlog, what="decode_train")


def test_loss_and_gradients_equal_jax():
    jcfg, tcfg, jp, tp = _setup()
    frames, tokens, labels = _inputs(jcfg, seed=1)
    batch = {"frames": frames, "tokens": tokens, "labels": labels}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jed.loss_fn(p, batch, jcfg), has_aux=True))(jp)
    tparams = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    tl, tm = ted.loss_fn(tparams, {k: U.t(v) for k, v in batch.items()},
                         tcfg)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(float(tm["nll"].detach()), float(jm["nll"]),
                               rtol=LOSS_TOL)
    jflat = dict(jax.tree_util.tree_flatten_with_path(jg)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(tparams)[0]:
        want = np.asarray(jflat[path])
        bar = GRAD_TOL * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(U.n(leaf.grad), want, rtol=0, atol=bar,
                                   err_msg=jax.tree_util.keystr(path))


def test_prefill_cross_and_serve_steps_equal_jax():
    """init_cache, prefill_cross and 8 serve_steps (each feeding back its
    argmax): tokens equal, logits within 1e-4; the self-attention K/V
    written in place."""
    jcfg, tcfg, jp, tp = _setup()
    frames, _, _ = _inputs(jcfg, seed=2)
    jenc = jax.jit(lambda p, f: jed.encode(p, f, jcfg))(jp, frames)
    jcache = jed.prefill_cross(jp, jed.init_cache(jcfg, 2, 16, FRAMES),
                               jenc, jcfg)
    jstep = jax.jit(lambda p, c, t, pos: jed.serve_step(p, c, t, pos, jcfg))
    with torch.inference_mode():
        enc = ted.encode(tp, U.t(frames), tcfg)
        tcache = ted.prefill_cross(
            tp, ted.init_cache(tcfg, 2, 16, FRAMES, device="cpu"), enc, tcfg)
    for name in ("xk", "xv"):
        np.testing.assert_allclose(
            U.n(tcache[name].float()),
            np.asarray(jcache[name].astype(jnp.float32)), rtol=2 ** -7,
            atol=1e-6, err_msg=name)
    toks = np.array([[3], [5]], np.int32)
    k_before = tcache["k"]
    for i in range(STEPS):
        pos = np.full((2,), i, np.int32)
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks), jnp.asarray(pos))
        with torch.inference_mode():
            tl, tcache = ted.serve_step(tp, tcache, U.t(toks).long(),
                                        U.t(pos).long(), tcfg)
        want = np.asarray(jl)[:, -1]
        _close(U.n(tl)[:, -1], want, what=f"step {i}")
        np.testing.assert_array_equal(U.n(tl)[:, -1].argmax(-1),
                                      want.argmax(-1))
        toks = want.argmax(-1)[:, None].astype(np.int32)
    assert tcache["k"] is k_before and bool(k_before[:, 0, :, STEPS - 1]
                                            .any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,sq,skv,h,hkv", [
    (False, 1, 40, 4, 4),       # the decode cross-attention
    (False, 12, 40, 4, 2),      # GQA, Sq != Skv
    (True, 12, 40, 4, 2),       # causal, aligned to the last key
    (True, 16, 16, 4, 1)])
def test_full_attention_equals_jax(dtype, causal, sq, skv, h, hkv):
    rng = np.random.default_rng(sq + skv)
    q = rng.standard_normal((2, sq, h, 16)).astype(np.float32)
    k = rng.standard_normal((2, skv, hkv, 16)).astype(np.float32)
    v = rng.standard_normal((2, skv, hkv, 16)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want = jax.jit(functools.partial(jattn.full_attention, causal=causal,
                                     scale=0.25))(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    tdt = getattr(torch, dtype)
    got = tattn.full_attention(*(U.t(a).to(tdt) for a in (q, k, v)),
                               causal=causal, scale=0.25)
    assert got.dtype == tdt
    if dtype == "float32":
        _close(got, want, ATTN_TOL)
    else:
        U.assert_bf16_close(got.float(), np.asarray(want.astype(
            jnp.float32)), 2, "bf16 full_attention")


def test_attention_block_kv_override_equals_jax():
    """Cross-attention through ``attention_block``: q without RoPE, the
    encoder's K/V already split into heads, non-causal at Sq != Skv; and
    ``_project_qkv``'s ``q_only``/``apply_rope`` options."""
    jcfg, tcfg, jp, tp = _setup()
    p = jax.tree.map(lambda a: a[0], jp["decoder"]["l0"]["xattn"])
    tpx = ttr.block_params(tp["decoder"], 0)["l0"]["xattn"]
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, DEC, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(DEC), (2, DEC)).astype(np.int32)

    def jrun(p, x, enc, pos):
        kv = jed._cross_kv(p, enc, jcfg)
        return jattn.attention_block(p, x, jcfg, pos, causal=False,
                                     kv_override=kv)
    want = jax.jit(jrun)(p, x, enc, pos)
    with torch.no_grad():
        kv = ted._cross_kv(tpx, U.t(enc), tcfg)
        got = tattn.attention_block(tpx, U.t(x), tcfg, U.t(pos).long(),
                                    causal=False, kv_override=kv)
        q, k, v = tattn._project_qkv(tpx, U.t(x), tcfg, U.t(pos).long(),
                                     apply_rope=False, q_only=True)
    _close(got, want, ATTN_TOL)
    assert k is None and v is None
    jq, _, _ = jax.jit(lambda p, x, pos: jattn._project_qkv(
        p, x, jcfg, pos, apply_rope=False, q_only=True))(p, x, pos)
    _close(q, jq, ATTN_TOL)


def test_block_stack_with_cross_attention_equals_jax():
    """``transformer._init_block_stack(cross_attention=True)`` (JAX's
    option: a ``norm_x`` and an ``xattn`` a layer) builds JAX's tree:
    names, shapes and axes."""
    from repro.models import param as jparam
    from repro.models import transformer as jtr
    from repro_torch.models import param as tparam
    jcfg, tcfg, _, _ = _setup()
    jb = jparam.ParamBuilder(jax.random.key(0), dtype=jnp.float32)
    jtr._init_block_stack(jb.scope("blocks"), jcfg, 2, cross_attention=True)
    tb = tparam.ParamBuilder(None, dtype=torch.float32, device="meta")
    ttr._init_block_stack(tb.scope("blocks"), tcfg, 2, cross_attention=True)
    assert tb.axes == jb.axes
    shapes = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
              jax.tree_util.tree_flatten_with_path(tb.params)[0]}
    assert shapes == {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                      jax.tree_util.tree_flatten_with_path(jb.params)[0]}
    assert "xattn" in tb.params["blocks"]["l0"]
