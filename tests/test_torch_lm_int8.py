"""int8 LM weights (``quantize_params(stack_dims=1)``) on one device,
against the JAX package under ``jax.jit`` (XLA contracts the int8
epilogue into one fma only under jit; the port computes that form), on
the f32 smoke configs of qwen3-4b (gated ``silu`` MLP) and starcoder2-3b
(ungated ``gelu``, ``mlp_gated=False``), so both of ``mlp``'s int8
branches are held.

Bitwise where the step is integer arithmetic and one rounding: every int8
projection (``layers.dense``, and ``row_dense`` outside a tensor-parallel
context), and the gated MLP on these inputs.  Elsewhere within JAX's
float32 bar, ``allclose(1e-5, 1e-5)``, and token for token over 8
``serve_step``s: the float parts of a step (RoPE's ``cos``/``sin``, the
softmax's ``exp``, the norms' ``rsqrt``, ``gelu``'s ``tanh``, the
float32 unembedding) round differently in XLA's and PyTorch's CPU
kernels, and an ulp in the absmax an activation is quantized by moves
every output of the next projection (starcoder2's MLP).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro import quant as jquant
from repro.configs import ARCHS as JARCHS
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import load_numpy_params
from repro_torch.quant import params as tqparams
from repro_torch.quant.core import is_quantized

F32 = 1e-5
ARCHS = ["qwen3-4b", "starcoder2-3b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with U.one_thread():
        yield


def _setup(arch):
    jcfg = dataclasses.replace(JARCHS[arch].smoke_config(), dtype="float32")
    params, _ = jtr.init(jax.random.key(0), jcfg)
    jq = jquant.quantize_params(params, stack_dims=1)
    tq = load_numpy_params(jax.tree.map(np.asarray, jq), "cpu")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg)), jq, tq


def _x(d, seed=0, s=3):
    return np.random.default_rng(seed).standard_normal((2, s, d)).astype(
        np.float32)


def test_quantize_params_stack_dims_equals_jax():
    """The port's ``quantize_params(stack_dims=1)`` of JAX's float params
    gives JAX's payloads and ``(blocks, C)`` scales, and a block peeled
    off the stack (``block_params``) the plain ``(C,)`` convention."""
    jcfg = dataclasses.replace(JARCHS["qwen3-4b"].smoke_config(),
                               dtype="float32")
    params, _ = jtr.init(jax.random.key(0), jcfg)
    jq = jax.device_get(jquant.quantize_params(params, stack_dims=1))
    tq = tqparams.quantize_params(
        load_numpy_params(jax.tree.map(np.asarray, params), "cpu"),
        stack_dims=1)
    for name in ("wq", "wk", "wv", "wo"):
        got, want = tq["blocks"]["l0"]["attn"][name], jq["blocks"]["l0"][
            "attn"][name]
        np.testing.assert_array_equal(U.n(got.q), want.q)
        np.testing.assert_array_equal(U.n(got.scale), want.scale)
        assert got.axis == want.axis == -1
        blk = ttr.block_params({"w": got}, 1)["w"]
        assert is_quantized(blk) and tuple(blk.scale.shape) == (
            want.q.shape[-1],)
        np.testing.assert_array_equal(U.n(blk.q), want.q[1])
        np.testing.assert_array_equal(U.n(blk.scale), want.scale[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_projections_equal_jax_bitwise(arch):
    """Every int8 weight of block 0 through ``dense`` (and ``row_dense``
    outside a TP context, which is ``dense``), bit for bit."""
    jcfg, tcfg, jq, tq = _setup(arch)
    jdense = jax.jit(jlayers.dense)
    for scope in ("attn", "mlp"):
        for name, w in jq["blocks"]["l0"][scope].items():
            if not hasattr(w, "q"):
                continue
            jw = jax.tree.map(lambda a: a[0], w)
            tw = tq["blocks"]["l0"][scope][name][0]
            x = _x(jw.q.shape[0], seed=len(name))
            want = np.asarray(jdense(x, jw))
            got = tlayers.dense(U.t(x), tw)
            np.testing.assert_array_equal(U.n(got), want, err_msg=name)
            got = tlayers.row_dense(U.t(x), tw, full_in=jw.q.shape[0])
            np.testing.assert_array_equal(U.n(got), want, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_mlp_equals_jax(arch):
    """Both int8 branches of ``mlp``: the gated one (qwen3-4b) bit for
    bit, the ungated ``gelu`` one (starcoder2-3b) within JAX's float32
    bar."""
    jcfg, tcfg, jq, tq = _setup(arch)
    jp = jax.tree.map(lambda a: a[0], jq["blocks"]["l0"]["mlp"])
    tp = ttr.block_params(tq["blocks"], 0)["l0"]["mlp"]
    x = _x(jcfg.d_model)
    want = np.asarray(jax.jit(lambda p, x: jlayers.mlp(p, x, jcfg))(jp, x))
    got = U.n(tlayers.mlp(tp, U.t(x), tcfg))
    if jcfg.mlp_gated:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=F32, atol=F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_attention_block_equals_jax(arch):
    """The prefill attention block (int8 q/k/v/o projections) over 8
    tokens within JAX's float32 bar."""
    jcfg, tcfg, jq, tq = _setup(arch)
    jp = jax.tree.map(lambda a: a[0], jq["blocks"]["l0"]["attn"])
    tp = ttr.block_params(tq["blocks"], 0)["l0"]["attn"]
    x = _x(jcfg.d_model, s=8)
    pos = np.broadcast_to(np.arange(8), (2, 8))
    want = np.asarray(jax.jit(lambda p, x, pos: jattn.attention_block(
        p, x, jcfg, pos))(jp, x, pos))
    got = U.n(tattn.attention_block(tp, U.t(x), tcfg, torch.from_numpy(
        pos.copy())))
    np.testing.assert_allclose(got, want, rtol=F32, atol=F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_serve_steps_equal_jax(arch):
    """8 ``serve_step``s from tokens 3 and 5, each feeding back its
    argmax: token for token, logits within JAX's float32 bar."""
    jcfg, tcfg, jq, tq = _setup(arch)
    jstep = jax.jit(lambda p, c, t, pos: jtr.serve_step(p, c, t, pos, jcfg))
    jcache = jtr.init_cache(jcfg, 2, 16)
    tcache = ttr.init_cache(tcfg, 2, 16, device="cpu")
    toks = np.array([[3], [5]], np.int32)
    for i in range(8):
        pos = np.full((2,), i, np.int32)
        jl, jcache = jstep(jq, jcache, jnp.asarray(toks), jnp.asarray(pos))
        with torch.inference_mode():
            tl, tcache = ttr.serve_step(tq, tcache, torch.from_numpy(
                toks.astype(np.int64)), torch.from_numpy(pos.astype(
                    np.int64)), tcfg)
        want, got = np.asarray(jl)[:, -1], U.n(tl)[:, -1]
        np.testing.assert_allclose(got, want, rtol=F32, atol=F32,
                                   err_msg=f"step {i}")
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        toks = want.argmax(-1)[:, None].astype(np.int32)
