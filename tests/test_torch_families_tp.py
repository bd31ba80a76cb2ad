"""Tensor-parallel decode, the TP plan and int8 weights of the MoE, hybrid,
VLM and encoder-decoder families against the JAX package, on the CPU.

TP decode: the f32 smoke grok-1-314b, llama4-maverick-400b-a17b,
jamba-v0.1-52b and internvl2-76b on two gloo ranks (one start from a
module fixture; their side is ``tests/torch_mesh_cases.py``, no JAX),
``LMDecodeEngine(mesh=2)`` for 8 steps from tokens 3 and 5, each feeding
back its argmax: within 1e-5 of the port's TP 1 and token for token
(JAX's bar for TP 2 against TP 1, ``tests/test_tensor_parallel.py``);
the port's TP 1 against JAX's ``serve_step`` at the families' decode bar,
1e-4 (``test_torch_families.py``).  JAX's own TP engine is not the
reference: its internvl2 tokens parted from its TP 1 at the third token
in one run of two.  ``serve --tp 2`` of jamba runs in the ranks too.

The plan: ``build_plan(...).flat_json()`` equals JAX's for the five
family configs at TP 2, smoke and published (on meta tensors).

int8 (``quantize_params(stack_dims=1)`` of the same f32 smoke params in
both packages, JAX's side under ``jax.jit``): internvl2 and whisper, each
projection bit for bit; each block of internvl2's forward with patch
embeddings, its 8 ``serve_step``s, and whisper's ``encode``, within
JAX's float32 bar ``allclose(1e-5, 1e-5)``; whisper's decoder served in
int8 with its cross-attention left float (JAX's ``jnp.einsum`` there takes no
QuantizedTensor) within the encoder-decoder's decode bar, 1e-4
(``test_torch_encdec.py``: its cache is bf16 in both packages).

What JAX refuses, the port refuses: int8 MoE experts and a quantized
cross-attention raise a ``TypeError`` in both; whisper's TP decode raises
in the port with the registry's message (JAX's own refusal, ``KeyError:
'xk'``, needs two devices in a subprocess and is recorded in ROADMAP.md
instead).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
import torch_mesh_cases as cases
from repro import quant as jquant
from repro.configs import ARCHS as JARCHS
from repro.distributed import tp as jtp
from repro.models import encdec as jed
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.models.registry import get_model as jget_model
from repro.quant.params import select_weight_leaf as jselect
from repro_torch import engine as tengine
from repro_torch.distributed import launch
from repro_torch.distributed import tp
from repro_torch.launch import serve as tserve
from repro_torch.models import encdec as ted
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import load_numpy_params
from repro_torch.models.registry import get_model
from repro_torch.quant import params as tqparams
from repro_torch.quant.params import select_weight_leaf

DECODERS = ["grok-1-314b", "llama4-maverick-400b-a17b", "jamba-v0.1-52b",
            "internvl2-76b"]
FAMILIES = DECODERS + ["whisper-medium"]
STEPS = 8
F32, DECODE_TOL = 1e-5, 1e-4
SERVE = ["--workload", "lm_decode", "--smoke", "--tp", "2", "--arch",
         "jamba-v0.1-52b", "--device", "cpu", "--requests", "2",
         "--new-tokens", "4"]


def _jcfg(arch):
    return dataclasses.replace(JARCHS[arch].smoke_config(), dtype="float32")


@functools.lru_cache(maxsize=None)
def _tree(arch):
    """The f32 smoke params as a nested numpy tree: the port's ``init``
    from seed 0 (both packages read it)."""
    cfg = cases.config(arch)
    params, _ = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
    return jax.tree.map(lambda t: t.numpy(), params)


def _allclose(want, got, tol):
    return all(np.all(np.abs(a - b) <= tol + tol * np.abs(a))
               for a, b in zip(want, got))


def _tokens(logits):
    return [a.argmax(-1).tolist() for a in logits]


# ----------------------------------------------------------- TP decode --
@pytest.fixture(scope="module")
def run():
    spec = {"params": {a: _tree(a) for a in DECODERS}, "steps": STEPS,
            "serve": {"serve": SERVE}}
    ranks = launch.run(cases.run_jobs, 2, args=(
        {"decode": ("family_tp_decode", spec)},), threads=1, timeout_s=600)
    with U.one_thread():
        solo = cases.family_tp_decode(0, 1, dict(spec, serve={}))
    return {"ranks": [r["decode"] for r in ranks], "solo": solo}


def _jax_decode(arch):
    cfg = _jcfg(arch)
    step = jax.jit(lambda p, c, t, pos: jtr.serve_step(p, c, t, pos, cfg))
    params = jax.tree.map(jnp.asarray, _tree(arch))
    cache = jtr.init_cache(cfg, 2, 16)
    toks = np.array([[3], [5]], np.int32)
    out = []
    for i in range(STEPS):
        logits, cache = step(params, cache, jnp.asarray(toks),
                             jnp.full((2,), i, jnp.int32))
        out.append(np.asarray(logits)[:, -1])
        toks = out[-1].argmax(-1)[:, None].astype(np.int32)
    return out


@pytest.mark.parametrize("arch", DECODERS)
def test_tp2_decode_equals_tp1(run, arch):
    solo = run["solo"][arch]
    assert len(solo) == STEPS
    for res in run["ranks"]:
        assert _allclose(solo, res[arch], F32), arch
        assert _tokens(res[arch]) == _tokens(solo)


@pytest.mark.parametrize("arch", DECODERS)
def test_tp1_decode_equals_jax(run, arch):
    want, got = _jax_decode(arch), run["solo"][arch]
    assert _allclose(want, got, DECODE_TOL)
    assert _tokens(got) == _tokens(want)


def test_serve_tp2_serves_the_hybrid(run):
    """``serve --tp 2 --arch jamba-v0.1-52b`` on each rank: both drain
    the same run."""
    reps = [res["serve"] for res in run["ranks"]]
    assert reps[0] == reps[1] and reps[0]["completed"] == 2


# ---------------------------------------------------------------- plan --
@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", FAMILIES)
def test_build_plan_equals_jax(arch, smoke):
    jcfg = JARCHS[arch].smoke_config() if smoke else JARCHS[arch].config()
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    js, ja = jget_model(jcfg).abstract_params(jcfg)
    ts, ta = get_model(tcfg).abstract_params(tcfg)
    want = jtp.build_plan(ja, js, cfg=jcfg, tp=2).flat_json()
    got = tp.build_plan(ta, ts, cfg=tcfg, tp=2).flat_json()
    assert got == want
    assert any(v != "replicated" for v in got.values())
    # the experts stay replicated under TP, as JAX's
    assert all(v == "replicated" for k, v in got.items() if "/moe/" in k)


# ---------------------------------------------------------------- int8 --
def _no_xattn(names, leaf):
    return "xattn" not in names


@functools.lru_cache(maxsize=None)
def _int8(arch, float_xattn=False):
    """JAX's and the port's ``quantize_params(stack_dims=1)`` of the same
    float params (``float_xattn``: the cross-attention left float)."""
    jp = jax.tree.map(jnp.asarray, _tree(arch))
    jq = jquant.quantize_params(jp, stack_dims=1, predicate=(
        (lambda n, w: jselect(n, w) and _no_xattn(n, w)) if float_xattn
        else None))
    tq = tqparams.quantize_params(
        load_numpy_params(_tree(arch), "cpu"), stack_dims=1, predicate=(
            (lambda n, w: select_weight_leaf(n, w) and _no_xattn(n, w))
            if float_xattn else None))
    return jq, tq


def _quantized(tree, path=()):
    if isinstance(tree, dict) and not {"q", "scale"} <= set(tree):
        for k, v in tree.items():
            yield from _quantized(v, path + (k,))
    elif hasattr(tree, "q"):
        yield path, tree


@pytest.mark.parametrize("arch", ["internvl2-76b", "whisper-medium"])
def test_int8_projections_equal_jax_bitwise(arch):
    """The port's payloads and scales are JAX's, and every int8
    projection of layer 0 (``layers.dense``, and ``row_dense`` outside a
    TP context) equals JAX's jitted ``dense`` bit for bit."""
    jq, tq = _int8(arch)
    jdense = jax.jit(jlayers.dense)
    rng = np.random.default_rng(3)
    seen = 0
    for path, jw in _quantized(jq):
        node = tq
        for k in path:
            node = node[k]
        np.testing.assert_array_equal(U.n(node.q), np.asarray(jw.q))
        np.testing.assert_array_equal(U.n(node.scale), np.asarray(jw.scale))
        jw0 = jax.tree.map(lambda a: a[0], jw)
        x = rng.standard_normal((2, 3, jw0.q.shape[0])).astype(np.float32)
        want = np.asarray(jdense(x, jw0))
        got = tlayers.dense(U.t(x), node[0])
        np.testing.assert_array_equal(U.n(got), want, err_msg=str(path))
        got = tlayers.row_dense(U.t(x), node[0], full_in=jw0.q.shape[0])
        np.testing.assert_array_equal(U.n(got), want, err_msg=str(path))
        seen += 1
    assert seen >= (7 if arch == "internvl2-76b" else 14)


def test_int8_vlm_blocks_and_serve_steps_equal_jax():
    """int8 internvl2: each block of the forward with patch embeddings,
    fed JAX's input to it, within JAX's float32 bar; the whole forward's
    next token equal to JAX's; 8 ``serve_step``s within the bar, token for
    token.  The whole forward is not held to the bar: blocks apart, the
    float parts' ulps (XLA's and PyTorch's CPU ``exp``/``rsqrt``) drift,
    and on this input an activation of a later block rounds to another
    int8 code, which moves the logits by up to 0.022 (ROADMAP.md, Queue 3
    entry 9; seeds 0-3 keep within 1.4e-6)."""
    jcfg = _jcfg("internvl2-76b")
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jq, tq = _int8("internvl2-76b")
    rng = np.random.default_rng(4)
    tok = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    emb = rng.standard_normal((2, jcfg.frontend_tokens, jcfg.d_model)
                              ).astype(np.float32)
    x = np.asarray(jlayers.embed(jq["embedding"], tok, jcfg))
    x = np.concatenate([emb, x[:, jcfg.frontend_tokens:]], axis=1)
    pos = np.broadcast_to(np.arange(16), (2, 16))
    jblock = jax.jit(lambda b, x: jtr._block_fn(b, x, jcfg, pos,
                                                jnp.zeros(()))[0])
    for i in range(jcfg.num_blocks):
        want = np.asarray(jblock(jax.tree.map(lambda a: a[i], jq["blocks"]),
                                 x))
        with torch.no_grad():
            got, _ = ttr._block_fn(ttr.block_params(tq["blocks"], i),
                                   U.t(x), tcfg, torch.from_numpy(pos.copy()),
                                   torch.zeros(()))
        np.testing.assert_allclose(U.n(got), want, rtol=F32, atol=F32,
                                   err_msg=f"block {i}")
        x = want
    want, _ = jax.jit(lambda p, t, e: jtr.apply(p, t, jcfg, input_embeds=e))(
        jq, tok, emb)
    with torch.no_grad(), U.one_thread():
        got, _ = ttr.apply(tq, U.t(tok).long(), tcfg, input_embeds=U.t(emb))
    np.testing.assert_array_equal(U.n(got)[:, -1].argmax(-1),
                                  np.asarray(want)[:, -1].argmax(-1))
    jstep = jax.jit(lambda p, c, t, pos: jtr.serve_step(p, c, t, pos, jcfg))
    jcache = jtr.init_cache(jcfg, 2, 16)
    tcache = ttr.init_cache(tcfg, 2, 16, device="cpu")
    toks = np.array([[3], [5]], np.int32)
    for i in range(STEPS):
        pos = np.full((2,), i, np.int32)
        jl, jcache = jstep(jq, jcache, jnp.asarray(toks), jnp.asarray(pos))
        with torch.inference_mode():
            tl, tcache = ttr.serve_step(tq, tcache, U.t(toks).long(),
                                        U.t(pos).long(), tcfg)
        want = np.asarray(jl)[:, -1]
        np.testing.assert_allclose(U.n(tl)[:, -1], want, rtol=F32, atol=F32,
                                   err_msg=f"step {i}")
        toks = want.argmax(-1)[:, None].astype(np.int32)
        np.testing.assert_array_equal(U.n(tl)[:, -1].argmax(-1), toks[:, 0])


def _frames(cfg, seed=5, s=32):
    return np.random.default_rng(seed).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)


def test_int8_encoder_equals_jax():
    """int8 whisper's ``encode`` (every encoder projection int8) within
    JAX's float32 bar."""
    jcfg = _jcfg("whisper-medium")
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jq, tq = _int8("whisper-medium")
    frames = _frames(jcfg)
    want = jax.jit(lambda p, f: jed.encode(p, f, jcfg))(jq, frames)
    with torch.no_grad(), U.one_thread():
        got = ted.encode(tq, U.t(frames), tcfg)
    np.testing.assert_allclose(U.n(got), np.asarray(want), rtol=F32,
                               atol=F32)


def test_int8_decoder_with_float_cross_attention_serves_as_jax():
    """int8 whisper with its cross-attention float (the rest of the
    decoder and the encoder int8): ``prefill_cross`` and 8
    ``serve_step``s token for token, logits within 1e-4."""
    jcfg = _jcfg("whisper-medium")
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jq, tq = _int8("whisper-medium", float_xattn=True)
    assert not any("xattn" in p for p, _ in _quantized(jq))
    assert any("decoder" in p for p, _ in _quantized(jq))
    frames = _frames(jcfg)
    jenc = jax.jit(lambda p, f: jed.encode(p, f, jcfg))(jq, frames)
    jcache = jed.prefill_cross(jq, jed.init_cache(jcfg, 2, 16, 32), jenc,
                               jcfg)
    jstep = jax.jit(lambda p, c, t, pos: jed.serve_step(p, c, t, pos, jcfg))
    with torch.inference_mode(), U.one_thread():
        enc = ted.encode(tq, U.t(frames), tcfg)
        tcache = ted.prefill_cross(
            tq, ted.init_cache(tcfg, 2, 16, 32, device="cpu"), enc, tcfg)
    toks = np.array([[3], [5]], np.int32)
    for i in range(STEPS):
        pos = np.full((2,), i, np.int32)
        jl, jcache = jstep(jq, jcache, jnp.asarray(toks), jnp.asarray(pos))
        with torch.inference_mode():
            tl, tcache = ted.serve_step(tq, tcache, U.t(toks).long(),
                                        U.t(pos).long(), tcfg)
        want = np.asarray(jl)[:, -1]
        np.testing.assert_allclose(U.n(tl)[:, -1], want, rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=f"step {i}")
        toks = want.argmax(-1)[:, None].astype(np.int32)
        np.testing.assert_array_equal(U.n(tl)[:, -1].argmax(-1), toks[:, 0])


# ------------------------------------------------------------ refusals --
@pytest.mark.parametrize("arch", ["grok-1-314b", "llama4-maverick-400b-a17b",
                                  "jamba-v0.1-52b"])
@pytest.mark.parametrize("impl", ["dense", "dispatch"])
def test_int8_experts_raise_in_both_packages(arch, impl):
    """JAX's einsum takes no QuantizedTensor expert stack; nor does
    ``torch.einsum``, whose ``TypeError`` names it: the port never
    dequantizes quietly."""
    jcfg = dataclasses.replace(_jcfg(arch), moe_impl=impl)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jq, tq = _int8(arch)
    tok = np.zeros((1, 4), np.int32)
    with pytest.raises(TypeError, match="QuantizedTensor"):
        jtr.apply(jq, jnp.asarray(tok), jcfg)
    with pytest.raises(TypeError, match="got QuantizedTensor"):
        with torch.no_grad():
            ttr.apply(tq, U.t(tok).long(), tcfg)


def test_int8_cross_attention_raises_in_both_packages():
    jcfg = _jcfg("whisper-medium")
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jq, tq = _int8("whisper-medium")
    enc = _frames(jcfg, s=8)
    with pytest.raises(TypeError, match="QuantizedTensor"):
        jed.prefill_cross(jq, jed.init_cache(jcfg, 2, 16, 8), enc, jcfg)
    cache = ted.init_cache(tcfg, 2, 16, 8, device="cpu")
    with pytest.raises(TypeError, match="matmul.*not QuantizedTensor"):
        ted.prefill_cross(tq, cache, U.t(enc), tcfg)
    _, tfloat = _int8("whisper-medium", float_xattn=True)
    cache = ted.prefill_cross(tfloat, cache, U.t(enc), tcfg)
    with pytest.raises(TypeError, match="matmul.*not QuantizedTensor"):
        ted.serve_step(tq, cache, torch.zeros((2, 1), dtype=torch.long),
                       torch.zeros((2,), dtype=torch.long), tcfg)


def test_whisper_tp_decode_is_refused():
    """JAX's TP engine cannot serve the encoder-decoder (no cross K/V in
    its cache specs); the port's engine and ``serve --tp`` refuse it by
    the registry's message, before any rank starts."""
    whisper = cases.config("whisper-medium")
    with pytest.raises(NotImplementedError, match="KeyError 'xk'"):
        tengine.build("lm_decode", "smoke", cfg=whisper, mesh=2,
                      device="cpu")
    with pytest.raises(NotImplementedError, match="encdec family"):
        tserve.main(["--workload", "lm_decode", "--smoke", "--tp", "2",
                     "--arch", "whisper-medium", "--device", "cpu"])
