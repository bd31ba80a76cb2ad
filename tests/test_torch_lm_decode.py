"""The port's LM decode path against the JAX package, on the CPU: the
configs and ``applicable``, ``init_cache``, ``serve_step`` over four steps,
the port's own forward against its step-by-step decode, and
``LMDecodeEngine`` against JAX's engine on the same params.

Parameters are JAX's own (``transformer.init`` at a seed), carried across
with ``load_numpy_params``; tokens come from numpy seeds.  The port's MLP
always runs ``ops.mat_mul`` (the kernel path, its activation on the
float32 sums), so the JAX side runs under its kernel placement,
``fabric.use("pallas_interpret")``, where decode's M = 2 rows take the
kernel op's reference (``m_lt_8``) with the same epilogue.  JAX's
``serve_step`` is compiled with ``xla_allow_excess_precision`` off: with
it on, XLA keeps fused bf16 intermediates in float32 (rounding where
neither package's ops say to), which alone moves nemotron's bf16 logits
by 2.6 bf16 ulps.

Bars: float32 within 1e-4 (rtol and atol); bf16 within 2 bf16 ulps of the
leaf's max |value| (logits and every cache leaf); the port's forward
against its own decode within JAX's 2e-2 (``tests/test_models.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
import repro.engine as jengine
from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import applicable as japplicable
from repro.engine.lm import Request as JRequest
from repro.kernels import fabric as jfabric
from repro.models import transformer as jtr
from repro.models.registry import get_model as jget_model
import repro_torch.engine as tengine
from repro_torch.configs import ARCHS, SHAPES, applicable
from repro_torch.engine.lm import Request
from repro_torch.models import config as tconfig
from repro_torch.models import transformer as ttr
from repro_torch.models.param import load_numpy_params
from repro_torch.models.registry import get_model

DECODER_ARCHS = ["qwen3-4b", "mamba2-780m", "nemotron-4-15b",
                 "starcoder2-3b", "minicpm-2b"]
F32_TOL = 1e-4
BF16_ULPS = 2
STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops throughout: one intra-op thread (``U.one_thread``)."""
    with U.one_thread():
        yield


def _jcfg(arch, dtype):
    return dataclasses.replace(JARCHS[arch].smoke_config(), dtype=dtype)


def _tcfg(jcfg):
    return tconfig.ModelConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _params(arch, dtype):
    jcfg = _jcfg(arch, dtype)
    jp, _ = jtr.init(jax.random.key(0), jcfg)
    return jcfg, jp, load_numpy_params(jax.tree.map(np.asarray, jp), "cpu")


def _close(got, want, dtype, what):
    got = U.n(got.float())
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=what)
    else:
        U.assert_bf16_close(got, want, BF16_ULPS, what)


# ------------------------------------------------------------- configs ---
def test_registry_and_basecaller_soc_equal_jax():
    from repro.configs import basecaller_soc as jsoc
    from repro_torch.configs import basecaller_soc as tsoc
    # every JAX arch is ported: the five decoder archs held here and the
    # MoE, hybrid, VLM and encoder-decoder ones (test_torch_families.py,
    # test_torch_encdec.py)
    assert set(DECODER_ARCHS) < set(ARCHS)
    assert set(ARCHS) == set(JARCHS)
    assert set(ARCHS) <= set(JARCHS)
    assert "basecaller-soc" not in ARCHS
    for which in ("config", "smoke_config"):
        want = dataclasses.asdict(getattr(jsoc, which)())
        got = dataclasses.asdict(getattr(tsoc, which)())
        assert got.pop("dtype") == torch.float32
        assert np.dtype(want.pop("dtype")) == np.float32
        assert got == want


@pytest.mark.parametrize("shape", sorted(JSHAPES))
def test_applicable_equals_jax(shape):
    """Every JAX arch (the unported families' configs too: ``applicable``
    reads only the family) on every shape cell."""
    for arch, spec in JARCHS.items():
        jcfg = spec.config()
        assert (applicable(_tcfg(jcfg), SHAPES[shape])
                == japplicable(jcfg, JSHAPES[shape])), arch


def test_silu_rounds_as_jax():
    """``layers.silu`` rounds where ``jax.nn.silu`` does: bitwise in bf16
    (``torch.sigmoid`` rounded once differed on a third of these
    inputs, and moved the bf16 mamba2 decode state past its bar)."""
    from repro_torch.models import layers as tlayers
    x = np.random.default_rng(5).standard_normal((4, 4096)).astype(
        np.float32) * 4
    xb = U.t(x, torch.bfloat16)
    want = np.asarray(jax.nn.silu(jnp.asarray(U.n(xb.float()),
                                              jnp.bfloat16)).astype(
        jnp.float32))
    np.testing.assert_array_equal(U.n(tlayers.silu(xb).float()), want)
    np.testing.assert_allclose(U.n(tlayers.silu(U.t(x))),
                               np.asarray(jax.nn.silu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------- cache ---
@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_init_cache_equals_jax(arch):
    for dtype in ("float32", "bfloat16"):
        jcfg = _jcfg(arch, dtype)
        want = jtr.init_cache(jcfg, 3, 16)
        got = ttr.init_cache(_tcfg(jcfg), 3, 16, device="cpu")
        assert set(got) == set(want)
        for k, v in got.items():
            assert tuple(v.shape) == want[k].shape, (arch, k)
            assert str(v.dtype).split(".")[-1] == str(want[k].dtype), k
            assert not v.any()
        assert ttr.cache_specs(_tcfg(jcfg)) == jtr.cache_specs(jcfg)
        assert get_model(_tcfg(jcfg)).cache_axes(_tcfg(jcfg)) == \
            jget_model(jcfg).cache_axes(jcfg)


# ---------------------------------------------------------- serve_step ---
def _jax_serve_step(jp, jc, tok, pos, jcfg):
    with jfabric.use("pallas_interpret"):
        return jax.jit(jtr.serve_step, static_argnums=4).lower(
            jp, jc, tok, pos, jcfg).compile(
            compiler_options={"xla_allow_excess_precision": False})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_serve_step_equals_jax(arch, dtype):
    """Four steps from zeroed caches, the two rows at different positions:
    the logits and every cache leaf after each step."""
    jcfg, jp, tp = _params(arch, dtype)
    tcfg = _tcfg(jcfg)
    b, s_max = 2, 16
    jc = jtr.init_cache(jcfg, b, s_max)
    tc = ttr.init_cache(tcfg, b, s_max, device="cpu")
    rng = np.random.default_rng(3)
    pos = np.array([0, 5], np.int32)
    step = None
    for i in range(STEPS):
        tok = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
        if step is None:
            step = _jax_serve_step(jp, jc, jnp.asarray(tok),
                                   jnp.asarray(pos), jcfg)
        want, jc = step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        got, tc = ttr.serve_step(tp, tc, U.t(tok).long(), U.t(pos).long(),
                                 tcfg)
        assert tuple(got.shape) == (b, 1, jcfg.vocab_size)
        _close(got, want, dtype, f"{arch} step {i} logits")
        for k in jc:
            _close(tc[k], jc[k], dtype, f"{arch} step {i} cache {k}")
        pos += 1


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_decode_matches_forward(arch):
    """JAX's exactness check (``tests/test_models.py:70-90``) on the port
    alone: the f32 teacher-forced forward equals step-by-step
    ``serve_step`` on the same tokens, within JAX's 2e-2."""
    jcfg, _, tp = _params(arch, "float32")
    tcfg = _tcfg(jcfg)
    b, s = 1, 8
    toks = U.t(np.random.default_rng(7).integers(1, jcfg.vocab_size,
                                                 (b, s))).long()
    with torch.inference_mode():
        full, _ = ttr.apply(tp, toks, tcfg)
        cache = ttr.init_cache(tcfg, b, s, device="cpu")
        outs = []
        for i in range(s):
            logits, cache = ttr.serve_step(
                tp, cache, toks[:, i: i + 1],
                torch.full((b,), i, dtype=torch.int64), tcfg)
            outs.append(logits[:, 0])
    np.testing.assert_allclose(U.n(full), U.n(torch.stack(outs, dim=1)),
                               rtol=2e-2, atol=2e-2)


def test_unported_branches_raise_naming_their_items(tmp_path):
    jcfg, _, tp = _params("qwen3-4b", "float32")
    model = get_model(_tcfg(jcfg))
    # the loss and its vocab-parallel branch are ported; a vocab-sliced
    # unembedding outside a tensor-parallel context raises
    tok = torch.zeros((1, 4), dtype=torch.int32)
    sliced = dict(tp, embedding={"embed": tp["embedding"]["embed"][:128]})
    with pytest.raises(ValueError, match="tensor-parallel context"):
        model.loss(sliced, {"tokens": tok, "labels": tok}, _tcfg(jcfg))
    # abstract_params is ported (shapes on the meta device)
    shapes, _ = model.abstract_params(_tcfg(jcfg))
    assert shapes["embedding"]["embed"].device.type == "meta"
    # the encoder-decoder family is ported (test_torch_encdec.py); its
    # tensor-parallel decode is refused, as JAX's TP engine cannot serve it
    from repro_torch.models import encdec as ted
    whisper = _tcfg(JARCHS["whisper-medium"].smoke_config())
    assert get_model(whisper).serve is ted.serve_step
    with pytest.raises(NotImplementedError, match="KeyError 'xk'"):
        tengine.build("lm_decode", "smoke", cfg=whisper, mesh=2,
                      device="cpu")
    # tensor parallelism runs in ranks of a process group (item 5b:
    # tests/test_torch_tp.py); a data axis alone replicates the unmeshed
    # engine, as JAX's (its tokens are mesh None's)
    from repro_torch.launch.mesh import make_mesh
    with pytest.raises(RuntimeError, match="launch.run"):
        tengine.build("lm_decode", "smoke", params=tp, cfg=_tcfg(jcfg),
                      mesh=2, device="cpu")
    with pytest.raises(RuntimeError, match="launch.run"):
        tengine.build("lm_decode", "smoke", params=tp, cfg=_tcfg(jcfg),
                      mesh=make_mesh((2, 2), ("data", "model")),
                      device="cpu")
    tokens = {}
    for name, mesh in (("none", None),
                       ("data", make_mesh((2, 1), ("data", "model")))):
        eng = tengine.build("lm_decode", "smoke", params=tp,
                            cfg=_tcfg(jcfg), mesh=mesh, device="cpu")
        assert eng.mesh is None and eng.tp == 1
        eng.submit(Request(uid=0, prompt=np.array([3, 1, 4]),
                           max_new_tokens=4))
        eng.drain()
        tokens[name] = eng.finished[0].tokens_out
    assert tokens["data"] == tokens["none"] and len(tokens["none"]) == 5
    with pytest.raises(TypeError):
        tengine.build("lm_decode", "smoke", params=tp, cfg=_tcfg(jcfg),
                      mesh=object(), device="cpu")
    for mesh in (None, 1, "auto"):
        eng = tengine.build("lm_decode", "smoke", params=tp,
                            cfg=_tcfg(jcfg), mesh=mesh, device="cpu")
        assert eng.slots == 2 and eng.max_len == 32


# -------------------------------------------------------------- engine ---
def _requests(cls, vocab, case):
    rng = np.random.default_rng(0)
    if case == "continuous_batching":
        # JAX's tests/test_serving.py: more requests than slots
        return [cls(uid=u, prompt=np.array([1, 2]), max_new_tokens=3)
                for u in range(4)]
    # an empty prompt (seeded from token 0) among prompted ones
    out = [cls(uid=0, prompt=np.zeros(0, np.int32), max_new_tokens=3)]
    out += [cls(uid=u, prompt=rng.integers(1, vocab, 3), max_new_tokens=4)
            for u in range(1, 5)]
    return out


@functools.lru_cache(maxsize=None)
def _jax_engine_run(arch, case):
    jcfg, jp, _ = _params(arch, "float32")
    eng = jengine.build("lm_decode", model=jget_model(jcfg), params=jp,
                        cfg=jcfg, slots=2, max_len=16,
                        fabric="pallas_interpret")
    for r in _requests(JRequest, jcfg.vocab_size, case):
        eng.submit(r)
    rep = eng.drain()
    return rep, [(r.uid, list(r.tokens_out)) for r in eng.finished]


@pytest.mark.parametrize("case", ["empty_prompt", "continuous_batching"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-780m"])
def test_engine_equals_jax(arch, case):
    """f32: the tokens of every request, the finished order, and the
    counts, key for key (the fabric dispatch counters by value: both
    count every ``mat_mul`` call; JAX's extra ``fabric.fallback.*`` keys
    name TPU tile floors the port has not)."""
    want, want_tokens = _jax_engine_run(arch, case)
    jcfg, _, tp = _params(arch, "float32")
    eng = tengine.build("lm_decode", params=tp, cfg=_tcfg(jcfg), slots=2,
                        max_len=16, device="cpu")
    assert isinstance(eng.model, type(get_model(_tcfg(jcfg))))
    for r in _requests(Request, jcfg.vocab_size, case):
        eng.submit(r)
    got = eng.drain()
    assert [(r.uid, r.tokens_out) for r in eng.finished] == want_tokens
    for k in ("steps", "dispatches", "completed"):
        assert got[k] == want[k], k
    assert eng.telemetry.tokens == sum(len(t) for _, t in want_tokens) - \
        sum(1 for r in eng.finished if len(r.prompt))
    fab = {k: v for k, v in want.items() if k.startswith("fabric.dispatch.")}
    assert {k: v for k, v in got.items()
            if k.startswith("fabric.")} == fab
    if case == "continuous_batching":
        assert got["steps"] < 4 * 6
    assert got["tokens_per_s"] > 0 and got["p99_ms"] >= got["p50_ms"] > 0
    assert got["stage_prefill_s"] > 0 and got["stage_decode_s"] > 0


def test_engine_trace_has_request_spans_on_slot_tracks():
    jcfg, _, tp = _params("qwen3-4b", "float32")
    eng = tengine.build("lm_decode", params=tp, cfg=_tcfg(jcfg), slots=2,
                        max_len=16, device="cpu", trace=True)
    for r in _requests(Request, jcfg.vocab_size, "empty_prompt"):
        eng.submit(r)
    eng.drain()
    doc = eng.telemetry.tracer.to_chrome()
    from repro.obs.trace import validate_chrome_trace
    assert validate_chrome_trace(doc) == []
    spans = [e for e in doc["traceEvents"]
             if e.get("ph") == "B" and e.get("name") == "request"]
    assert sorted(e["args"]["uid"] for e in spans) == [0, 1, 2, 3, 4]
    tracks = {e["args"]["name"] for e in doc["traceEvents"]
              if e.get("ph") == "M" and e["name"] == "thread_name"}
    assert {"slot00", "slot01"} <= tracks
    assert eng.telemetry.gauges["slots_busy"] == 0


def test_engine_reads_a_jax_full_checkpoint(tmp_path):
    """``ckpt_dir``: a JAX-written ``full`` checkpoint serves the tokens
    of the params it holds."""
    from repro.train import checkpoint as jck
    jcfg, jp, tp = _params("qwen3-4b", "float32")
    jck.save(str(tmp_path), jp, 3)
    a = tengine.build("lm_decode", cfg=_tcfg(jcfg), slots=2, max_len=16,
                      ckpt_dir=str(tmp_path), device="cpu")
    b = tengine.build("lm_decode", params=tp, cfg=_tcfg(jcfg), slots=2,
                      max_len=16, device="cpu")
    for eng in (a, b):
        for r in _requests(Request, jcfg.vocab_size, "empty_prompt"):
            eng.submit(r)
        eng.drain()
    assert ([r.tokens_out for r in a.finished]
            == [r.tokens_out for r in b.finished])
