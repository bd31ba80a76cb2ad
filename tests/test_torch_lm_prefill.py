"""The port's LM prefill slice against the JAX package, on the CPU.

Parameters are JAX's own (``transformer.init`` at a seed), carried across
with ``load_numpy_params``; tokens and activations come from numpy seeds.
The JAX side runs both its default (reference) placement and its Pallas
kernels in interpret mode; for the kernel placement the smoke configs are
widened to d_model 128 (d_ff 256) so that JAX's matmul kernel takes the
MLP (its ``k_lt_128`` floor).

Bars: float32 within 1e-4 (rtol and atol); bf16 within 2 bf16 ulps of the
output's max |value|, and top-1 equal wherever the top-2 margin exceeds
that (bf16 rounds at other places in the two packages).
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
from repro.kernels import fabric as jfabric
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mamba2 as jmamba
from repro.models import transformer as jtr
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.kernels import fabric as tfabric
from repro_torch.launch import steps
from repro_torch.models import attention as tattn
from repro_torch.models import config as tconfig
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import transformer as ttr
from repro_torch.models.param import load_numpy_params

# the ported archs: qwen3-4b and mamba2-780m, then the three dense configs
ARCH_LIST = ["qwen3-4b", "mamba2-780m", "nemotron-4-15b", "starcoder2-3b",
             "minicpm-2b"]
F32_TOL = 1e-4
BF16_ULPS = 2
SEQ = 64            # two SSD chunks of the smoke configs' 32


def _jcfg(arch, dtype, widen):
    cfg = dataclasses.replace(JARCHS[arch].smoke_config(), dtype=dtype)
    if widen:
        cfg = dataclasses.replace(cfg, d_model=128,
                                  d_ff=256 if cfg.d_ff else 0)
    return cfg


def _tcfg(jcfg):
    return tconfig.ModelConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _params(arch, dtype, widen):
    jcfg = _jcfg(arch, dtype, widen)
    jp, _ = jtr.init(jax.random.key(0), jcfg)
    return jcfg, jp, load_numpy_params(jax.tree.map(np.asarray, jp), "cpu")


def _close(got, want, dtype, what):
    got = U.n(got.float())
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=what)
    else:
        U.assert_bf16_close(got, want, BF16_ULPS, what)


def _jax_run(fn, interpret):
    if not interpret:
        return fn()
    with jfabric.use("pallas_interpret"):
        return fn()


# ------------------------------------------------------------- configs ---
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_configs_equal_jax(arch):
    for which in ("config", "smoke_config"):
        want = dataclasses.asdict(getattr(JARCHS[arch], which)())
        assert dataclasses.asdict(getattr(ARCHS[arch], which)()) == want
    from repro.configs import SHAPES as JSHAPES
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_param_tree_matches_jax(arch):
    jcfg = _jcfg(arch, "bfloat16", False)
    jp, jaxes = jtr.init(jax.random.key(0), jcfg)
    tp, taxes = ttr.init(torch.Generator().manual_seed(0), _tcfg(jcfg),
                         device="cpu")
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            path = f"{prefix}['{k}']"
            if isinstance(v, dict):
                yield from walk(v, path)
            else:
                yield path, v
    tflat = dict(walk(tp))
    assert set(tflat) == set(jflat)
    for k, v in tflat.items():
        assert tuple(v.shape) == tuple(jflat[k].shape), k
        assert str(v.dtype).split(".")[-1] == str(jflat[k].dtype), k
    assert taxes == jaxes
    # the same fan-in scales: a normal-init matrix has std ~ 1/sqrt(fan_in)
    if arch == "qwen3-4b":
        w = tp["blocks"]["l0"]["mlp"]["wo"].float()
        assert abs(float(w.std()) * jcfg.d_ff ** 0.5 - 1.0) < 0.05
        assert abs(float(tp["embedding"]["embed"].float().std()) - 1) < 0.05


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-780m"])
def test_load_numpy_params_is_bitwise(arch):
    _, jp, tp = _params(arch, "bfloat16", False)
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, v in leaves:
        node = tp
        for key in path:
            node = node[key.key]
        want = np.asarray(v)
        if want.dtype.name == "bfloat16":
            assert node.dtype == torch.bfloat16
            np.testing.assert_array_equal(U.n(node.view(torch.int16)),
                                          want.view(np.int16))
        else:
            assert str(node.dtype).split(".")[-1] == want.dtype.name
            np.testing.assert_array_equal(U.n(node), want)


# -------------------------------------------------------------- layers ---
def _x(cfg, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(
        (2, SEQ, cfg.d_model)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return jnp.asarray(x, jd), U.t(x, td)


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_block_and_mlp(dtype, interpret):
    jcfg, jp, tp = _params("qwen3-4b", dtype, interpret)
    jl = jax.tree.map(lambda p: p[0], jp["blocks"])["l0"]
    tl = ttr.block_params(tp["blocks"], 0)["l0"]
    jx, tx = _x(jcfg, dtype, 1)
    pos = np.broadcast_to(np.arange(SEQ), (2, SEQ))
    want = _jax_run(lambda: jattn.attention_block(
        jl["attn"], jx, jcfg, jnp.asarray(pos)), interpret)
    got = tattn.attention_block(tl["attn"], tx, _tcfg(jcfg), U.t(pos))
    _close(got, want, dtype, "attention_block")
    want = _jax_run(lambda: jlayers.mlp(jl["mlp"], jx, jcfg), interpret)
    got = tlayers.mlp(tl["mlp"], tx, _tcfg(jcfg))
    _close(got, want, dtype, "mlp")


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block(dtype, interpret):
    jcfg, jp, tp = _params("mamba2-780m", dtype, interpret)
    jl = jax.tree.map(lambda p: p[0], jp["blocks"])["l0"]
    tl = ttr.block_params(tp["blocks"], 0)["l0"]
    jx, tx = _x(jcfg, dtype, 2)
    want, (_, jstate) = _jax_run(
        lambda: jmamba.mamba_block(jl["mamba"], jx, jcfg), interpret)
    got, (_, state) = tmamba.mamba_block(tl["mamba"], tx, _tcfg(jcfg),
                                         return_state=True)
    _close(got, want, dtype, "mamba_block")
    # a prefill asks for no state, and the output does not depend on it
    got2, (_, none) = tmamba.mamba_block(tl["mamba"], tx, _tcfg(jcfg))
    assert none is None
    torch.testing.assert_close(got2, got, rtol=0, atol=0)
    if dtype == "float32":
        # in bf16 the state (a float32 sum over T of bf16 inputs) moves
        # with every upstream bf16 rounding flip; test_torch_ssd_scan
        # holds the closed form to the recurrence on equal inputs
        _close(state, jstate, dtype, "final state")


# ------------------------------------------------------------- prefill ---
@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_prefill_logits(arch, dtype, interpret):
    jcfg, jp, tp = _params(arch, dtype, interpret)
    tok = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, SEQ)).astype(np.int32)
    want, _ = _jax_run(lambda: jtr.apply(jp, jnp.asarray(tok), jcfg,
                                         last_logits_only=True), interpret)
    got = steps.prefill(tp, tok, _tcfg(jcfg), device="cpu")
    assert tuple(got.shape) == (2, 1, jcfg.vocab_size)
    _close(got, want, dtype, f"{arch} logits")
    if dtype == "bfloat16":
        want = np.asarray(want.astype(jnp.float32))
        U.assert_top1_beyond(got.float(), want, BF16_ULPS * U.bf16_ulp(
            np.abs(want).max()))


@pytest.mark.parametrize("arch,want", [
    ("qwen3-4b", {"flash_attention": 4, "matmul": 12}),
    ("mamba2-780m", {"ssd_scan": 4})])
def test_prefill_dispatch_counts_equal_jax(arch, want):
    jcfg, jp, tp = _params(arch, "float32", True)
    tok = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (1, SEQ)).astype(np.int32)
    with jfabric.use("pallas_interpret"):
        before = jfabric.counters()
        jtr.apply(jp, jnp.asarray(tok), jcfg, last_logits_only=True)
        jd = jfabric.counters_delta(before)
    before = tfabric.counters()
    steps.prefill(tp, tok, _tcfg(jcfg), device="cpu")
    td = tfabric.counters_delta(before)
    for op, n in want.items():
        assert jd[f"fabric.dispatch.{op}.pallas_interpret"] == n
        assert td[f"fabric.dispatch.{op}.reference"] == n
    assert {k for k in td if k.startswith("fabric.dispatch.")} == {
        f"fabric.dispatch.{op}.reference" for op in want}


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-780m"])
def test_final_hidden_is_what_prefill_unembeds(arch):
    """chip_smoke.py's depth-2 parity reads ``final_hidden``: unembedded,
    it gives the prefill's logits bit for bit."""
    jcfg, _, tp = _params(arch, "bfloat16", False)
    tok = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, SEQ))
    want = steps.prefill(tp, tok, _tcfg(jcfg), device="cpu")
    with torch.inference_mode():
        h, _ = ttr.final_hidden(tp, torch.as_tensor(tok), _tcfg(jcfg),
                                last_only=True)
        got = tlayers.unembed(tp["embedding"], h, _tcfg(jcfg))
    assert tuple(h.shape) == (2, 1, jcfg.d_model)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_prefill_refuses_params_on_another_device():
    jcfg = _jcfg("mamba2-780m", "float32", False)
    tp = {"embedding": {"embed": torch.zeros((4, 4), device="meta")}}
    with pytest.raises(ValueError, match="params on meta"):
        steps.prefill(tp, np.zeros((1, 4), np.int32), _tcfg(jcfg),
                      device="cpu")


def test_unported_layers_raise():
    # MoE layers are ported (tests/test_torch_families.py holds them
    # against JAX): the grok-1 smoke model builds and prefills
    from repro.configs import ARCHS as J
    moe = tconfig.ModelConfig(**dataclasses.asdict(
        J["grok-1-314b"].smoke_config()))
    params, _ = ttr.init(torch.Generator().manual_seed(0), moe, device="cpu")
    assert tuple(params["blocks"]["l0"]["moe"]["wi"].shape) == (
        moe.num_blocks, moe.num_experts, moe.d_model, moe.d_ff)
    logits = steps.prefill(params, np.zeros((1, 4), np.int32), moe,
                           device="cpu")
    assert logits.shape == (1, 1, moe.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())
    # int8 weights are ported: dense takes the int8 MAC path
    # (tests/test_torch_lm_int8.py holds it against JAX)
    from repro_torch.quant import core as qcore
    w = qcore.QuantizedTensor(torch.ones((4, 4), dtype=torch.int8),
                              torch.ones(()), None, None)
    out = tlayers.dense(torch.ones((2, 4)), w)
    assert out.dtype == torch.float32 and torch.all(out == 4)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-780m"])
def test_kernel_operands_meet_the_card_contract(monkeypatch, arch, batch):
    """The operands the model hands each kernel are what the card wrappers
    take (they raise on anything else): contiguous q/k/v, x and log_a,
    B/C contiguous per head, bf16 GEMM operands contiguous.  At batch 1 a
    transpose + reshape is a strided view, not a copy."""
    from repro_torch.kernels import ops as tops
    seen = []

    def spy(name, fn, check):
        def wrapped(*args, **kw):
            check(*args)
            seen.append(name)
            return fn(*args, **kw)
        monkeypatch.setattr(tops, name, wrapped)

    def fa(q, k, v):
        assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()

    def ssd(x, la, b, c):
        assert x.is_contiguous() and la.is_contiguous()
        for t in (b, c):
            assert t.stride(1) == t.shape[-1] and t.stride(2) == 1

    def mm(a, b, *rest):
        assert a.is_contiguous() and b.is_contiguous()
    spy("flash_attention", tops.flash_attention, fa)
    spy("ssd_scan", tops.ssd_scan, ssd)
    spy("mat_mul", tops.mat_mul, mm)
    cfg = ARCHS[arch].smoke_config()
    params, _ = ttr.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tok = np.random.default_rng(2).integers(0, cfg.vocab_size, (batch, 40))
    steps.prefill(params, tok, cfg, device="cpu")
    assert len(seen) == (16 if arch == "qwen3-4b" else 4)
