"""The port's tensor-parallel slicing (``distributed/tp.py``), sharding
rules (``distributed/sharding.py``) and meshes (``launch/mesh.py``)
against the JAX package's, on the CPU: shapes only, so cheap.

``build_plan(...).flat_json()`` equals JAX's for qwen3-4b and mamba2-780m,
smoke and published configs, at TP 2 and 4; ``shard_state`` equals JAX's
array for array on the same numpy state.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_port_util as U
import jax
from repro import quant as jquant
from repro.configs import ARCHS as JARCHS
from repro.distributed import sharding as jsharding
from repro.distributed import tp as jtp
from repro.launch import mesh as jmesh
from repro.models import transformer as jtr
from repro.models.registry import get_model as jget_model
from repro.train import checkpoint as jck
from repro_torch.distributed import sharding
from repro_torch.distributed import tp
from repro_torch.launch import mesh
from repro_torch.models import transformer as ttr
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_model


def _plans(arch, smoke, degree, **over):
    jcfg = (JARCHS[arch].smoke_config() if smoke else JARCHS[arch].config())
    if over:
        jcfg = dataclasses.replace(jcfg, **over)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    js, ja = jget_model(jcfg).abstract_params(jcfg)
    ts, ta = get_model(tcfg).abstract_params(tcfg)
    return (jtp.build_plan(ja, js, cfg=jcfg, tp=degree),
            tp.build_plan(ta, ts, cfg=tcfg, tp=degree))


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-780m"])
def test_param_pspecs_and_spec_tree_equal_jax(arch):
    """``tp.param_pspecs`` (each leaf's mesh axes) and
    ``sharding.spec_tree`` (the logical rules over a (2, 2) mesh) as
    JAX's, entry for entry, on the published shapes."""
    jcfg = JARCHS[arch].config()
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    js, ja = jget_model(jcfg).abstract_params(jcfg)
    ts, ta = get_model(tcfg).abstract_params(tcfg)
    jplan, plan = _plans(arch, False, 2)

    def flat(tree, is_leaf=None):
        return {k: v for k, _, v in tp._flatten_with_keys(tree, is_leaf)}
    got = flat(tp.param_pspecs(plan, ts), lambda x: isinstance(x, tuple))
    want = flat(jax.tree.map(tuple, jtp.param_pspecs(jplan, js),
                             is_leaf=lambda x: isinstance(
                                 x, jax.sharding.PartitionSpec)),
                lambda x: isinstance(x, tuple))
    assert got == want and any(got.values())
    m = mesh.make_mesh((2, 2), ("data", "model"))
    rules = sharding.default_rules(m, fsdp=True)
    with sharding.use_sharding(m, rules):
        got = flat(sharding.spec_tree(ta, ts),
                   lambda x: isinstance(x, tuple))
    prev, jsharding._CTX = jsharding._CTX, jsharding.ShardingContext(
        mesh=type("M", (), {"shape": m.shape})(), rules=rules)
    try:
        want = flat(jax.tree.map(
            tuple, jsharding.spec_tree(ja, js), is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec)), lambda x: isinstance(x,
                                                                     tuple))
    finally:
        jsharding._CTX = prev
    assert got == want


# ============================================================= Segments ===
@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_segments_slice_unslice_round_trip(kind):
    """Plain and segment-packed rules slice as JAX's and reassemble bit
    for bit, on numpy arrays and on tensors."""
    arr = np.random.RandomState(0).randn(3, 14).astype(np.float32)
    for parts, n in ((((14, True),), 2),
                     (((6, True), (2, False), (2, False), (4, True)), 2)):
        jrule = jtp.Segments(dim=-1, parts=parts)
        rule = tp.Segments(dim=-1, parts=parts)
        x = arr if kind == "numpy" else torch.from_numpy(arr)
        shards = [rule.slice(x, i, n) for i in range(n)]
        for i, s in enumerate(shards):
            np.testing.assert_array_equal(U.n(s), jrule.slice(arr, i, n))
        np.testing.assert_array_equal(U.n(rule.unslice(shards)), arr)
        assert rule.local_width(n) == jrule.local_width(n)


def test_segments_validate_json_and_scale_rule():
    rule = tp.Segments.plain(0, 8)
    with pytest.raises(ValueError, match="covers"):
        rule.validate((9,), 2, "w")
    with pytest.raises(ValueError, match="divisible"):
        tp.Segments.plain(0, 6).validate((6,), 4, "w")
    packed = tp.Segments(dim=2, parts=((6, True), (2, False)))
    assert packed.to_json() == jtp.Segments(
        dim=2, parts=((6, True), (2, False))).to_json()
    assert tp.Segments.from_json(packed.to_json()) == packed
    assert tp.Segments.from_json("replicated") is None
    assert tp.rule_to_json(None) == "replicated"
    for rule, nd in ((tp.Segments.plain(2, 8), 3), (tp.Segments.plain(1, 8),
                                                    3), (None, 3)):
        jrule = None if rule is None else jtp.Segments(rule.dim, rule.parts)
        got = tp.rule_to_json(tp.scale_rule(rule, nd))
        assert got == jtp.rule_to_json(jtp.scale_rule(jrule, nd))


# ============================================================ build_plan ==
@pytest.mark.parametrize("degree", [2, 4])
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-780m"])
def test_build_plan_equals_jax(arch, smoke, degree):
    """Equal plans, or (qwen3-4b's smoke config has 2 KV heads, so not at
    TP 4) the same refusal."""
    try:
        jplan, plan = _plans(arch, smoke, degree)
    except ValueError as err:
        assert "num_kv_heads=2" in str(err) and (arch, smoke, degree) == (
            "qwen3-4b", True, 4)
        jcfg = JARCHS[arch].smoke_config()
        tcfg = ModelConfig(**dataclasses.asdict(jcfg))
        with pytest.raises(ValueError) as terr:
            tp.build_plan(*get_model(tcfg).abstract_params(tcfg)[::-1],
                          cfg=tcfg, tp=degree)
        assert str(terr.value) == str(err)
        return
    assert plan.flat_json() == jplan.flat_json()
    assert list(plan.flat) == list(jplan.flat)
    assert plan.tp == degree and plan.axis == "model"


def test_abstract_params_allocate_nothing():
    """The published qwen3-4b's shapes on the meta device: JAX's shapes and
    dtypes, the axes JAX's, no storage."""
    jcfg = JARCHS["qwen3-4b"].config()
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    shapes, axes = ttr.abstract_params(tcfg)
    jshapes, jaxes = jtr.abstract_params(jcfg)
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, _, v in tp._flatten_with_keys(shapes)}
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, _, v in jtp._flatten_with_keys(jshapes)[0]}
    assert got == want
    assert all(v.device.type == "meta"
               for _, _, v in tp._flatten_with_keys(shapes))
    assert axes == jaxes


@pytest.mark.parametrize("over,degree,what", [
    ({}, 3, "num_heads"), ({"num_kv_heads": 1}, 2, "num_kv_heads"),
    ({"d_ff": 130}, 4, "d_ff")])
def test_divisibility_errors_name_the_field(over, degree, what):
    with pytest.raises(ValueError) as jerr:
        _plans("qwen3-4b", True, degree, **over)
    assert what in str(jerr.value)
    jcfg = dataclasses.replace(JARCHS["qwen3-4b"].smoke_config(), **over)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    ts, ta = get_model(tcfg).abstract_params(tcfg)
    js, ja = jget_model(jcfg).abstract_params(jcfg)
    with pytest.raises(ValueError) as err:
        tp.build_plan(ta, ts, cfg=tcfg, tp=degree)
    with pytest.raises(ValueError) as jerr:
        jtp.build_plan(ja, js, cfg=jcfg, tp=degree)
    assert str(err.value) == str(jerr.value)


def test_odd_vocab_replicates_and_tp1_is_replicated():
    jplan, plan = _plans("qwen3-4b", True, 2, vocab_size=255)
    assert plan.flat["embedding/embed"] is None
    assert plan.flat_json() == jplan.flat_json()
    _, plan = _plans("qwen3-4b", True, 1)
    assert all(r is None for r in plan.flat.values())


# =========================================================== shard_state ==
def test_shard_state_equals_jax():
    """The converter's core on the same numpy int8 state (with an unknown
    key and a prefixed copy of a weight): per-shard arrays and shard_info
    equal JAX's."""
    jcfg = dataclasses.replace(JARCHS["qwen3-4b"].smoke_config(),
                               dtype="float32")
    params, _ = jtr.init(jax.random.key(0), jcfg)
    qp = jax.device_get(jquant.quantize_params(params, stack_dims=1))
    flat = dict(jck._flatten(qp)[0])
    flat["opt/step"] = np.asarray(3)
    flat["params/blocks/l0/mlp/wi/0"] = flat["blocks/l0/mlp/wi/0"]
    jplan, plan = _plans("qwen3-4b", True, 2)
    jshards, jinfo = jtp.shard_state(flat, jplan, prefix="params")
    shards, info = tp.shard_state(flat, plan, prefix="params")
    assert info == jinfo
    assert len(shards) == len(jshards) == 2
    for got, want in zip(shards, jshards):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_more_ranks_than_can_start_raise():
    """``launch.run`` refuses a rank count outside 1..cores before it
    starts any process."""
    from repro_torch.distributed import launch
    for n in (0, launch.max_ranks() + 1):
        with pytest.raises(ValueError, match="ranks asked for"):
            launch.run(print, n)


def test_ranks_past_their_deadline_are_stopped():
    """Ranks still running at ``timeout_s`` are stopped and ``run``
    raises: a hung rank cannot hold the caller (the TP test's fixture
    runs under such a bound)."""
    import time

    import torch_tp_cases
    from repro_torch.distributed import launch
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        launch.run(torch_tp_cases.sleeping_rank, 2, args=(600.0,),
                   timeout_s=20.0)
    assert time.monotonic() - t0 < 90


# ================================================== sharding and meshes ===
def test_sharding_rules_and_logical_spec_equal_jax():
    jm = jmesh.make_mesh((1, 1), ("data", "model"))
    m = mesh.make_mesh((1, 2), ("data", "model"))
    assert m.shape == {"data": 1, "model": 2}
    rules = sharding.default_rules(m, fsdp=True)
    assert rules == jsharding.default_rules(jm, fsdp=True)
    assert sharding.data_axes(m) == jsharding.data_axes(jm)
    assert sharding.active() is None and sharding.extent("mlp") == 1
    x = torch.zeros(3)
    assert sharding.shard(x, "batch") is x
    with sharding.use_sharding(m, rules) as ctx:
        assert sharding.active() is ctx
        assert sharding.extent("mlp") == 2 and sharding.extent("seq") == 1
        for axes, shape in (((None, "embed", "mlp"), (4, 8, 6)),
                            (("vocab", "embed"), (7, 8)),
                            (("heads", "kv_heads"), (4, 4))):
            want = jsharding.ShardingContext(
                mesh=type("M", (), {"shape": m.shape})(), rules=rules)
            prev, jsharding._CTX = jsharding._CTX, want
            try:
                jspec = tuple(jsharding.logical_spec(axes, shape))
            finally:
                jsharding._CTX = prev
            assert sharding.logical_spec(axes, shape) == jspec
    assert sharding.active() is None
    with pytest.raises(NotImplementedError, match="256 TPU chips"):
        mesh.make_production_mesh()
    # outside a process group a mesh is a layout: its groups raise
    assert not m.bound and m.size == 2
    with pytest.raises(RuntimeError, match="launch.run"):
        m.group("model")
    with pytest.raises(ValueError):
        mesh.make_mesh((1, 2), ("model",))
