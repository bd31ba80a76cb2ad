"""The port's mesh placement against JAX's, on the CPU: ZeRO-3 (``fsdp``)
params and moments over data, expert parallelism, and the experts'
``mlp`` over the model axis.

JAX shards a mesh's train state by ``spec_tree`` under ``default_rules``
(``repro/train/trainer.py``); the port's ``sharding.mesh_plan`` places
every leaf by the same specs.  Here:

- local shapes, leaf for leaf, on meta tensors (no ranks): for the ten
  archs at 8x8 and 2x2, in every cell the port runs, rank 0's params (and
  in the train cells its two moments) have the shapes JAX's spec gives,
  each dim divided by the extents of its mesh axes; the refused cells are
  exactly those listed in ``REFUSED`` (the KV heads a model axis of 8
  cannot split, the encoder-decoder's tensor-parallel decode), beside
  JAX's own N/A;
- mesh steps (gloo ranks, ``tests/torch_mesh_cases.py``, no JAX) at 2x1,
  2x2 and 4x1 of the f32 smoke nemotron-4-15b (dense ZeRO-3), llama4 (its
  8 experts spread over the data ranks, ZeRO-3 elsewhere; ``dense`` and
  ``dispatch`` at capacity 0.5) and grok-1 (its override: experts ZeRO-3
  on ``d_model``), held to JAX's single-device step with PR 27's bars:
  the loss within 1e-5 relative, each gradient within 1e-4 of its leaf's
  largest, the new state within 1e-6 of AdamW on the mesh's own
  (reassembled) gradients;
- ROADMAP Queue 3 entry 8 across data ranks: llama4's dispatch at 2x1,
  whose data rank 0's last row overflows an expert's capacity (shown from
  the plain functions), equals JAX's step;
- recovery after ``--fail-at`` on a 2x2 mesh under ZeRO-3, bit for bit;
- checkpoints: the mesh's own, restored on the mesh bit for bit,
  reassembled whole (``checkpoint.restore``'s reader) equal to the
  ranks' state bit for bit and to the one-device AdamW on the mesh's
  gradients within the update bar, and read by the converter.

Two module fixtures start two ranks once and four ranks once; JAX's
references run in the parent meanwhile.
"""
import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U  # noqa: F401  (torch lazy-module registries)
import torch_mesh_cases as cases
from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import applicable as japplicable
from repro.distributed import sharding as jsharding
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.models.registry import get_model as jget_model
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.distributed import launch, tp
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models.param import load_numpy_params
from repro_torch.models.registry import get_model
from repro_torch.train import checkpoint as ck
from repro_torch.train import checkpoint_converter
from repro_torch.train import optimizer as topt

NEMO, LLAMA, GROK = ("nemotron-4-15b", "llama4-maverick-400b-a17b",
                     "grok-1-314b")
DISPATCH = {"moe_impl": "dispatch", "moe_capacity_factor": 0.5}
# name: (arch, config overrides, (data, model))
STEP_CASES = {}
for _mesh in ((2, 1), (2, 2), (4, 1)):
    _tag = f"{_mesh[0]}x{_mesh[1]}"
    STEP_CASES[f"{NEMO}/{_tag}"] = (NEMO, {}, _mesh)
    STEP_CASES[f"{LLAMA}/dense/{_tag}"] = (LLAMA, {}, _mesh)
    STEP_CASES[f"{LLAMA}/dispatch/{_tag}"] = (LLAMA, DISPATCH, _mesh)
    STEP_CASES[f"{GROK}/{_tag}"] = (GROK, {}, _mesh)
SEQ, BATCH = 32, 4
LOSS_TOL, GRAD_TOL, UPDATE_TOL = 1e-5, 1e-4, 1e-6
# the cells the port refuses, by (arch, mesh): shape -> reason's start
_ENCDEC = "the decode cell: the encdec family"
REFUSED = {
    ("whisper-medium", "2x2"): {"decode_32k": _ENCDEC},
    ("whisper-medium", "8x8"): {"decode_32k": _ENCDEC},
    ("starcoder2-3b", "8x8"): {
        s: "the 8x8 mesh plan: model 'starcoder2-3b' cannot shard over "
           "tp=8: num_kv_heads=2"
        for s in ("train_4k", "prefill_32k", "decode_32k")},
}


# ============================================================ placement ===
@functools.lru_cache(maxsize=None)
def _jax_tree(arch):
    jcfg = JARCHS[arch].config()
    shapes, axes = jget_model(jcfg).abstract_params(jcfg)
    return jcfg, shapes, axes


def _flat(tree, is_leaf=None):
    return {k: v for k, _, v in tp._flatten_with_keys(tree, is_leaf)}


def _jax_local_shapes(arch, shape, d, m):
    """JAX's per-device shape of every param leaf of the cell: its
    ``spec_tree`` under ``make_rules`` on a stand-in (d, m) mesh, each
    dim divided by the extents of its entry's axes."""
    jcfg, shapes, axes = _jax_tree(arch)
    sizes = {"data": d, "model": m}
    stand_in = type("M", (), {"shape": sizes})()
    rules = jsteps.make_rules(JARCHS[arch], stand_in, shape, jcfg)
    prev = jsharding._CTX
    jsharding._CTX = jsharding.ShardingContext(mesh=stand_in, rules=rules)
    try:
        specs = jsharding.spec_tree(axes, shapes)
    finally:
        jsharding._CTX = prev
    specs = _flat(jax.tree.map(tuple, specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec)), lambda x: isinstance(x, tuple))
    out = {}
    for key, leaf in _flat(shapes).items():
        local = list(leaf.shape)
        for i, entry in enumerate(specs[key]):
            for a in (entry,) if isinstance(entry, str) else entry or ():
                assert local[i] % sizes[a] == 0, (key, entry)
                local[i] //= sizes[a]
        out[key] = tuple(local)
    return out


@pytest.mark.parametrize("mesh", ["2x2", "8x8"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_local_shapes_equal_jax_spec_tree(arch, mesh):
    d, m = (int(x) for x in mesh.split("x"))
    layout = make_mesh((d, m), ("data", "model"))
    jcfg = _jax_tree(arch)[0]
    ran, refused = 0, {}
    for name, shape in SHAPES.items():
        if not japplicable(jcfg, JSHAPES[name])[0]:
            continue                                       # JAX's N/A
        try:
            cell = steps.build_cell(arch, ARCHS[arch], shape, layout)
        except steps.Unsupported as e:
            refused[name] = str(e)
            continue
        want = _jax_local_shapes(arch, JSHAPES[name], d, m)
        trees = ({"params": cell.args[0]["params"],
                  "m": cell.args[0]["opt"]["m"],
                  "v": cell.args[0]["opt"]["v"]} if shape.kind == "train"
                 else {"params": cell.args[0]})
        for what, tree in trees.items():
            got = {k: tuple(v.shape) for k, v in _flat(tree).items()}
            assert got == want, (name, what, {
                k: (got.get(k), w) for k, w in want.items()
                if got.get(k) != w})
        ran += 1
    expected = REFUSED.get((arch, mesh), {})
    assert ran or len(expected) == 3         # every cell refused
    assert sorted(refused) == sorted(expected), refused
    for name, reason in refused.items():
        assert reason.startswith(expected[name]), reason


def test_expert_leaves_split_by_the_rules():
    """At 8x8: llama4's 128 experts are 16 a data rank with their mlp an
    eighth (expert parallelism); grok-1's override leaves its 8 experts
    whole a rank and splits ``d_model`` over data (ZeRO-3); a spec the
    port cannot realise raises naming the leaf."""
    from repro_torch.distributed import sharding
    layout = make_mesh((8, 8), ("data", "model"))
    got = {}
    for arch in (LLAMA, GROK):
        cell = steps.build_cell(arch, ARCHS[arch], SHAPES["train_4k"],
                                layout)
        got[arch] = (cell.plan.flat["blocks/l1/moe/wi" if arch == LLAMA
                                    else "blocks/l0/moe/wi"],
                     _flat(cell.args[0]["params"]))
    pl, params = got[LLAMA]
    assert (pl.data_dim, pl.experts, pl.model_dim) == (1, True, 3)
    assert tuple(params["blocks/l1/moe/wi"].shape) == (24, 16, 5120, 1024)
    pl, params = got[GROK]
    assert (pl.data_dim, pl.experts, pl.model_dim) == (2, False, 3)
    assert tuple(params["blocks/l0/moe/wi"].shape) == (64, 8, 768, 4096)
    cfg = cases.config(NEMO)
    shapes, axes = get_model(cfg).abstract_params(cfg)
    bad = sharding.default_rules(make_mesh((1, 2), ("data", "model")),
                                 overrides={"embed": ("data", "model")})
    with pytest.raises(ValueError, match="blocks/l0/attn/wk: dim 1 over"):
        sharding.mesh_plan(axes, shapes, cfg=cfg, mesh=make_mesh(
            (1, 2), ("data", "model")), rules=bad)


# ======================================================== mesh steps =====
@functools.lru_cache(maxsize=None)
def _tree(arch):
    """The params as a numpy tree: the port's ``init`` from seed 0, read
    by both packages."""
    cfg = cases.config(arch)
    params, _ = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
    return tp._unflatten_like(params, cases.flat(params))


@functools.lru_cache(maxsize=None)
def _batch(arch):
    cfg = cases.config(arch)
    rng = np.random.default_rng(11)
    return {k: rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
            for k in ("tokens", "labels")}


def _flat_jax(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _jax_ref(arch, over):
    """JAX's jitted loss and ``jax.grad`` on the global batch."""
    jcfg = dataclasses.replace(JARCHS[arch].smoke_config(), dtype="float32",
                               **dict(over))
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jtr.loss_fn(p, b, jcfg)[0]))
    loss, g = fn(jax.tree.map(jnp.asarray, _tree(arch)),
                 {k: jnp.asarray(v) for k, v in _batch(arch).items()})
    return float(loss), _flat_jax(g)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    arches = (NEMO, LLAMA, GROK)
    spec = {"params": {a: _tree(a) for a in arches},
            "batches": {a: _batch(a) for a in arches}}

    def cases_of(world):
        return {name: (arch, over, mesh, 1)
                for name, (arch, over, mesh) in STEP_CASES.items()
                if mesh[0] * mesh[1] == world}
    recovery = {}
    for fail in (False, True):
        name = "fail" if fail else "clean"
        recovery[name] = (
            ["--device", "cpu", "--smoke", "--arch", NEMO, "--steps", "6",
             "--global-batch", "4", "--seq-len", "32", "--ckpt-every", "2",
             "--mesh", "2x2", "--ckpt-dir", str(tmp / name)]
            + (["--fail-at", "3"] if fail else []))
    jobs = {2: {"steps": ("family_mesh_step",
                          {**spec, "cases": cases_of(2)})},
            4: {"steps": ("family_mesh_step",
                          {**spec, "cases": cases_of(4)}),
                "recovery": ("mesh_recovery", {"runs": recovery}),
                "checkpoint": ("mesh_checkpoint", {
                    "arch": NEMO, "mesh": (2, 2), "params": _tree(NEMO),
                    "batch": _batch(NEMO), "dir": str(tmp / "ckpt")})}}
    got = {}

    def start(world):
        got[world] = launch.run(cases.run_jobs, world, args=(jobs[world],),
                                threads=1, timeout_s=600)
    threads = [threading.Thread(target=start, args=(w,)) for w in (2, 4)]
    for t in threads:
        t.start()
    for name, (arch, over, _) in STEP_CASES.items():   # JAX meanwhile
        _jax_ref(arch, tuple(sorted(over.items())))
    for t in threads:
        t.join()
    out = {"tmp": tmp}
    for world in (2, 4):
        assert world in got, f"the {world} ranks did not finish"
        for job in jobs[world]:
            for name in (cases_of(world) if job == "steps" else [job]):
                out[name] = [g[job][name] if job == "steps" else g[job]
                             for g in got[world]]
    return out


def _plan(arch, over, mesh):
    return cases.mesh_plan_for(arch, cases.family_config(arch, over), *mesh)


def _excess(got: dict, want: dict, tol: float) -> float:
    assert sorted(got) == sorted(want)
    worst = 0.0
    for k, w in want.items():
        g = np.asarray(got[k], np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape and np.isfinite(g).all(), k
        worst = max(worst, float(np.abs(g - w).max())
                    / (tol * max(float(np.abs(w).max()), 1e-30)))
    return worst


def _adamw(arch, grads: dict) -> dict:
    """The port's one-device AdamW (held to JAX's in
    ``test_torch_train.py``) from the step-0 state on ``grads``."""
    params = load_numpy_params(_tree(arch), "cpu")
    ocfg = topt.OptimizerConfig(**cases.OPT)
    g = tp._unflatten_like(params, {k: torch.from_numpy(v)
                                     for k, v in grads.items()})
    new_p, new_opt, _ = topt.apply_update(
        params, g, topt.init_opt_state(params, ocfg), ocfg)
    return {"params": cases.flat(new_p), "m": cases.flat(new_opt["m"]),
            "v": cases.flat(new_opt["v"])}


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_mesh_step_equals_jax(ranks, name):
    arch, over, mesh = STEP_CASES[name]
    results = ranks[name]
    plan = _plan(arch, over, mesh)
    want_loss, want_grads = _jax_ref(arch, tuple(sorted(over.items())))
    for r in results:
        assert r["loss"] == results[0]["loss"]
        assert r["gnorm"] == results[0]["gnorm"]
        assert abs(r["loss"] - want_loss) <= LOSS_TOL * abs(want_loss)
    # every rank holds its blocks only: each split dim a mesh extent less
    whole = _flat(_tree(arch))
    assert plan.sharded
    for r in results:
        for k, pl in plan.flat.items():
            want = list(whole[k].shape)
            for dim, n in ((pl.data_dim, mesh[0]), (pl.model_dim, mesh[1])):
                if dim is not None:
                    want[dim] //= n
            assert r["params"][k].shape == tuple(want), k
    grads = tp.assemble(plan, [r["grads"] for r in results])
    assert _excess(grads, want_grads, GRAD_TOL) <= 1.0
    adamw = _adamw(arch, grads)
    for field in ("params", "m", "v"):
        got = tp.assemble(plan, [r[field] for r in results])
        assert _excess(got, adamw[field], UPDATE_TOL) <= 1.0, field


def test_dispatch_overflow_crosses_the_data_ranks(ranks):
    """Entry 8 at 2x1: data rank 0's last row overflows an expert's
    capacity in a MoE layer of the plain forward on the whole batch, so
    its overflow lands in data rank 1's first row, slot 0, after the
    all-to-all; the mesh step equals JAX's (``test_mesh_step_equals_jax``
    holds the numbers; here the data's reach)."""
    cfg = cases.family_config(LLAMA, DISPATCH)
    params = load_numpy_params(_tree(LLAMA), "cpu")
    seen = []
    real = tmoe.moe

    def spy(p, x, c):
        seen.append((p, x.detach()))
        return real(p, x, c)
    tmoe.moe = spy
    try:
        with torch.no_grad():
            get_model(cfg).loss(params, {k: torch.from_numpy(v) for k, v
                                         in _batch(LLAMA).items()}, cfg)
    finally:
        tmoe.moe = real
    assert seen
    half = BATCH // 2
    overflow = False
    for p, x in seen:
        rows = x[:half]
        _, idx, _ = tmoe._router(p, rows.reshape(-1, cfg.d_model), cfg)
        _, keep, _, _ = tmoe.routing(idx, half, SEQ, cfg)
        overflow |= bool((~keep[half - 1]).any())
    assert overflow
    assert f"{LLAMA}/dispatch/2x1" in ranks


def test_mesh_recovery_is_bitwise_under_zero3(ranks):
    """nemotron-4-15b at --mesh 2x2: every rank fails at step 3, restores
    its own shard of the step-2 checkpoint and replays, and ends bit for
    bit where the uninterrupted run ends; the checkpoint is the sharded
    format, a shard a rank."""
    for r in ranks["recovery"]:
        clean, fail = r["clean"], r["fail"]
        assert (clean["restarts"], fail["restarts"]) == (0, 1)
        assert clean["history"] == fail["history"]
        for k, v in clean["state"].items():
            assert np.array_equal(v, fail["state"][k]), k
    manifest, _ = ck._read_manifest(str(ranks["tmp"] / "fail"), None)
    assert (manifest["format"], manifest["num_shards"],
            manifest["mesh"]) == ("sharded", 4, [2, 2])
    assert manifest["shard_info"]["opt/m/blocks/l0/mlp/wi"] == {
        "mesh": [2, 2], "data_dim": 1, "model_dim": 2}
    assert manifest["shard_info"]["opt/step"] == "replicated"


def test_mesh_checkpoint_round_trips_and_reads_whole(ranks, tmp_path):
    """The mesh's checkpoint restores on the mesh bit for bit; read whole
    (``checkpoint.restore``'s reassembly) it equals the ranks' blocks put
    together bit for bit and the one-device AdamW on the mesh's gradients
    within the update bar; the converter reads it too."""
    res = ranks["checkpoint"]
    for r in res:
        assert r["step"] == 1
        for k, v in r["state"].items():
            assert np.array_equal(v, r["back"][k]), k
    plan = _plan(NEMO, {}, (2, 2))
    mesh_state = tp.assemble(plan, [r["state"] for r in res])
    src = str(ranks["tmp"] / "ckpt")
    _, whole = ck._load_flat(src, None, True)
    assert sorted(whole) == sorted(mesh_state)
    for k, v in mesh_state.items():
        assert np.array_equal(whole[k].float().numpy(), v), k
    adamw = _adamw(NEMO, tp.assemble(plan, [r["grads"] for r in res]))
    for field in ("params", "m", "v"):
        pre = "params/" if field == "params" else f"opt/{field}/"
        got = {k[len(pre):]: whole[k].float().numpy() for k in whole
               if k.startswith(pre)}
        assert _excess(got, adamw[field], UPDATE_TOL) <= 1.0, field
    out = checkpoint_converter.convert(src, str(tmp_path / "tp2"), tp=2,
                                       arch=NEMO, smoke=True,
                                       prefix="params")
    _, converted = ck._load_flat(str(tmp_path / "tp2"), None, True)
    assert out and sorted(converted) == sorted(whole)
    for k, v in whole.items():
        assert torch.equal(converted[k], v), k
