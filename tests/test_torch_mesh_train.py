"""The port's train step over a (data, model) mesh of gloo ranks against
JAX's single-device step, on the CPU.

JAX trains over a mesh with GSPMD: one program, whose result is the
single-device step's (``repro/train/trainer.py:103-126``).  So each mesh
step, at 2x1, 1x2 and 2x2 on the f32 smoke qwen3-4b and mamba2-780m, is
held to JAX's jitted loss on the same numpy params and global batch (the
step's loss at accumulation 1; ``test_torch_lm_train.py`` holds the port's
accumulation to JAX's), with PR 24's bars:

- the loss within 1e-5 (relative) of JAX's;
- the gradients, reassembled from the model ranks' slices
  (``tp.Segments.unslice``), within 1e-4 of their leaf's largest entry of
  JAX's ``jax.grad``;
- the new params and both moments, reassembled, within 1e-6 of their
  leaf's largest entry of JAX's AdamW on those same gradients (against
  JAX's whole step, AdamW's first step moves an entry whose gradient is
  near eps by what rounding decides);
- data replicas bit for bit equal to each other.

Beside them: TP 2's gradients within 1e-4 of TP 1's (the collectives'
backward; the identity-backward psum the port had before parts from them
past that bar), the clip norm at TP 2 equal to TP 1's within 1e-6, and
recovery after ``--fail-at`` on a 2x1 (``full`` checkpoint) and a 1x2
(``sharded``) mesh bit for bit equal to the uninterrupted mesh run.

One module fixture starts two ranks once (2x1, 1x2, the identity-backward
gradients and the recoveries) and four ranks once (2x2, with two
micro-batches a data rank); the ranks run ``tests/torch_mesh_cases.py``,
which imports no JAX.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_util as U
import torch_mesh_cases as cases
from repro.configs import ARCHS as JARCHS
from repro.data import tokens as jtokens
from repro.models import transformer as jtr
from repro.train import optimizer as jopt
from repro_torch.distributed import launch, tp
from repro_torch.models.param import load_numpy_params
from repro_torch.models.registry import get_model
from repro_torch.train import trainer as ttrainer
from repro_torch.utils.tree import tree_global_norm

ARCH_LIST = ["qwen3-4b", "mamba2-780m"]
MESHES = {"2x1": ((2, 1), 1), "1x2": ((1, 2), 1), "2x2": ((2, 2), 2)}
SEQ, BATCH = 64, 4
LOSS_TOL, GRAD_TOL, UPDATE_TOL = 1e-5, 1e-4, 1e-6
RECOVERY = ("2x1", "1x2")


def _jcfg(arch):
    return dataclasses.replace(JARCHS[arch].smoke_config(), dtype="float32")


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return jtr.init(jax.random.key(0), _jcfg(arch))[0]


def _tree(arch):
    return jax.tree.map(np.asarray, _jparams(arch))


def _batch():
    vocab = _jcfg("qwen3-4b").vocab_size
    assert vocab == _jcfg("mamba2-780m").vocab_size
    return jtokens.host_batch_at_step(jtokens.TokenPipelineConfig(
        vocab_size=vocab, seq_len=SEQ, global_batch=BATCH), 0)


def _recovery_argv(mesh, ckpt_dir, fail):
    return (["--device", "cpu", "--smoke", "--steps", "6",
             "--global-batch", "4", "--seq-len", "32", "--ckpt-every", "2",
             "--mesh", mesh, "--ckpt-dir", ckpt_dir]
            + (["--fail-at", "3"] if fail else []))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    batch = _batch()
    trees = {a: _tree(a) for a in ARCH_LIST}
    jobs = {mesh: ("mesh_step", {"mesh": shape, "accum": accum,
                                 "params": trees, "batch": batch})
            for mesh, (shape, accum) in MESHES.items()}
    two = {k: jobs[k] for k in ("2x1", "1x2")}
    for arch in ARCH_LIST:
        two[f"identity/{arch}"] = ("identity_backward_grads",
                                   {"arch": arch, "tree": trees[arch],
                                    "batch": batch})
    runs = {}
    for mesh in RECOVERY:
        for fail in (False, True):
            name = f"{mesh}/{'fail' if fail else 'clean'}"
            runs[name] = _recovery_argv(mesh, str(tmp / name), fail)
    two["recovery"] = ("mesh_recovery", {"runs": runs})
    four = {"2x2": jobs["2x2"]}
    out = {"ranks": {}}
    for jobs in (two, four):
        world = 4 if jobs is four else 2
        got = launch.run(cases.run_jobs, world, args=(jobs,), threads=1,
                         timeout_s=600)
        for name in jobs:
            out["ranks"][name] = [g[name] for g in got]
    out["manifests"] = {}
    for name in runs:
        d = tmp / name
        with open(d / "LATEST") as f:
            latest = f.read().strip()
        with open(d / latest / "manifest.json") as f:
            out["manifests"][name] = json.load(f)
    return out


# ------------------------------------------------------------- references --
@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch):
    """JAX's jitted loss and ``jax.grad`` over the whole global batch (the
    2x2 mesh accumulates two micro-batches a data rank: the same mean)."""
    jcfg = _jcfg(arch)
    fn = jax.jit(jax.value_and_grad(lambda p, b: jtr.loss_fn(p, b, jcfg)[0]))
    loss, g = fn(_jparams(arch),
                 {k: jnp.asarray(v) for k, v in _batch().items()})
    return float(loss), {k: np.asarray(v) for k, v in _flat_jax(g).items()}


def _flat_jax(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _plan(arch, m):
    return cases.plan_for(cases.config(arch), m)


def _assembled(ranks, arch, field, mesh):
    """A field of the mesh's ranks (rank order) reassembled into the full
    flat tree by the mesh plan they hold."""
    d, m = MESHES[mesh][0]
    plan = cases.mesh_plan_for(arch, cases.config(arch), d, m)
    return tp.assemble(plan, [r[arch][field] for r in ranks])


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


def _replicas_equal(ranks, arch):
    """Every rank holds the bits of data rank 0 at its model coordinate."""
    first = {r["coords"][1]: r for r in ranks if r["coords"][0] == 0}
    for r in ranks:
        twin = first[r["coords"][1]]
        for field in ("grads", "params", "m", "v"):
            for k, v in r[arch][field].items():
                if not np.array_equal(v, twin[arch][field][k]):
                    return False
    return True


# ------------------------------------------------------------------ tests --
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_mesh_step_loss_equals_jax(run, arch, mesh):
    ranks = run["ranks"][mesh]
    want = _jax_loss_and_grads(arch)[0]
    for r in ranks:
        got = r[arch]["loss"]
        assert abs(got - want) <= LOSS_TOL * abs(want), (got, want)
        assert r[arch]["step_loss"] == got
    assert len({r[arch]["loss"] for r in ranks}) == 1


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_mesh_step_grads_equal_jax(run, arch, mesh):
    ranks = run["ranks"][mesh]
    got = _assembled(ranks, arch, "grads", mesh)
    assert _excess(got, _jax_loss_and_grads(arch)[1], GRAD_TOL) <= 1.0
    assert _replicas_equal(ranks, arch)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_mesh_step_update_equals_adamw_on_its_grads(run, arch, mesh):
    """The mesh step's new params and moments against JAX's AdamW on the
    mesh's own (reassembled) gradients: the clip norm over the mesh, the
    update of each rank's slice."""
    ranks = run["ranks"][mesh]
    grads = _assembled(ranks, arch, "grads", mesh)
    jp = _jparams(arch)
    ocfg = jopt.OptimizerConfig(**cases.OPT)
    names = list(_flat_jax(jp))
    jgrads = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jp),
        [jnp.asarray(grads[k]) for k in names])
    new_p, new_opt, _ = jax.jit(functools.partial(
        jopt.apply_update, cfg=ocfg))(jp, jgrads,
                                      jopt.init_opt_state(jp, ocfg))
    for field, want in (("params", new_p), ("m", new_opt["m"]),
                        ("v", new_opt["v"])):
        got = _assembled(ranks, arch, field, mesh)
        want = {k: np.asarray(v) for k, v in _flat_jax(want).items()}
        assert _excess(got, want, UPDATE_TOL) <= 1.0, field
    for r in ranks:
        assert r[arch]["step_gnorm"] == r[arch]["gnorm"]


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_tp2_grads_equal_tp1(run, arch):
    """The reassembled TP 2 gradient against the port's own TP 1 one; the
    identity-backward collectives the port had before part from it past
    the bar (the replicated leaves got one rank's share, the column-
    parallel inputs too)."""
    cfg = cases.config(arch)
    params = load_numpy_params(_tree(arch), "cpu")
    batch = {k: U.t(v) for k, v in _batch().items()}
    with U.one_thread():
        _, g1 = ttrainer.loss_and_grads(get_model(cfg).loss, params, batch,
                                        cfg)
    want = cases.flat(g1)
    got = _assembled(run["ranks"]["1x2"], arch, "grads", "1x2")
    assert _excess(got, want, GRAD_TOL) <= 1.0
    plan = _plan(arch, 2)
    old = run["ranks"][f"identity/{arch}"]
    old = {k: (old[0][k] if plan.flat[k] is None
               else plan.flat[k].unslice([o[k] for o in old]))
           for k in old[0]}
    assert _excess(old, want, GRAD_TOL) > 1.0


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_clip_norm_equal_at_tp1_and_tp2(run, arch):
    cfg = cases.config(arch)
    params = load_numpy_params(_tree(arch), "cpu")
    batch = {k: U.t(v) for k, v in _batch().items()}
    with U.one_thread():
        _, g1 = ttrainer.loss_and_grads(get_model(cfg).loss, params, batch,
                                        cfg)
    want = float(tree_global_norm(g1))
    assert want > 1.0     # the clip (clip_norm 1) scales this step
    for r in run["ranks"]["1x2"]:
        assert abs(r[arch]["gnorm"] - want) <= 1e-6 * want
        assert abs(1.0 / r[arch]["gnorm"] - 1.0 / want) <= 1e-6 / want


@pytest.mark.parametrize("mesh", RECOVERY)
def test_mesh_recovery_bitwise(run, mesh):
    """JAX's ``test_recovery_identical_to_uninterrupted`` on a mesh: every
    rank fails at step 3, restores the step-2 checkpoint and replays, and
    ends bit for bit where the uninterrupted mesh run ends."""
    ranks = run["ranks"]["recovery"]
    for r in ranks:
        clean, fail = r[f"{mesh}/clean"], r[f"{mesh}/fail"]
        assert (clean["restarts"], fail["restarts"]) == (0, 1)
        assert clean["history"] == fail["history"]
        assert sorted(clean["history"]) == list(range(6))
        for k, v in clean["state"].items():
            assert np.array_equal(v, fail["state"][k]), k
    manifest = run["manifests"][f"{mesh}/fail"]
    if mesh == "1x2":
        assert (manifest["format"], manifest["num_shards"]) == ("sharded", 2)
        assert manifest["shard_info"]["opt/m/embedding/embed"] != \
            "replicated"
        assert manifest["shard_info"]["opt/step"] == "replicated"
    else:
        assert manifest["format"] == "full"
    assert ranks[0][f"{mesh}/fail"]["ckpt"][-1] == "step_00000006"
