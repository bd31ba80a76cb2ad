"""Training the MoE, hybrid, VLM and encoder-decoder families in the port
against JAX's single-device step, on the CPU: one device, and a (data,
model) mesh of gloo ranks.

The f32 smoke configs of grok-1-314b, llama4-maverick-400b-a17b and
jamba-v0.1-52b (their ``dense`` MoE, and ``dispatch`` at capacity factor
0.5, which drops tokens), internvl2-76b (with patch embeddings) and
whisper-medium (frames, and a decoder of ``seq // 8`` tokens): one numpy
tree of params (the port's ``init`` from a seed) read by both packages,
the batch from numpy seeds, JAX's side under ``jax.jit``.  The bars of
``test_torch_lm_train.py`` and ``test_torch_mesh_train.py``:

- the loss within 1e-5 (relative) of JAX's ``loss_fn``;
- the gradients within 1e-4 of their leaf's largest entry of JAX's
  ``jax.grad`` (on a mesh: reassembled from the model ranks' slices);
- the new params and both moments within 1e-6 of their leaf's largest
  entry of AdamW on the port's own gradients (the port's one-device
  ``optimizer.apply_update``, see ``_adamw``);
- ``moe_aux`` (the step's metric) within 1e-5 of JAX's.

The mesh steps (``jit_train_step``, one start of two ranks from a module
fixture; their side is ``tests/torch_mesh_cases.py``, no JAX) are held to
the same single-device references: the MoE archs at 2x1 with dispatch at
0.5, which crosses both places where JAX's step computes over the global
batch (the router's load-balance statistics, and the last row's overflow
into the next row, which is the next data rank's), grok-1's also with
two micro-batches (JAX splits the global batch first, then shards each
micro-batch over data); grok-1 dense at 2x1;
grok-1 dispatch and jamba at 1x2 (the replicated experts' gradients
summed over the model ranks); whisper at 1x2; internvl2 at 2x1 and 1x2
(its patch embeddings replace rows after the vocab-parallel embedding's
all-reduce, never added once a rank).  The
test also shows that its data exercise both traps, from the plain
functions: each data half's router statistics differ from the whole
batch's, and data rank 0's last row overflows an expert's capacity.

Beside them, the launcher: ``launch.train --smoke --steps 2`` for each
of the ten archs, the five families also at a ``--mesh`` of two ranks
(``LAUNCH_MESH``, in the ranks), a vlm sequence its patch embeddings
fill refused, and recovery after ``--fail-at 1`` bit for bit for an MoE
arch.
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
from repro.configs import ARCHS as JARCHS
from repro.models import encdec as jed
from repro.models import transformer as jtr
from repro_torch.configs import ARCHS
from repro_torch.distributed import launch, tp
from repro_torch.launch import train as launch_train
from repro_torch.models import moe as tmoe
from repro_torch.models.param import load_numpy_params
from repro_torch.models.registry import get_model
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer
from repro_torch.utils.tree import leaves

FAMILIES = ["grok-1-314b", "llama4-maverick-400b-a17b", "jamba-v0.1-52b",
            "internvl2-76b", "whisper-medium"]
MOE = FAMILIES[:3]
DISPATCH = {"moe_impl": "dispatch", "moe_capacity_factor": 0.5}
STEPS = [(a, "dense") for a in FAMILIES] + [(a, "dispatch") for a in MOE]
# name: (arch, MoE impl, (data, model), micro-batches)
MESH = {f"{a}/dispatch/2x1": (a, "dispatch", (2, 1), 1) for a in MOE}
MESH.update({
    "grok-1-314b/dispatch/2x1/accum2": ("grok-1-314b", "dispatch", (2, 1),
                                        2),
    "grok-1-314b/dense/2x1": ("grok-1-314b", "dense", (2, 1), 1),
    "grok-1-314b/dispatch/1x2": ("grok-1-314b", "dispatch", (1, 2), 1),
    "jamba-v0.1-52b/dense/1x2": ("jamba-v0.1-52b", "dense", (1, 2), 1),
    "whisper-medium/dense/1x2": ("whisper-medium", "dense", (1, 2), 1),
    "internvl2-76b/dense/2x1": ("internvl2-76b", "dense", (2, 1), 1),
    "internvl2-76b/dense/1x2": ("internvl2-76b", "dense", (1, 2), 1)})
SEQ, BATCH = 32, 4
LOSS_TOL, GRAD_TOL, UPDATE_TOL = 1e-5, 1e-4, 1e-6
LAUNCH = ["--device", "cpu", "--smoke", "--steps", "2", "--global-batch",
          "2", "--seq-len", "32"]
LAUNCH_MESH = {"grok-1-314b": "2x1", "llama4-maverick-400b-a17b": "1x2",
               "jamba-v0.1-52b": "2x1", "internvl2-76b": "1x2",
               "whisper-medium": "1x2"}


def _over(impl):
    return DISPATCH if impl == "dispatch" else {}


def _jcfg(arch, impl="dense"):
    return dataclasses.replace(JARCHS[arch].smoke_config(), dtype="float32",
                               **_over(impl))


def _jmod(arch):
    return jed if JARCHS[arch].smoke_config().family == "encdec" else jtr


@functools.lru_cache(maxsize=None)
def _tree(arch):
    """The params as numpy: the port's ``init`` from seed 0 (JAX's own
    ``init`` takes seconds a model on the CPU; both packages read the same
    tree)."""
    cfg = cases.config(arch)
    params, _ = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
    return cases.flat(params)


def _nested(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *head, last = key.split("/")
        for name in head:
            node = node.setdefault(name, {})
        node[last] = v
    return out


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return jax.tree.map(jnp.asarray, _nested(_tree(arch)))


@functools.lru_cache(maxsize=None)
def _batch(arch):
    """The global batch: tokens and labels (B, S); internvl2 adds patch
    embeddings, whisper takes frames (B, S, d) and S // 8 tokens."""
    cfg = _jcfg(arch)
    rng = np.random.default_rng(11)
    s = SEQ // 8 if cfg.family == "encdec" else SEQ
    out = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, s)).astype(
        np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (BATCH, s)).astype(
            np.int32)}
    if cfg.family == "vlm":
        out["input_embeds"] = rng.standard_normal(
            (BATCH, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (BATCH, SEQ, cfg.d_model)).astype(np.float32)
    return out


def _flat_jax(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _jax_ref(arch, impl, accum=1):
    """JAX's jitted loss, ``moe_aux`` and ``jax.grad`` on the global
    batch; with ``accum`` micro-batches (JAX's ``_split_micro``: global
    rows ``i * B / accum`` on) each one's, averaged, as JAX's scan."""
    cfg = _jcfg(arch, impl)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: _jmod(arch).loss_fn(p, b, cfg), has_aux=True))
    rows = BATCH // accum
    out = [fn(_jparams(arch), {k: jnp.asarray(v[i * rows:(i + 1) * rows])
                               for k, v in _batch(arch).items()})
           for i in range(accum)]
    loss = sum(float(lo) for (lo, _), _ in out) / accum
    moe_aux = [aux.get("moe_aux") for (_, aux), _ in out]
    grads = [_flat_jax(g) for _, g in out]
    return (loss, None if moe_aux[0] is None
            else sum(float(a) for a in moe_aux) / accum,
            {k: sum(g[k] for g in grads) / accum for k in grads[0]})


def _adamw(arch, grads: dict) -> dict:
    """AdamW from the step-0 state on ``grads`` (flat): the port's
    out-of-place ``optimizer.apply_update`` (held to JAX's in
    ``test_torch_train.py``), the new params and moments, flat.  JAX's
    own AdamW is not the reference here: its float32 global norm of these
    gradients sits up to 1.9e-6 (relative) off the exact one (grok-1's),
    which scales every moment by as much, past the 1e-6 bar."""
    params = load_numpy_params(_nested(_tree(arch)), "cpu")
    ocfg = topt.OptimizerConfig(**cases.OPT)
    order = list(cases.flat(params))
    g = tp._unflatten_like(params, {k: torch.from_numpy(grads[k])
                                     for k in order})
    new_p, new_opt, _ = topt.apply_update(
        params, g, topt.init_opt_state(params, ocfg), ocfg)
    return {"params": cases.flat(new_p), "m": cases.flat(new_opt["m"]),
            "v": cases.flat(new_opt["v"])}


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


def _hold(arch, impl, loss, moe_aux, grads, state, accum=1):
    """Loss, aux, gradients and update against JAX by the module's bars."""
    want_loss, want_aux, want_grads = _jax_ref(arch, impl, accum)
    assert abs(loss - want_loss) <= LOSS_TOL * abs(want_loss), (loss,
                                                               want_loss)
    if want_aux is None:
        assert moe_aux is None
    else:
        assert want_aux > 0 or not JARCHS[arch].smoke_config().num_experts
        assert abs(moe_aux - want_aux) <= LOSS_TOL * want_aux, (moe_aux,
                                                                want_aux)
    assert _excess(grads, want_grads, GRAD_TOL) <= 1.0
    adamw = _adamw(arch, grads)
    for field in ("params", "m", "v"):
        assert _excess(state[field], adamw[field], UPDATE_TOL) <= 1.0, field


# ----------------------------------------------------------- one device --
@pytest.mark.parametrize("arch,impl", STEPS)
def test_train_step_equals_jax(arch, impl):
    cfg = cases.family_config(arch, _over(impl))
    model = get_model(cfg)
    ocfg = topt.OptimizerConfig(**cases.OPT)
    params = load_numpy_params(_nested(_tree(arch)), "cpu")
    batch = {k: U.t(v) for k, v in _batch(arch).items()}
    with U.one_thread():
        (_, _), grads = ttrainer.loss_and_grads(model.loss, params, batch,
                                                cfg)
        step = ttrainer.make_train_step(model.loss, cfg, ocfg)
        new, metrics = step({"params": params,
                             "opt": topt.init_opt_state(params, ocfg)},
                            batch)
    aux = metrics.get("moe_aux")
    _hold(arch, impl, float(metrics["loss"]),
          None if aux is None else float(aux), cases.flat(grads),
          {"params": cases.flat(new["params"]),
           "m": cases.flat(new["opt"]["m"]), "v": cases.flat(new["opt"]["v"])})


# ---------------------------------------------------------------- mesh --
@pytest.fixture(scope="module")
def ranks():
    spec = {"cases": {name: (arch, _over(impl), shape, accum)
                      for name, (arch, impl, shape, accum) in MESH.items()},
            "params": {a: _nested(_tree(a)) for a in FAMILIES},
            "batches": {a: _batch(a) for a in FAMILIES}}
    runs = {a: LAUNCH + ["--arch", a, "--mesh", m]
            for a, m in LAUNCH_MESH.items()}
    jobs = {"steps": ("family_mesh_step", spec),
            "launch": ("family_launch", runs)}
    got = launch.run(cases.run_jobs, 2, args=(jobs,), threads=1,
                     timeout_s=600)
    return {name: [g[name] for g in got] for name in jobs}


def _assembled(results, name, field):
    """A field of the ranks' blocks (rank order) as the whole flat tree,
    by the mesh plan they hold (JAX's specs: ZeRO-3, experts over data)."""
    arch, impl, (d, m), _ = MESH[name]
    plan = cases.mesh_plan_for(arch, cases.family_config(arch, _over(impl)),
                               d, m)
    return tp.assemble(plan, [r[field] for r in results])


@pytest.mark.parametrize("name", list(MESH))
def test_mesh_step_equals_jax(ranks, name):
    arch, impl, _, accum = MESH[name]
    results = [r[name] for r in ranks["steps"]]
    for r in results:
        assert r["loss"] == results[0]["loss"]
        assert r["moe_aux"] == results[0]["moe_aux"]
        assert r["gnorm"] == results[0]["gnorm"]
    _hold(arch, impl, results[0]["loss"], results[0]["moe_aux"],
          _assembled(results, name, "grads"),
          {f: _assembled(results, name, f) for f in ("params", "m", "v")},
          accum)


def _moe_inputs(arch, impl):
    """The input of every MoE layer of the port's plain forward on the
    whole batch (a wrapper around ``moe.moe`` records them)."""
    cfg = cases.family_config(arch, _over(impl))
    params = load_numpy_params(_nested(_tree(arch)), "cpu")
    seen = []
    real = tmoe.moe

    def spy(p, x, c):
        seen.append((p, x.detach()))
        return real(p, x, c)
    tmoe.moe = spy
    try:
        with torch.no_grad():
            get_model(cfg).loss(params, {k: U.t(v) for k, v in
                                         _batch(arch).items()}, cfg)
    finally:
        tmoe.moe = real
    return cfg, seen


def _stats(p, x, cfg):
    """The router's load-balance statistics of ``x`` (B, S, d): the mean
    probability ``me`` and routed share ``ce`` of each expert, and the
    chosen experts (B * S, k)."""
    probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ p["router"],
                          dim=-1)
    _, idx = tmoe.top_k(probs, cfg.experts_per_token)
    ce = torch.bincount(idx.reshape(-1), minlength=cfg.num_experts).float()
    return probs.mean(0), ce / idx.numel(), idx


@pytest.mark.parametrize("arch", MOE)
def test_dispatch_batch_exercises_both_data_traps(arch):
    """On the 2x1 dispatch case's data: (1) the product of each data
    half's router means is not the whole batch's (so per-rank aux,
    averaged, would miss JAX's); (2) data rank 0's last row overflows an
    expert's capacity (JAX adds that token into data rank 1's first
    row)."""
    cfg, seen = _moe_inputs(arch, "dispatch")
    assert seen
    half = BATCH // 2
    aux_gap, overflow = 0.0, 0
    for p, x in seen:
        me, ce, _ = _stats(p, x, cfg)
        whole = cfg.num_experts * float((me * ce).sum())
        per_rank = np.mean([cfg.num_experts * float((m * c).sum())
                            for m, c, _ in (_stats(p, x[:half], cfg),
                                            _stats(p, x[half:], cfg))])
        aux_gap = max(aux_gap, abs(per_rank - whole) / whole)
        _, _, idx = _stats(p, x[:half], cfg)
        _, keep, _, _ = tmoe.routing(idx, half, x.shape[1], cfg)
        overflow += int((~keep[-1]).sum())
    assert aux_gap > 10 * LOSS_TOL
    assert overflow > 0


# ------------------------------------------------------------ launcher --
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_launcher_trains_every_arch(arch):
    with U.one_thread():
        out = launch_train.main(LAUNCH + ["--arch", arch])
    losses = [out["history"][s] for s in sorted(out["history"])]
    assert len(losses) == 2 and np.isfinite(losses).all()


@pytest.mark.parametrize("arch", FAMILIES)
def test_launcher_trains_every_family_on_a_mesh(ranks, arch):
    losses = [r[arch] for r in ranks["launch"]]
    assert losses[0] == losses[1]
    assert len(losses[0]) == 2 and np.isfinite(losses[0]).all()


def test_launcher_refuses_a_vlm_sequence_its_patches_fill():
    """internvl2-76b's 256 patch embeddings take the first positions of a
    row: ``--seq-len 128`` is refused before any param is drawn (JAX's
    launcher fails on a shape mismatch in RoPE)."""
    with pytest.raises(ValueError, match="256 patch embeddings"):
        launch_train.main(["--device", "cpu", "--arch", "internvl2-76b",
                           "--steps", "1"])


def test_launcher_trains_a_vlm_sequence_its_patches_just_fill():
    """A ``--seq-len`` equal to the patch embeddings' count (the smoke
    internvl2's 8) trains, as JAX's launcher does; one fewer is
    refused."""
    argv = ["--device", "cpu", "--smoke", "--steps", "1", "--global-batch",
            "2", "--arch", "internvl2-76b"]
    with U.one_thread():
        out = launch_train.main(argv + ["--seq-len", "8"])
    assert np.isfinite(list(out["history"].values())).all()
    with pytest.raises(ValueError, match="8 patch embeddings"):
        launch_train.main(argv + ["--seq-len", "7"])


def test_data_ctx_takes_the_data_group_by_name():
    """``tp.data_ctx`` has no default group: at two or more data ranks a
    missing group is refused (``psum(x, None)`` would reduce over the
    model group); at one it is the identity."""
    x = torch.arange(3.0)
    with pytest.raises(TypeError):
        tp.data_ctx(2)
    with pytest.raises(ValueError, match="data group"):
        with tp.data_ctx(2, None):
            pass
    with tp.data_ctx(1, None):
        assert tp.data_extent() == 1
        assert tp.data_mean(x) is x


def test_launcher_recovery_is_bitwise_for_moe(tmp_path):
    argv = ["--device", "cpu", "--smoke", "--steps", "3", "--global-batch",
            "2", "--seq-len", "32", "--arch", "llama4-maverick-400b-a17b",
            "--ckpt-every", "1"]
    with U.one_thread():
        clean = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
        faulty = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "b"),
                                           "--fail-at", "1"])
    assert (clean["restarts"], faulty["restarts"]) == (0, 1)
    assert clean["history"] == faulty["history"]
    for a, b in zip(leaves(clean["state"]), leaves(faulty["state"])):
        assert torch.equal(a, b)
