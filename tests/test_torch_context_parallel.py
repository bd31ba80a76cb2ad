"""Context-parallel attention (JAX's ``act_seq`` over the model axis) on
gloo ranks against JAX's single-device functions, on the CPU.

Where the heads do not divide the model axis, JAX shards the query
sequence over it (``repro/launch/steps.py:54-58``,
``repro/models/attention.py:200-208``).  The config is minicpm-2b's f32
smoke config with 3 heads and 3 KV heads (q_dim 48: JAX's spec splits 1.5
heads a rank at model 2; ``torch_mesh_cases.cp_config``).  At 1x2 and
2x2, at S 32 and at S 33 (which the model axis does not divide: the last
rank's block is padded and cropped), each data rank's rows of

- the first block's attention, causal and not, whole weights, are held
  to JAX's single-device ``attention_block`` within JAX's 1e-5;
- the prefill's last logits to JAX's ``apply`` within 1e-5 of the
  largest |logit| (a whole model's f32 sums reassociate);
- the loss and each gradient leaf, reassembled from the ranks' blocks
  (``tp.assemble`` by the mesh plan under the ``act_seq`` rule), to JAX's
  jitted ``jax.value_and_grad`` with the mesh steps' bars
  (``test_torch_mesh_train.py``): the loss within 1e-5 relative, each
  leaf within 1e-4 of its largest entry.

The plan stores the attention leaves in JAX's even split over model and
gathers them whole at the block's top; the tests check that too.  One
module fixture starts two ranks and four ranks once each (in threads,
JAX's references in the parent meanwhile); the ranks run
``tests/torch_mesh_cases.py::context_parallel``, which imports no JAX.
"""
import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_util as U  # noqa: F401  (torch lazy-module registries)
import torch_mesh_cases as cases
from repro.configs import ARCHS as JARCHS
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro_torch.distributed import launch, tp
from repro_torch.launch.mesh import make_mesh

MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
SEQS = (32, 33)
BATCH = 4
TOL = 1e-5                                   # JAX's forward bar
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4              # test_torch_mesh_train's


def _jcfg():
    return dataclasses.replace(JARCHS["minicpm-2b"].smoke_config(),
                               num_heads=3, num_kv_heads=3, dtype="float32")


@functools.lru_cache(maxsize=None)
def _jparams():
    return jtr.init(jax.random.key(0), _jcfg())[0]


def _tree():
    return jax.tree.map(np.asarray, _jparams())


@functools.lru_cache(maxsize=None)
def _inputs(seq):
    rng = np.random.default_rng(seq)
    cfg = _jcfg()
    x = rng.standard_normal((BATCH, seq, cfg.d_model)).astype(np.float32)
    batch = {k: rng.integers(0, cfg.vocab_size, (BATCH, seq)).astype(
        np.int32) for k in ("tokens", "labels")}
    return x, batch


def _flat_jax(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _jax_ref(seq):
    """JAX's single-device attention (causal and not), last logits, loss
    and ``jax.grad`` on the whole batch."""
    cfg = _jcfg()
    params = _jparams()
    x, batch = _inputs(seq)
    p = jax.tree.map(lambda a: a[0], params["blocks"]["l0"]["attn"])
    pos = jnp.broadcast_to(jnp.arange(seq), (BATCH, seq))
    out = {f"attn/causal={c}": np.asarray(jattn.attention_block(
        p, jnp.asarray(x), cfg, pos, causal=c)) for c in (True, False)}
    logits, _ = jtr.apply(params, jnp.asarray(batch["tokens"]), cfg,
                          last_logits_only=True)
    out["logits"] = np.asarray(logits)
    fn = jax.jit(jax.value_and_grad(lambda p, b: jtr.loss_fn(p, b, cfg)[0]))
    loss, g = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    out.update(loss=float(loss), grads=_flat_jax(g))
    return out


@pytest.fixture(scope="module")
def ranks():
    spec = {"params": _tree(), "meshes": MESHES, "seqs": SEQS,
            "x": {s: _inputs(s)[0] for s in SEQS},
            "batch": {s: _inputs(s)[1] for s in SEQS}}
    got = {}

    def start(world):
        got[world] = launch.run(cases.run_jobs, world, args=(
            {"cp": ("context_parallel", spec)},), threads=1, timeout_s=300)
    threads = [threading.Thread(target=start, args=(w,)) for w in (2, 4)]
    for t in threads:
        t.start()
    for s in SEQS:                                     # JAX meanwhile
        _jax_ref(s)
    for t in threads:
        t.join()
    out = {}
    for world in (2, 4):
        assert world in got, f"the {world} ranks did not finish"
        for key in got[world][0]["cp"]:
            out[key] = [g["cp"][key] for g in got[world]]
    return out


CASES = [f"{m}/{s}" for m in MESHES for s in SEQS]


def _rows(results, field):
    """The data ranks' rows of ``field`` in data order (model rank 0's;
    every model rank holds the same rows)."""
    by_data = {r["coords"][0]: r[field] for r in results
               if r["coords"][1] == 0}
    return np.concatenate([by_data[i] for i in sorted(by_data)], axis=0)


def _plan(mesh):
    d, m = MESHES[mesh]
    cfg = cases.cp_config()
    layout = make_mesh((d, m), ("data", "model"))
    rules = cases.mesh_rules("minicpm-2b", cfg, layout, "train", 32, BATCH)
    return cases._rules_plan("minicpm-2b", cfg, layout, rules)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_context_parallel_attention_equals_jax(ranks, case, causal):
    results = ranks[case]
    assert all(r["rules"]["act_seq"] == "model" for r in results)
    want = _jax_ref(int(case.split("/")[1]))[f"attn/causal={causal}"]
    for r in results:                     # every model rank: whole rows
        d = MESHES[case.split("/")[0]][0]
        rows = BATCH // d
        lo = r["coords"][0] * rows
        np.testing.assert_allclose(r[f"attn/causal={causal}"],
                                   want[lo:lo + rows], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_rows(results, f"attn/causal={causal}"),
                               want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", CASES)
def test_context_parallel_prefill_equals_jax(ranks, case):
    want = _jax_ref(int(case.split("/")[1]))["logits"]
    np.testing.assert_allclose(_rows(ranks[case], "logits"), want, rtol=0,
                               atol=TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("case", CASES)
def test_context_parallel_loss_equals_jax(ranks, case):
    want = _jax_ref(int(case.split("/")[1]))["loss"]
    for r in ranks[case]:
        assert abs(r["loss"] - want) <= LOSS_TOL * abs(want), (r["loss"],
                                                               want)
    assert len({r["loss"] for r in ranks[case]}) == 1


@pytest.mark.parametrize("case", CASES)
def test_context_parallel_grads_equal_jax(ranks, case):
    results = ranks[case]
    plan = _plan(case.split("/")[0])
    got = tp.assemble(plan, [r["grads"] for r in results])
    want = _jax_ref(int(case.split("/")[1]))["grads"]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = np.asarray(got[k], np.float32)
        assert g.shape == w.shape and np.isfinite(g).all(), k
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * max(float(np.abs(w).max()), 1e-30), (k, err)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_attention_leaves_split_evenly_and_gathered_whole(mesh):
    """JAX's spec splits wq/wk/wv's columns and wo's rows evenly over
    model (24 of 48 a rank: 1.5 heads); the layers compute with them
    whole (no slicing rule: ``gather_model``), while the MLP keeps its
    Megatron slice (d_ff 128 / 2)."""
    plan = _plan(mesh)
    for name, dim in (("wq", 2), ("wk", 2), ("wv", 2), ("wo", 1)):
        pl = plan.flat[f"blocks/l0/attn/{name}"]
        assert (pl.model_dim, pl.rule, pl.gather_model) == (dim, None, True)
    pl = plan.flat["blocks/l0/mlp/wi"]
    assert pl.model_dim == 2 and not pl.gather_model
    assert pl.rule == tp.Segments.plain(2, 128)
