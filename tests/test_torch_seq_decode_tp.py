"""The sequence-sharded decode beside tensor-parallel heads (``kv_seq``
over the model axis) on gloo ranks against JAX's unsharded decode, on the
CPU.

JAX shards a decode's KV sequence over ``model`` under its optimized
rules (``repro/launch/steps.py:59-67``), and over every axis where the
batch is smaller than the data axis (long_500k's B 1,
``repro/launch/steps.py:49-53``), beside heads that its tensor
parallelism splits over ``model``.  The port's rank projects its heads
(column-parallel), all-gathers the token's q, k and v over the model
axis along the heads, caches every KV head for its S / n positions,
combines the ranks' partial attentions by the log-sum-exp
(``attention._seq_parallel_decode_attn``) and cuts the result back to its
heads for the row-parallel ``wo``; jamba's Mamba layers keep their
tensor parallelism.

jamba's f32 smoke config (4 heads, 2 KV heads), seed 0, its attention
cache filled with seeded values (so every rank's positions carry
weight), 8 ``serve_step`` s from position 12 (crossing a rank boundary of
the cache), each feeding back its argmax:

- at 1x2 (``kv_seq`` over model by ``make_rules(opt=True)``, B 2) and 2x2
  (``kv_seq`` over (data, model), B 1: ZeRO-3 and the experts over data)
  the logits are within 1e-5 of JAX's unsharded ``serve_step`` and the
  tokens equal;
- each rank's cache holds S / n positions of all KV heads.

One module fixture starts two ranks and four ranks once each; they run
``tests/torch_mesh_cases.py::seq_decode_tp``, which imports no JAX.
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
from repro.models import transformer as jtr
from repro_torch.distributed import launch

ARCH = "jamba-v0.1-52b"
CASES = {"1x2": ((1, 2), [3, 5]), "2x2": ((2, 2), [7])}
SEQ, STEPS, POS0 = 32, 8, 12
TOL = 1e-5


def _jcfg():
    return dataclasses.replace(JARCHS[ARCH].smoke_config(), dtype="float32")


@functools.lru_cache(maxsize=None)
def _jparams():
    return jtr.init(jax.random.key(0), _jcfg())[0]


@functools.lru_cache(maxsize=None)
def _cache(batch):
    """The attention cache's k and v (num_blocks, attn layers a block, B,
    SEQ, kv_dim), seeded."""
    cfg = _jcfg()
    shape = jax.eval_shape(lambda: jtr.init_cache(cfg, batch, SEQ))["k"].shape
    rng = np.random.default_rng(batch)
    return {k: (0.5 * rng.standard_normal(shape)).astype(np.float32)
            for k in ("k", "v")}


@functools.lru_cache(maxsize=None)
def _jax_decode(case):
    """JAX's unsharded serve_steps: logits by step."""
    cfg = _jcfg()
    toks0 = CASES[case][1]
    b = len(toks0)
    cache = jtr.init_cache(cfg, b, SEQ)
    cache = dict(cache, **{k: jnp.asarray(v) for k, v in _cache(b).items()})
    step = jax.jit(lambda p, c, t, pos: jtr.serve_step(p, c, t, pos, cfg))
    toks = jnp.asarray(toks0, jnp.int32)[:, None]
    out = []
    for t in range(STEPS):
        logits, cache = step(_jparams(), cache, toks,
                             jnp.full((b,), POS0 + t, jnp.int32))
        out.append(np.asarray(logits))
        toks = jnp.argmax(logits, -1).astype(jnp.int32)
    return out


@pytest.fixture(scope="module")
def ranks():
    spec = {"params": jax.tree.map(np.asarray, _jparams()), "steps": STEPS,
            "pos0": POS0}
    got = {}

    def start(world, case):
        s = dict(spec, cases={case: CASES[case]},
                 cache=_cache(len(CASES[case][1])))
        got[world] = launch.run(cases.run_jobs, world, args=(
            {"dec": ("seq_decode_tp", s)},), threads=1, timeout_s=300)
    threads = [threading.Thread(target=start, args=(2, "1x2")),
               threading.Thread(target=start, args=(4, "2x2"))]
    for t in threads:
        t.start()
    for case in CASES:                                 # JAX meanwhile
        _jax_decode(case)
    for t in threads:
        t.join()
    assert set(got) == {2, 4}, "a group of ranks did not finish"
    return {"1x2": [g["dec"]["1x2"] for g in got[2]],
            "2x2": [g["dec"]["2x2"] for g in got[4]]}


@pytest.mark.parametrize("case", list(CASES))
def test_tp_seq_decode_equals_jax(ranks, case):
    want = _jax_decode(case)
    for r in ranks[case]:
        r0, rows = r["rows"]
        for t in range(STEPS):
            np.testing.assert_allclose(r["logits"][t],
                                       want[t][r0:r0 + rows], rtol=TOL,
                                       atol=TOL)
            assert np.array_equal(r["logits"][t].argmax(-1),
                                  want[t][r0:r0 + rows].argmax(-1))


@pytest.mark.parametrize("case", list(CASES))
def test_tp_seq_decode_rules_and_cache(ranks, case):
    """``kv_seq`` spans the model axis (and the data axis where the batch
    is smaller than it); each rank caches S / n positions of all KV heads,
    its own block of them, and Mamba's state at its tensor-parallel
    heads."""
    (d, m), toks0 = CASES[case]
    cfg = cases.config(ARCH)
    n = d * m
    want_axes = ["data", "model"] if len(toks0) < d else ["model"]
    assert sorted(r["index"] for r in ranks[case]) == list(range(n))
    for r in ranks[case]:
        assert r["seq_axes"] == want_axes and r["n"] == n
        rows = r["rows"][1]
        shapes = r["cache_shapes"]
        assert shapes["k"][2:] == [rows, SEQ // n, cfg.kv_dim]
        assert shapes["v"] == shapes["k"]
        assert shapes["ssm"][-3] == rows * cfg.ssm_heads // m   # B x heads
