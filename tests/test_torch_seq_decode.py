"""The port's sequence-sharded decode attention (JAX's
``_seq_parallel_decode_attn``) on two gloo ranks against JAX's
single-device ``decode_attention``, on the CPU.

JAX's own bar (``tests/test_mini_dryrun.py:104``): its config, params,
inputs and positions (B 4, S 64, positions 5, 17, 31, 63: both halves of
the cache hold live positions, and one rank's half is wholly masked for
the first rows), the ``kv_seq`` rule set as ``launch/steps.py:45-67`` sets
it, within 2e-5 (rtol and atol) of the unsharded decode.  Each rank holds
half the cache; the rule over ``model`` (a 1x2 mesh), over ``data`` (2x1)
and over both axes (1x2, the world's group).  The token's k and v land
only in the rank that holds its position.

One module fixture starts the two ranks once; they run
``tests/torch_mesh_cases.py::seq_decode``, which imports no JAX.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
import torch_mesh_cases as cases
from repro.models import attention as jattn
from repro.models.config import ModelConfig as JModelConfig
from repro.models.param import ParamBuilder
from repro_torch.distributed import launch
from repro_torch.models import attention as tattn
from repro_torch.models.config import ModelConfig

TOL = 2e-5
CASES = {"model": ((1, 2), "model"), "data": ((2, 1), "data"),
         "both": ((1, 2), ("data", "model"))}


def _inputs():
    """JAX's test inputs, as ``test_mini_dryrun.py:_SP_DECODE`` makes
    them."""
    cfg = JModelConfig(name="t", family="dense", num_layers=1, d_model=64,
                       num_heads=8, num_kv_heads=2, d_ff=128, vocab_size=64,
                       head_dim=16, dtype="float32")
    pb = ParamBuilder(jax.random.key(0), dtype=jnp.float32)
    jattn.init_attention(pb.scope("a"), cfg)
    p = pb.params["a"]
    b, s = 4, 64
    x = jax.random.normal(jax.random.key(1), (b, 1, 64))
    ck = jax.random.normal(jax.random.key(2), (b, s, cfg.kv_dim)) * 0.5
    cv = jax.random.normal(jax.random.key(3), (b, s, cfg.kv_dim)) * 0.5
    pos = jnp.asarray([5, 17, 31, 63])
    return cfg, p, x, ck, cv, pos


@pytest.fixture(scope="module")
def run():
    cfg, p, x, ck, cv, pos = _inputs()
    want, new_k, new_v = jattn.decode_attention(p, x, cfg, ck, cv, pos)
    spec = {"cfg": dataclasses.asdict(cfg),
            "params": {k: np.asarray(v) for k, v in p.items()},
            "x": np.asarray(x), "ck": np.asarray(ck), "cv": np.asarray(cv),
            "pos": np.asarray(pos), "cases": CASES}
    ranks = launch.run(cases.run_jobs, 2,
                       args=({"seq": ("seq_decode", spec)},), threads=1,
                       timeout_s=300)
    return {"ranks": [r["seq"] for r in ranks], "want": np.asarray(want),
            "new_k": np.asarray(new_k), "new_v": np.asarray(new_v),
            "spec": spec}


@pytest.mark.parametrize("case", list(CASES))
def test_seq_sharded_decode_equals_jax(run, case):
    for r in run["ranks"]:
        np.testing.assert_allclose(r[case]["out"], run["want"], rtol=TOL,
                                   atol=TOL)
    assert sorted(r[case]["index"] for r in run["ranks"]) == [0, 1]
    assert {r[case]["n"] for r in run["ranks"]} == {2}


@pytest.mark.parametrize("case", list(CASES))
def test_seq_sharded_cache_write_lands_in_its_rank(run, case):
    """Each rank's half after the write: JAX's updated cache there (the
    written rows within the bar, every other row untouched)."""
    spec = run["spec"]
    for r in run["ranks"]:
        i = r[case]["index"]
        half = slice(32 * i, 32 * (i + 1))
        for name, old, new in (("ck", spec["ck"], run["new_k"]),
                               ("cv", spec["cv"], run["new_v"])):
            got = r[case][name]
            np.testing.assert_allclose(got, new[:, half], rtol=TOL, atol=TOL)
            for row, p in enumerate(spec["pos"]):
                keep = [s for s in range(32) if 32 * i + s != p]
                assert np.array_equal(got[row, keep], old[row, half][keep])


def test_replicated_port_decode_equals_jax(run):
    """The port's unsharded decode on the same inputs, in this process:
    the function the ranks' combine is held beside."""
    spec = run["spec"]
    cfg = ModelConfig(**spec["cfg"])
    p = {k: U.t(v) for k, v in spec["params"].items()}
    with torch.no_grad():
        got, _, _ = tattn.decode_attention(
            p, U.t(spec["x"]), cfg, U.t(spec["ck"]).clone(),
            U.t(spec["cv"]).clone(), U.t(spec["pos"]).long())
    np.testing.assert_allclose(U.n(got), run["want"], rtol=TOL, atol=TOL)
