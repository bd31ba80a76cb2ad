"""The port's tensor parallelism against JAX's single-device engine, on the
CPU: JAX's four two-device tests (``tests/test_tensor_parallel.py``), each
case run in two gloo ranks of the port.

One module fixture starts the two ranks once (``distributed.launch.run``,
bounded at 300 s; about 8 s of process start-up alone) and runs every
case in them
(``torch_tp_cases.run_cases``); each test reads its part of the result.
The ranks import no JAX: their module is ``tests/torch_tp_cases.py``, and
they report their ``sys.modules``.  JAX's side runs here, in the parent,
on one device (no ``XLA_FLAGS``).

Bars:
- int8 (``quantize_params(stack_dims=1)``): TP 2 equals the port at TP 1
  bit for bit, token for token (JAX's bar for sharded against replicated:
  the int32 accumulators all-reduce exactly); against JAX's engine, token
  for token and within JAX's float32 bar ``allclose(1e-5, 1e-5)``: XLA's
  and PyTorch's CPU ``exp``/``cos``/``sin``/``rsqrt``/``tanh`` and float
  GEMMs round differently, so the float parts of a step cannot match JAX
  bit for bit.
- float32 qwen3-4b: ``allclose(1e-5, 1e-5)`` against JAX and against the
  port at TP 1.  float32 mamba2-780m: token for token, and within the
  port's float32 decode bar against JAX, 1e-4 (``test_torch_lm_decode``):
  at JAX's 1e-5 a logit of step 3 misses by 2e-5 in both comparisons (the
  row-parallel sums reassociate; max |logit| 60).
- the vocab-parallel loss within 1e-5 of JAX's ``loss_fn``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_port_util as U
import jax
import jax.numpy as jnp
import torch_tp_cases as cases
from repro import quant as jquant
from repro.configs import ARCHS as JARCHS
from repro.engine.registry import build as jbuild
from repro.models import transformer as jtr
from repro.models.registry import get_model as jget_model
from repro.train import checkpoint as jck
from repro_torch.distributed import launch
from repro_torch.launch import serve as tserve
from repro_torch.models.param import load_numpy_params
from repro_torch.train import checkpoint as tck
from repro_torch.train.checkpoint_converter import convert

F32 = 1e-5
MAMBA_F32 = 1e-4
DECODE = {"qwen3-4b/int8": ("qwen3-4b", True, 8),
          "qwen3-4b/f32": ("qwen3-4b", False, 8),
          "mamba2-780m/f32": ("mamba2-780m", False, 6)}


def _jcfg(arch):
    return dataclasses.replace(JARCHS[arch].smoke_config(), dtype="float32")


def _jparams(arch, quantized):
    params, _ = jtr.init(jax.random.key(0), _jcfg(arch))
    if quantized:
        params = jquant.quantize_params(params, stack_dims=1)
    return params


def _numpy_tree(tree):
    """A JAX params tree as numpy, quantized weights as the dicts
    ``load_numpy_params`` takes."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return {"q": np.asarray(tree.q), "scale": np.asarray(tree.scale),
                "axis": tree.axis,
                "act_scale": (None if tree.act_scale is None
                              else np.asarray(tree.act_scale))}
    return np.asarray(tree)


def _jax_decode(arch, params, steps):
    """JAX's ``decode_logits`` on its single-device engine."""
    cfg = _jcfg(arch)
    eng = jbuild("lm_decode", model=jget_model(cfg), params=params, cfg=cfg,
                 slots=2, max_len=16)
    toks = np.array([[3], [5]], np.int32)
    pos = np.zeros((2,), np.int32)
    out = []
    for _ in range(steps):
        logits, eng.cache = eng._step(eng.params, eng.cache,
                                      jnp.asarray(toks), jnp.asarray(pos))
        logits = np.asarray(logits)[:, -1]
        out.append(logits)
        pos += 1
        toks = logits.argmax(-1)[:, None].astype(np.int32)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both ranks' results, JAX's and the port's single-device logits."""
    tmp = tmp_path_factory.mktemp("tp")
    jparams = {name: _jparams(arch, q) for name, (arch, q, _) in
               DECODE.items()}
    trees = {name: _numpy_tree(p) for name, p in jparams.items()}
    # the sharded checkpoint: JAX's full int8 one, through the port's
    # converter; and one converted for one rank (the wrong degree)
    full, sharded, wrong = (str(tmp / d) for d in ("full", "tp2", "tp1"))
    jck.save(full, jax.device_get(jparams["qwen3-4b/int8"]), step=7)
    convert(full, sharded, tp=2, arch="qwen3-4b", smoke=True)
    _, flat = tck._load_flat(full, None, True)
    tck.save_sharded(wrong, [flat], 7, shard_info={})
    rs = np.random.RandomState(0)
    batch = {"tokens": rs.randint(0, 256, (2, 8)),
             "labels": rs.randint(0, 256, (2, 8))}
    spec = {"decode": {name: (arch, trees[name], steps)
                       for name, (arch, _, steps) in DECODE.items()},
            "loss_batch": batch,
            "ckpt": {"full": full, "sharded": sharded, "wrong": wrong}}
    ranks = launch.run(cases.run_cases, 2, args=(spec,), threads=2,
                       timeout_s=300)
    with U.one_thread():
        solo = {name: cases.decode_logits(cases.engine(
                    arch, 1, load_numpy_params(trees[name], "cpu")), steps)
                for name, (arch, _, steps) in DECODE.items()}
        ckpt_solo = cases.decode_logits(cases.engine(
            "qwen3-4b", 1, load_numpy_params(trees["qwen3-4b/int8"], "cpu")),
            6)
    jax_logits = {name: _jax_decode(arch, jparams[name], steps)
                  for name, (arch, _, steps) in DECODE.items()}
    jloss, _ = jtr.loss_fn(jparams["qwen3-4b/f32"],
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           _jcfg("qwen3-4b"))
    return {"ranks": ranks, "solo": solo, "ckpt_solo": ckpt_solo,
            "jax": jax_logits, "jax_loss": float(jloss),
            "full_cols": jparams["qwen3-4b/int8"]["blocks"]["l0"]["mlp"][
                "wi"].q.shape[-1]}


def _allclose(want, got, tol):
    return all(np.all(np.abs(a - b) <= tol + tol * np.abs(a))
               for a, b in zip(want, got))


def _tokens(logits):
    return [a.argmax(-1).tolist() for a in logits]


def test_ranks_import_no_jax(run):
    for r, res in enumerate(run["ranks"]):
        assert res["modules"] == [], (r, res["modules"])
        assert res["rank"] == r


def test_int8_tp2_bitwise_against_tp1_and_token_equal_to_jax(run):
    solo, want = run["solo"]["qwen3-4b/int8"], run["jax"]["qwen3-4b/int8"]
    for res in run["ranks"]:
        got = res["qwen3-4b/int8"]
        assert len(got) == 8
        assert all(np.array_equal(a, b) for a, b in zip(solo, got))
        assert _tokens(got) == _tokens(want)
        assert _allclose(want, got, F32)


@pytest.mark.parametrize("name", ["qwen3-4b/f32", "mamba2-780m/f32"])
def test_f32_tp2_close_to_tp1_and_jax(run, name):
    tol = F32 if name.startswith("qwen3") else MAMBA_F32
    solo, want = run["solo"][name], run["jax"][name]
    for res in run["ranks"]:
        got = res[name]
        assert _allclose(solo, got, tol), name
        assert _allclose(want, got, tol), name
        assert _tokens(got) == _tokens(want)
    assert _allclose(want, solo, tol)


def test_vocab_parallel_loss_equals_jax(run):
    for res in run["ranks"]:
        assert abs(res["loss"] - run["jax_loss"]) <= F32, (res["loss"],
                                                           run["jax_loss"])


def test_sharded_checkpoint_loads_pre_partitioned(run):
    """JAX's ``test_sharded_checkpoint_loads_pre_partitioned_two_devices``:
    counted pre-partitioned, each rank holding its half of ``wi``'s columns
    (payload and scales), serving bit for bit; the migration path counted
    ``replicated_slice``; a checkpoint of another degree refused."""
    for res in run["ranks"]:
        assert res["counters"].get("tp.load.pre_partitioned", 0) > 0
        assert res["counters"].get("tp.load.replicated_slice", 0) == 0
        assert res["local_cols"] == run["full_cols"] // 2
        assert res["local_scale_cols"] == run["full_cols"] // 2
        assert all(np.array_equal(a, b)
                   for a, b in zip(run["ckpt_solo"], res["ckpt_logits"]))
        mig = res["migration_counters"]
        assert mig.get("tp.load.replicated_slice", 0) > 0
        assert mig.get("tp.load.pre_partitioned", 0) == 0
        assert "re-run the converter" in res["wrong_tp_error"]


def test_serve_cli_tp2_reports_as_tp1(capfd):
    """``serve --tp 2 --device cpu`` (two ranks, rank 0 prints) reports
    what ``--tp 1`` does: the same requests, steps, dispatches and fabric
    counters."""
    argv = ["--workload", "lm_decode", "--smoke", "--device", "cpu",
            "--requests", "3", "--slots", "2", "--max-len", "16",
            "--new-tokens", "4"]
    with U.one_thread():
        one = tserve.main(argv + ["--tp", "1"])
    capfd.readouterr()
    two = tserve.main(argv + ["--tp", "2"])
    printed = capfd.readouterr().out
    assert printed.count("workload=lm_decode") == 1
    keys = {k for k in one if k.startswith("fabric.")} | {
        "completed", "steps", "dispatches"}
    assert {k: two[k] for k in keys} == {k: one[k] for k in keys}
    assert two["completed"] == 3
