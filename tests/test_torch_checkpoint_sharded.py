"""The ``sharded`` checkpoint format against the JAX package's, on the
CPU: a JAX sharded checkpoint read by the port and the port's read by JAX,
bit for bit; the port's converter (``python -m
repro_torch.train.checkpoint_converter``) against JAX's
``scripts/checkpoint_converter.py`` on the same JAX ``full`` int8
checkpoint; full -> sharded -> reassembled bit for bit.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import torch_port_util as U
import jax
from repro import quant as jquant
from repro.configs import ARCHS as JARCHS
from repro.models import transformer as jtr
from repro.train import checkpoint as jck
from repro_torch.quant.core import is_quantized
from repro_torch.train import checkpoint as tck
from repro_torch.train import checkpoint_converter as tconv

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")


def _jax_convert():
    sys.path.insert(0, SCRIPTS)
    try:
        from checkpoint_converter import convert
    finally:
        sys.path.remove(SCRIPTS)
    return convert


@pytest.fixture(scope="module")
def full(tmp_path_factory):
    """JAX's ``full`` checkpoint of the int8 qwen3-4b smoke params (and an
    f32 leaf under another key, which replicates)."""
    cfg = dataclasses.replace(JARCHS["qwen3-4b"].smoke_config(),
                              dtype="float32")
    params, _ = jtr.init(jax.random.key(0), cfg)
    qp = jax.device_get(jquant.quantize_params(params, stack_dims=1))
    d = str(tmp_path_factory.mktemp("full"))
    jck.save(d, qp, step=7)
    return d


def _assert_flat_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = U.n(got[k]) if isinstance(got[k], torch.Tensor) else got[k]
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_converter_equals_jax(full, tmp_path):
    """The port's converter and JAX's on the same checkpoint: the same
    manifest (shard_info, keys, per-shard shapes and dtypes) and the same
    arrays in every shard."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_convert()(full, jd, tp=2, arch="qwen3-4b", smoke=True)
    tconv.main(["--src", full, "--dest", td, "--tp", "2", "--arch",
                "qwen3-4b", "--smoke"])
    jm, jshards = jck.read_sharded(jd)
    tm, tshards = tck.read_sharded(td)
    for key in ("shard_info", "keys", "shapes", "dtypes", "num_shards",
                "format", "step"):
        assert tm[key] == jm[key], key
    assert sum(v != "replicated" for v in tm["shard_info"].values()) > 0
    for got, want in zip(tshards, jshards):
        _assert_flat_equal(got, want)


def test_sharded_read_both_ways_bitwise(full, tmp_path):
    """JAX's sharded checkpoint read by the port (per shard and
    reassembled), and the port's read by JAX, each bit for bit."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_convert()(full, jd, tp=2, arch="qwen3-4b", smoke=True)
    tconv.convert(full, td, tp=2, arch="qwen3-4b", smoke=True)
    _, jflat = jck._load_flat(full, None, True)
    for d in (jd, td):
        _, tflat = tck._load_flat(d, None, True)
        _assert_flat_equal(tflat, jflat)
        _, back = jck._load_flat(d, None, True)
        _assert_flat_equal(back, jflat)
        for k in range(2):
            manifest, shard = tck.read_shard(d, k)
            _, jshards = jck.read_sharded(d)
            _assert_flat_equal(shard, jshards[k])
    with open(os.path.join(td, "step_00000007", "manifest.json")) as f:
        assert json.load(f)["format"] == "sharded"


def test_full_sharded_reassembled_round_trip(full, tmp_path):
    """full -> sharded (the port's converter) -> ``load_params``: the
    same QuantizedTensor tree, bit for bit; ``restore`` into a like tree
    too; a checksum mismatch in one shard is refused."""
    td = str(tmp_path / "port")
    tconv.convert(full, td, tp=2, arch="qwen3-4b", smoke=True)
    want, _ = tck.load_params(full, device="cpu")
    got, step = tck.load_params(td, device="cpu")
    assert step == 7
    _assert_flat_equal(dict(tck._flatten(got)),
                       {k: U.n(v) for k, v in tck._flatten(want)})
    wi = got["blocks"]["l0"]["mlp"]["wi"]
    assert is_quantized(wi) and wi.axis == -1
    back, _ = tck.restore(td, want)
    _assert_flat_equal(dict(tck._flatten(back)),
                       {k: U.n(v) for k, v in tck._flatten(want)})
    with open(os.path.join(td, "step_00000007", "shard_1.npz"), "ab") as f:
        f.write(b"\0")
    with pytest.raises(IOError, match="checksum"):
        tck.load_params(td, device="cpu")
    with pytest.raises(ValueError, match="sharded"):
        tck.read_sharded(full)
