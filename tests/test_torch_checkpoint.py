"""The port's checkpoints (``repro_torch.train.checkpoint``) against
``repro.train.checkpoint`` on the CPU: a JAX ``full`` checkpoint read by the
port bit for bit (f32, bf16, int8 ``QuantizedTensor`` with and without an
act scale, an int32 step), the port's read by JAX, and the layout's own
guarantees: retention, checksums, async writes, LATEST never moving back,
and a JAX sharded checkpoint reassembled."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro import quant as jq
from repro.train import checkpoint as jck
from repro_torch import quant as tq
from repro_torch.core import basecaller as tbc
from repro_torch.train import checkpoint as tck


def _bits(x):
    """A tensor or array as raw integers (bf16 compared bit for bit)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return U.n(x.view(torch.int16))
        return U.n(x)
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _state(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    return {
        "params": {
            "conv1": {"w": rng.normal(size=(5, 1, 8)).astype(np.float32),
                      "b": rng.normal(size=(8,)).astype(np.float32)},
            "embed": rng.normal(size=(7, 3)).astype(np.float32),
            "head": {"w": w}},
        "step": np.int32(17),
    }


def _jax_tree(state):
    t = jax.tree.map(jnp.asarray, state)
    t["params"]["embed"] = t["params"]["embed"].astype(jnp.bfloat16)
    t["params"]["head"]["w"] = jq.quantize_tensor(t["params"]["head"]["w"],
                                                  axis=1, act_scale=0.05)
    t["params"]["conv1"]["w"] = jq.quantize_tensor(t["params"]["conv1"]["w"],
                                                   axis=2)
    return t


def _port_tree(state):
    t = tbc.load_numpy_params(state, device="cpu")
    t["params"]["embed"] = t["params"]["embed"].to(torch.bfloat16)
    t["params"]["head"]["w"] = tq.quantize_tensor(t["params"]["head"]["w"],
                                                  axis=1, act_scale=0.05)
    t["params"]["conv1"]["w"] = tq.quantize_tensor(t["params"]["conv1"]["w"],
                                                   axis=2)
    return t


def _same_qt(got, want):
    assert tq.is_quantized(got) and jq.is_quantized(want)
    for a, b in ((got.q, want.q), (got.scale, want.scale)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert (got.act_scale is None) == (want.act_scale is None)
    if want.act_scale is not None:
        np.testing.assert_array_equal(_bits(got.act_scale),
                                      _bits(want.act_scale))


def test_port_reads_a_jax_checkpoint_bitwise(tmp_path):
    jt = _jax_tree(_state())
    jck.save(str(tmp_path), jt, 100)
    assert tck.latest_step(str(tmp_path)) == 100
    tree, step = tck.load_params(str(tmp_path), device="cpu")
    assert step == 100
    p, jp = tree["params"], jt["params"]
    assert p["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(p["embed"]), _bits(jp["embed"]))
    np.testing.assert_array_equal(_bits(p["conv1"]["b"]),
                                  _bits(jp["conv1"]["b"]))
    _same_qt(p["head"]["w"], jp["head"]["w"])
    _same_qt(p["conv1"]["w"], jp["conv1"]["w"])
    assert p["head"]["w"].axis == -1
    np.testing.assert_array_equal(_bits(tree["step"]), _bits(jt["step"]))
    # restore into a like tree of the port's (structure and dtypes kept)
    like = _port_tree(_state(seed=1))
    got, step = tck.restore(str(tmp_path), like)
    assert step == 100
    _same_qt(got["params"]["head"]["w"], jp["head"]["w"])
    np.testing.assert_array_equal(_bits(got["params"]["embed"]),
                                  _bits(jp["embed"]))


def test_jax_reads_a_port_checkpoint_bitwise(tmp_path):
    pt = _port_tree(_state(seed=2))
    path = tck.save(str(tmp_path), pt, 7)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    jt = _jax_tree(_state(seed=2))
    want_keys, _ = jck._flatten(jt)
    assert manifest["keys"] == sorted(k for k, _ in want_keys)
    assert manifest["dtypes"]["params/embed"] == "bfloat16"
    tree, step = jck.load_params(str(tmp_path))
    assert step == 7
    p, tp = tree["params"], pt["params"]
    np.testing.assert_array_equal(_bits(p["embed"]), _bits(tp["embed"]))
    _same_qt(tp["head"]["w"], p["head"]["w"])
    _same_qt(tp["conv1"]["w"], p["conv1"]["w"])
    restored, _ = jck.restore(str(tmp_path), jt)
    np.testing.assert_array_equal(
        _bits(restored["params"]["head"]["w"].q), _bits(tp["head"]["w"].q))


def test_retention_latest_and_corruption(tmp_path):
    d = str(tmp_path)
    tree = _port_tree(_state())
    for step in (1, 2, 3, 4, 5):
        tck.save(d, tree, step, keep_last=2)
    assert sorted(x for x in os.listdir(d) if x.startswith("step_")) == [
        "step_00000004", "step_00000005"]
    # an older step written late does not move LATEST back
    tck.save(d, tree, 3, keep_last=5)
    assert tck.latest_step(d) == 5
    arrays = os.path.join(d, "step_00000005", "arrays.npz")
    raw = bytearray(open(arrays, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    with open(arrays, "wb") as f:
        f.write(raw)
    with pytest.raises(IOError, match="checksum"):
        tck.load_params(d, device="cpu")
    with pytest.raises(IOError, match="checksum"):
        jck.load_params(d)
    got, step = tck.load_params(d, step=4, device="cpu")
    assert step == 4
    with pytest.raises(FileNotFoundError):
        tck.load_params(str(tmp_path / "empty"), device="cpu")


def test_save_async_snapshots_before_returning(tmp_path):
    """The tree is copied when save_async returns: a later in-place update
    does not reach the file."""
    d = str(tmp_path)
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    threads = [tck.save_async(d, {"w": w, "b": w[0] * 2}, s) for s in
               (10, 11)]
    w.add_(100.0)
    tck.wait_pending()
    assert not any(t.is_alive() for t in threads)
    got, step = tck.load_params(d, device="cpu")
    assert step == 11
    np.testing.assert_array_equal(U.n(got["w"]),
                                  np.arange(12, dtype=np.float32).reshape(3, 4))
    back, _ = tck.restore(d, {"w": torch.zeros(3, 4), "b": torch.zeros(4)},
                          step=10)
    np.testing.assert_array_equal(U.n(back["b"]),
                                  np.arange(4, dtype=np.float32) * 2)
    with pytest.raises(ValueError, match="shape"):
        tck.restore(d, {"w": torch.zeros(4, 3), "b": torch.zeros(4)})


def test_sharded_checkpoint_is_refused(tmp_path):
    """JAX's sharded layout is ported (tests/test_torch_checkpoint_sharded.py):
    a sharded checkpoint reassembles as JAX's does, and one whose shard
    fails its checksum, or that is read where a full one is wanted, is
    refused."""
    d = str(tmp_path)
    a = np.arange(8, dtype=np.float32)
    jck.save_sharded(d, [{"w": a[:4]}, {"w": a[4:]}], 3,
                     shard_info={"w": {"dim": 0, "parts": [[8, True]]}})
    got, step = tck.load_params(d, device="cpu")
    assert step == 3
    np.testing.assert_array_equal(U.n(got["w"]), a)
    back, _ = tck.restore(d, {"w": torch.zeros(8)})
    np.testing.assert_array_equal(U.n(back["w"]), a)
    full = str(tmp_path / "full")
    jck.save(full, {"w": a}, 1)
    with pytest.raises(ValueError, match="sharded"):
        tck.read_sharded(full)
    with open(os.path.join(d, "step_00000003", "shard_0.npz"), "ab") as f:
        f.write(b"\0")
    with pytest.raises(IOError, match="checksum"):
        tck.load_params(d, device="cpu")
