"""Failure injection -> checkpoint/restore -> bitwise-identical recovery,
on the port (``repro_torch.train.fault_tolerance``): the six tests of
tests/test_fault_tolerance.py, on the CPU (plain versions)."""
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro_torch.data import tokens
from repro_torch.train import fault_tolerance as ft
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer
from repro_torch.utils.tree import tree_map


def make_setup(donate=True):
    """``(step, state, batch_fn)``; the step updates the state in place,
    so with ``donate=False`` it clones the state first (what a caller
    that keeps the old state does)."""
    cfg = opt.OptimizerConfig(lr=1e-2, warmup_steps=0, schedule="constant",
                              weight_decay=0, clip_norm=0)

    def loss_fn(params, batch, _cfg):
        pred = batch["x"] @ params["w"]
        return torch.mean(torch.square(pred - batch["y"])), {}

    in_place = trainer.make_train_step(loss_fn, None, cfg)

    def step(state, batch):
        return in_place(state if donate else tree_map(torch.clone, state),
                        batch)

    params = {"w": torch.ones((6, 3)) * 0.3}
    state = {"params": params, "opt": opt.init_opt_state(params, cfg)}

    def batch_fn(i):
        g = torch.Generator().manual_seed(i)   # step-addressable data
        return {"x": torch.randn((8, 6), generator=g),
                "y": torch.randn((8, 3), generator=g)}

    return step, state, batch_fn


@pytest.mark.parametrize("donate", [False, True])
def test_recovery_identical_to_uninterrupted(tmp_path, donate):
    step, state0, batch_fn = make_setup(donate)
    clean_dir = str(tmp_path / "clean")
    state_a, hist_a, r_a = ft.run_resilient(
        step, tree_map(torch.clone, state0), batch_fn, n_steps=30,
        ckpt_dir=clean_dir, ckpt_every=5)
    assert r_a == 0

    fail_dir = str(tmp_path / "faulty")
    inj = ft.FailureInjector(fail_at_steps=(7, 18))
    state_b, hist_b, r_b = ft.run_resilient(
        step, tree_map(torch.clone, state0), batch_fn, n_steps=30,
        ckpt_dir=fail_dir, ckpt_every=5, injector=inj)
    assert r_b == 2
    # loss at every step matches the uninterrupted run exactly
    assert sorted(hist_a) == sorted(hist_b) == list(range(30))
    for s in hist_a:
        assert hist_a[s] == hist_b[s], s
    assert torch.equal(state_a["params"]["w"], state_b["params"]["w"])


def test_nan_loss_triggers_rollback(tmp_path):
    step, state0, batch_fn = make_setup()
    inj = ft.FailureInjector(nan_at_steps=(12,))
    state, hist, restarts = ft.run_resilient(
        step, state0, batch_fn, n_steps=20,
        ckpt_dir=str(tmp_path), ckpt_every=4, injector=inj)
    assert restarts == 1
    assert len(hist) >= 20 - 1 and np.isfinite(list(hist.values())).all()


def test_failure_without_checkpoint_raises(tmp_path):
    step, state0, batch_fn = make_setup()
    inj = ft.FailureInjector(fail_at_steps=(2,))
    with pytest.raises(ft.SimulatedFailure):
        ft.run_resilient(step, state0, batch_fn, n_steps=10,
                         ckpt_dir=str(tmp_path / "empty"), ckpt_every=100,
                         injector=inj)


def test_straggler_monitor_flags_outliers():
    mon = ft.StragglerMonitor(factor=3.0)
    for _ in range(16):
        mon.record(0.01)
    assert not mon.record(0.02)
    assert mon.record(0.1)
    assert mon.flagged == 1


def test_elastic_remesh_same_device():
    """State re-places onto a one-device mesh (None, 1 or "auto"); a
    larger mesh raises: the port runs on one card."""
    params = {"w": torch.ones((4, 4))}
    state = {"params": params,
             "opt": {"m": params, "v": params,
                     "step": torch.zeros((), dtype=torch.int32)}}
    axes = {"w": ("embed", "mlp")}
    for mesh in (None, 1, "auto"):
        out = ft.elastic_remesh(state, mesh, {}, axes, state)
        assert torch.equal(out["params"]["w"], state["params"]["w"])
        assert out["opt"]["step"].dtype == torch.int32
    with pytest.raises(ValueError, match="one card"):
        ft.elastic_remesh(state, 2, {}, axes, state)
    assert trainer._pad_axes(trainer.state_axes(axes), state) == {
        "params": axes, "opt": {"m": axes, "v": axes, "step": ()}}


def test_data_pipeline_determinism():
    cfg = tokens.TokenPipelineConfig(vocab_size=100, seq_len=16,
                                     global_batch=8, seed=3)
    a = tokens.host_batch_at_step(cfg, 5)
    b = tokens.host_batch_at_step(cfg, 5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = tokens.host_batch_at_step(cfg, 6)
    assert not np.array_equal(a["tokens"], c["tokens"])
    # shard-local generation: different shards differ
    s0 = tokens.host_batch_at_step(cfg, 5, shard=0, num_shards=2)
    s1 = tokens.host_batch_at_step(cfg, 5, shard=1, num_shards=2)
    assert not np.array_equal(s0["tokens"], s1["tokens"])
    assert s0["tokens"].shape == (4, 16)
    # labels are next-token shifted
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert U.n(torch.from_numpy(a["labels"])).dtype == np.int32
