"""``python -m repro_torch.launch.train`` on the CPU: JAX's flags and
summary lines, recovery through the CLI equal to an uninterrupted run, a
``--mesh`` run in gloo ranks, and what the launcher refuses (a mesh of
more ranks than the machine starts or one the model cannot split, a
missing card)."""
import os
import subprocess
import sys

import pytest
import torch

import torch_port_util  # noqa: F401  (torch lazy-module registries)
from repro_torch.launch import train as launch_train

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def test_cli_recovers_from_an_injected_failure(tmp_path):
    # one intra-op thread: the suite's workers share the machine's cores
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--smoke", "--steps", "12", "--fail-at", "5", "--ckpt-every", "4",
         "--global-batch", "4", "--seq-len", "32",
         "--ckpt-dir", str(tmp_path / "ckpt")],
        env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.strip().splitlines()
    assert out[-2].startswith("qwen3-4b: 12 steps in ")
    assert "restarts=1, stragglers=" in out[-2]
    assert out[-1].startswith("loss: ") and " -> " in out[-1]
    assert sorted(os.listdir(tmp_path / "ckpt"))[-1] == "step_00000012"


def test_recovery_through_the_launcher_is_bitwise(tmp_path):
    """The same run with and without a failure at step 5: every step's
    loss and the final state equal bit for bit; minicpm-2b gets the wsd
    schedule, the others cosine."""
    argv = ["--device", "cpu", "--smoke", "--steps", "8", "--ckpt-every",
            "3", "--global-batch", "4", "--seq-len", "32"]
    with torch_port_util.one_thread():
        clean = launch_train.main(argv + ["--ckpt-dir",
                                          str(tmp_path / "a")])
        faulty = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "b"),
                                           "--fail-at", "5"])
        minicpm = launch_train.main(["--arch", "minicpm-2b", "--steps", "1",
                                     "--device", "cpu", "--smoke",
                                     "--global-batch", "2", "--seq-len",
                                     "16"])
    assert (clean["restarts"], faulty["restarts"]) == (0, 1)
    assert clean["history"] == faulty["history"]
    assert len(clean["history"]) == 8
    from repro_torch.utils.tree import leaves
    for a, b in zip(leaves(clean["state"]), leaves(faulty["state"])):
        assert torch.equal(a, b)
    assert clean["opt_cfg"].schedule == "cosine"
    assert minicpm["opt_cfg"].schedule == "wsd"


def test_launcher_refuses_what_one_card_cannot_run(monkeypatch):
    # a mesh runs in its ranks (tests/test_torch_mesh_train.py holds their
    # step to JAX's): rank 0's summary and each rank's state digest
    out = launch_train.main(["--device", "cpu", "--smoke", "--mesh", "1x2",
                             "--steps", "2", "--global-batch", "2",
                             "--seq-len", "16"])
    assert out["mesh"] == [1, 2] and sorted(out["history"]) == [0, 1]
    assert out["restarts"] == 0 and out["peak_gb"] is None
    assert "state" not in out and len(set(out["rank_state_sha256"])) == 2
    from repro_torch.distributed import launch
    too_many = f"{launch.max_ranks() + 1}x1"
    with pytest.raises(ValueError, match="ranks asked for"):
        launch_train.main(["--device", "cpu", "--smoke", "--mesh", too_many])
    with pytest.raises(ValueError, match="cannot shard over tp=3"):
        launch_train.main(["--device", "cpu", "--smoke", "--mesh", "1x3"])
    with pytest.raises(ValueError, match="expected DxM"):
        launch_train.main(["--device", "cpu", "--smoke", "--mesh", "2"])
    # every family trains now (tests/test_torch_families_train.py holds
    # them to JAX); what JAX cannot shard is refused as for the others
    with pytest.raises(ValueError, match="cannot shard over tp=3"):
        launch_train.main(["--device", "cpu", "--smoke", "--arch",
                           "internvl2-76b", "--mesh", "1x3"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--smoke", "--steps", "1"])


def test_layers_cuts_the_depth_at_full_width():
    """``--layers N`` trains the arch's config at N layers, widths
    unchanged (the card's full-width runs at a cut depth); a count that
    is not a whole number of block patterns is refused by its name."""
    args = launch_train.parser().parse_args(
        ["--arch", "jamba-v0.1-52b", "--layers", "8"])
    cfg = launch_train._config(args)
    full = launch_train._config(launch_train.parser().parse_args(
        ["--arch", "jamba-v0.1-52b"]))
    assert (cfg.num_layers, cfg.num_blocks) == (8, 1)
    assert (cfg.d_model, cfg.d_ff, cfg.num_experts) == (
        full.d_model, full.d_ff, full.num_experts)
    with pytest.raises(ValueError, match="--layers 4: jamba-v0.1-52b's "
                                         "block pattern is 8 layers"):
        launch_train.main(["--device", "cpu", "--arch", "jamba-v0.1-52b",
                           "--layers", "4"])
    out = launch_train.main(["--device", "cpu", "--smoke", "--layers", "2",
                             "--steps", "1", "--global-batch", "2",
                             "--seq-len", "16"])
    assert sorted(out["history"]) == [0]
