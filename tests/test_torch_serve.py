"""The port's serve CLI (``python -m repro_torch.launch.serve``) through
``main(argv)`` with ``--device cpu``, against ``repro.launch.serve``: the
listings, what raises (an ``lm_decode`` flag given to another workload,
``--tp 2``, no card), ``lm_decode`` (the default workload, and from a
JAX-written checkpoint) against JAX's CLI counts, each
SoC workload drained, a small ``--field`` spec equal to JAX's CLI run
(outbreak, conservation, read-frame bytes: the step codec is exact), the
``--trace`` and ``--timeseries`` files through JAX's own validators, and a
``--fleet`` spec drained."""
import argparse
import json

import pytest
import torch

import torch_port_util as U
import repro.engine as jengine
from repro.launch import serve as jserve
from repro.obs.export import validate_timeseries
from repro.obs.trace import validate_chrome_trace
from repro_torch.engine import registry as treg
from repro_torch.launch import serve as tserve

FIELD_SPEC = dict(n_devices=2, n_infected=1, host_len=2000, pathogen_len=1000,
                  n_reads=10, min_reads=2, min_abundance=0.01,
                  detect_window=192, max_delay_ticks=2, dup_prob=0.1, seed=3)



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops throughout: one intra-op thread (``U.one_thread``)."""
    with U.one_thread():
        yield

def test_list_workloads_and_presets(capsys):
    assert tserve.main(["--list-workloads"]) is None
    lines = capsys.readouterr().out.split()
    assert lines == treg.workloads()
    assert set(lines) == set(jengine.workloads())
    for workload in ("lm_decode", "basecall", "adaptive_sampling",
                     "pathogen_pipeline"):
        tserve.main(["--list-presets", workload])
        names = [ln.split()[0] for ln in
                 capsys.readouterr().out.strip().splitlines()]
        assert names == sorted(treg.presets(workload))
        assert set(names) <= set(jengine.presets(workload))


@pytest.mark.parametrize("argv", [
    ["--workload", "lm_decode", "--tp", "3", "--device", "cpu", "--smoke"],
    ["--workload", "basecall", "--tp", "2", "--device", "cpu"],
    ["--workload", "basecall", "--ckpt", "/nonexistent", "--device", "cpu"],
    ["--workload", "basecall", "--ckpt-step", "3", "--device", "cpu"],
    ["--workload", "basecall", "--smoke", "--device", "cpu"],
    ["--workload", "basecall", "--arch", "qwen3-4b", "--device", "cpu"],
    ["--workload", "basecall", "--slots", "4", "--device", "cpu"],
    ["--workload", "basecall", "--max-len", "64", "--device", "cpu"],
    ["--workload", "basecall", "--new-tokens", "8", "--device", "cpu"]])
def test_lm_decode_tp_and_ckpt_raise_naming_the_workloads(argv):
    """A flag that only ``lm_decode`` reads, given with another workload,
    raises by its own name and names ``lm_decode``; ``--tp`` over a
    degree the model does not shard over (3: four heads, two KV heads)
    raises naming the fields before any rank starts (``--tp 2`` runs:
    tests/test_torch_tp.py)."""
    if argv[1] == "lm_decode":
        with pytest.raises(ValueError, match="tp=3.*num_heads"):
            tserve.main(argv)
        return
    with pytest.raises(ValueError) as err:
        tserve.main(argv)
    assert argv[2] in str(err.value) and "lm_decode" in str(err.value)


def _jax_cli(argv, capsys):
    """JAX's CLI (``repro.launch.serve.main``) on ``argv`` with
    ``--json``: its drained report."""
    import sys
    old = sys.argv
    sys.argv = ["serve"] + list(argv) + ["--json"]
    try:
        capsys.readouterr()
        jserve.main()
    finally:
        sys.argv = old
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):])


@pytest.fixture(scope="module")
def lm_ckpt(tmp_path_factory):
    """A JAX-written ``full`` checkpoint of the qwen3-4b smoke params."""
    import jax
    from repro.configs import ARCHS as JARCHS
    from repro.models import transformer as jtr
    from repro.train import checkpoint as jck
    d = tmp_path_factory.mktemp("lm_ckpt")
    params, _ = jtr.init(jax.random.key(0), JARCHS["qwen3-4b"].smoke_config())
    jck.save(str(d), params, 5)
    return str(d)


@pytest.mark.parametrize("case", ["default_workload", "lm_decode", "ckpt"])
def test_lm_decode_cli_counts_equal_jax(case, capsys, lm_ckpt):
    """``lm_decode`` through the CLI, as JAX's default workload, named,
    and from a JAX-written checkpoint: the counts JAX's CLI reports on
    the same flags (value-independent with eos -1), and the same fabric
    dispatch keys."""
    argv = ["--smoke", "--requests", "5", "--new-tokens", "3"]
    if case != "default_workload":
        argv = ["--workload", "lm_decode"] + argv
    if case == "ckpt":
        argv += ["--ckpt", lm_ckpt, "--ckpt-step", "5"]
    want = _jax_cli(argv, capsys)
    got = tserve.main(argv + ["--device", "cpu"])
    for k in ("completed", "steps", "dispatches"):
        assert got[k] == want[k], k
    assert got["completed"] == 5 and got["tokens_per_s"] > 0
    assert ({k for k in got if k.startswith("fabric.dispatch.")}
            == {k for k in want if k.startswith("fabric.dispatch.")})
    assert "workload=lm_decode preset=default device=cpu" in \
        capsys.readouterr().out


def test_unknown_preset_raises_naming_the_presets():
    with pytest.raises(ValueError, match="smoke"):
        tserve.main(["--workload", "basecall", "--preset", "nope",
                     "--device", "cpu"])


def test_without_a_card_the_default_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--workload", "basecall", "--preset", "smoke"])


@pytest.mark.parametrize("workload,want", [
    ("basecall", 4), ("adaptive_sampling", 4), ("pathogen_pipeline", 32)])
def test_each_soc_workload_drains(capsys, workload, want):
    rep = tserve.main(["--workload", workload, "--preset", "smoke",
                       "--requests", "4", "--device", "cpu"])
    assert rep["completed"] == want
    assert rep["bases_per_s"] > 0
    out = capsys.readouterr().out
    assert f"workload={workload} preset=smoke device=cpu" in out


def test_trace_and_timeseries_pass_jax_validators(tmp_path, capsys):
    trace, ts = tmp_path / "trace.json", tmp_path / "ts.jsonl"
    rep = tserve.main(["--workload", "adaptive_sampling", "--preset",
                       "smoke", "--requests", "8", "--device", "cpu",
                       "--trace", str(trace), "--timeseries", str(ts),
                       "--interval", "0.001", "--json"])
    assert rep["completed"] == 8
    doc = json.loads(trace.read_text())
    assert validate_chrome_trace(doc) == []
    spans = [e for e in doc["traceEvents"]
             if e.get("ph") == "B" and e.get("name") == "read"]
    assert len(spans) == 8
    assert validate_timeseries(str(ts)) == []
    assert len(ts.read_text().strip().splitlines()) >= 1
    out = capsys.readouterr().out
    assert f"-> {trace}" in out and json.loads(out[out.index("{"):])


def test_profile_dir_writes_a_device_trace(tmp_path):
    tserve.main(["--workload", "basecall", "--preset", "smoke",
                 "--requests", "2", "--device", "cpu", "--profile-dir",
                 str(tmp_path / "prof")])
    assert (tmp_path / "prof" / "device_trace.json").stat().st_size > 0


@pytest.fixture(scope="module")
def field_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_field")
    spec = d / "field.json"
    spec.write_text(json.dumps(FIELD_SPEC))
    port = tserve.main(["--field", str(spec), "--device", "cpu"])
    jax_ = jserve._run_field(argparse.Namespace(field=str(spec), trace=None,
                                                json=False))
    return port, jax_


@pytest.mark.parametrize("key", ["outbreak", "conservation", "ticks"])
def test_field_equals_jax_cli(field_runs, key):
    port, jax_ = field_runs
    assert port[key] == jax_[key]


def test_field_wire_equals_jax_cli(field_runs):
    port, jax_ = field_runs
    for key in ("read_frame_bytes", "raw_signal_bytes_accepted",
                "raw_signal_bytes_sequenced", "frames_duplicated"):
        assert port["wire"][key] == jax_["wire"][key], key
    assert port["outbreak"]["detected"]
    assert port["conservation"]["per_device_exact"]


def test_fleet_spec_drains(tmp_path, capsys):
    spec = {"mesh": "auto", "tenants": [
        {"name": "lab-a", "workload": "adaptive_sampling",
         "preset": "flowcell_smoke", "weight": 2,
         "overrides": {"flowcell": {"encoder": "step", "n_reads": 16,
                                    "read_len": [96, 192]}}},
        {"name": "lab-b", "workload": "basecall", "preset": "smoke",
         "requests": 8},
        {"name": "lab-c", "workload": "pathogen_pipeline",
         "preset": "smoke", "requests": 2}]}
    path = tmp_path / "fleet.json"
    path.write_text(json.dumps(spec))
    trace = tmp_path / "fleet_trace.json"
    rep = tserve.main(["--fleet", str(path), "--device", "cpu", "--trace",
                       str(trace)])
    assert rep["fleet"]["n_tenants"] == 3
    assert rep["tenants"]["lab-a"]["completed"] == 16
    assert rep["tenants"]["lab-b"]["completed"] == 8
    assert rep["tenants"]["lab-c"]["completed"] == 16
    assert validate_chrome_trace(json.loads(trace.read_text())) == []
    assert "fleet: 3 tenants" in capsys.readouterr().out
    lm = {"tenants": [{"name": "lm", "workload": "lm_decode",
                       "preset": "smoke", "requests": 3, "new_tokens": 2}]}
    path.write_text(json.dumps(lm))
    rep = tserve.main(["--fleet", str(path), "--device", "cpu"])
    want = jserve._run_fleet(argparse.Namespace(
        fleet=str(path), seed=0, trace=None, json=False))
    assert rep["tenants"]["lm"]["completed"] == 3
    for k in ("completed", "steps", "dispatches"):
        assert rep["tenants"]["lm"][k] == want["tenants"]["lm"][k], k

