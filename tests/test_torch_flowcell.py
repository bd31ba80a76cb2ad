"""The port's Read-Until flowcell engine against the JAX engine on the CPU.

The step-encoder flowcell decodes exactly, so its per-read goldens
``(read_id, decision, reason, bases_at_decision, mapped_pos)`` compare
bitwise across frameworks: the port, fused and unfused at pipeline depth 1
and 2 and with one lane, must reproduce the JAX engine's goldens read for
read (the JAX suite pins its own configurations equal to each other,
tests/test_flowcell.py)."""
import numpy as np
import pytest
import torch

import torch_port_util as U
import repro.engine as jengine
import repro_torch.engine as tengine
from repro.data import flowcell as jfc
from repro.data import genome as jG
from repro.realtime import Decision as JDecision
from repro.realtime import PolicyConfig as JPolicy
from repro_torch.data import flowcell as tfc
from repro_torch.realtime import Decision as TDecision
from repro_torch.realtime import PolicyConfig as TPolicy

SEED = 3
GENOME_LEN = 6_000
FLOWCELL = {"encoder": "step", "n_reads": 24, "read_len": (64, 128),
            "recovery_samples": 64, "stagger_samples": 16, "seed": SEED}


def _reference():
    return jG.random_genome(np.random.default_rng(7), GENOME_LEN)


def _policy(cls, decision):
    return cls(min_prefix_bases=24, map_prefix_bases=32, max_prefix_bases=96,
               min_mapq=4.0, timeout_decision=decision.ACCEPT,
               eject_latency_samples=32)


def _jax_engine(lanes):
    return jengine.build(
        "adaptive_sampling", channels=lanes, chunk=64,
        reference=_reference(), targets=[(0, GENOME_LEN // 2)],
        flowcell=dict(FLOWCELL), policy=_policy(JPolicy, JDecision),
        fabric="reference")


def _port_engine(lanes, *, pipeline_depth=1, fused=False):
    return tengine.build(
        "adaptive_sampling", channels=lanes, chunk=64,
        reference=_reference(), targets=[(0, GENOME_LEN // 2)],
        flowcell=dict(FLOWCELL), policy=_policy(TPolicy, TDecision),
        device=U.CPU, pipeline_depth=pipeline_depth, fused=fused)


def _golden(engine):
    recs = sorted(engine.records, key=lambda r: r.read_id)
    return [(r.read_id, r.decision.value, r.reason, r.bases_at_decision,
             r.mapped_pos) for r in recs]


@pytest.fixture(scope="module")
def jax_run():
    eng = _jax_engine(8)
    rep = eng.drain(max_steps=20_000)
    return {"golden": _golden(eng), "report": rep,
            "bases": eng.telemetry.bases,
            "fabric": {k: v for k, v in rep.items()
                       if k.startswith("fabric.")}}


@pytest.mark.parametrize("encoder", ["step", "pore"])
def test_simulator_signal_bitwise(encoder):
    cfg = dict(channels=4, n_reads=6, read_len=(40, 80), encoder=encoder,
               seed=SEED)
    js = jfc.FlowcellSimulator(_reference(), jfc.FlowcellConfig(**cfg))
    ts = tfc.FlowcellSimulator(_reference(), tfc.FlowcellConfig(**cfg))
    for i in range(6):
        jr, tr = js.next_read(i % 4, 10_000), ts.next_read(i % 4, 10_000)
        assert (tr.read_id, tr.position) == (jr.read_id, jr.position)
        assert tr.signal.dtype == jr.signal.dtype
        np.testing.assert_array_equal(tr.signal, jr.signal)


def test_step_basecaller_params_match():
    jcfg, jp = jfc.step_basecaller()
    tcfg, tp = tfc.step_basecaller(U.CPU)
    assert (tcfg.kernels, tcfg.channels, tcfg.strides) == \
        (jcfg.kernels, jcfg.channels, jcfg.strides)
    for layer in ("conv1", "conv2"):
        for k in ("w", "b"):
            np.testing.assert_array_equal(U.n(tp[layer][k]),
                                          np.asarray(jp[layer][k]))


@pytest.mark.parametrize("lanes,depth,fused", [
    (8, 1, False), (8, 2, False), (8, 1, True), (8, 2, True), (1, 1, False)])
def test_goldens_match_jax(jax_run, lanes, depth, fused):
    eng = _port_engine(lanes, pipeline_depth=depth, fused=fused)
    rep = eng.drain(max_steps=20_000)
    golden = _golden(eng)
    assert len(golden) == 24
    assert {g[1] for g in golden} == {"accept", "eject"}
    assert golden == jax_run["golden"]
    jrep = jax_run["report"]
    for key in ("reads", "accepted", "ejected", "timeouts", "exhausted"):
        assert rep[key] == jrep[key], key
    assert eng.telemetry.bases == jax_run["bases"]


def test_dispatch_counters_match_jax_key_for_key(jax_run):
    eng = _port_engine(8)
    rep = eng.drain(max_steps=20_000)
    fab = {k: v for k, v in rep.items() if k.startswith("fabric.")}
    assert fab == jax_run["fabric"]
    fused = _port_engine(8, fused=True)
    frep = fused.drain(max_steps=20_000)
    assert frep["fabric.dispatch.fused_stream.reference"] == \
        fused.runtime.telemetry.steps + 1        # + the warmup tick
    assert "fabric.dispatch.conv1d.reference" not in frep


def test_lane_counters_match_host_sessions():
    eng = _port_engine(8)
    while eng.step():
        eng.flush()
        bases = U.n(eng.runtime.lane_state["bases"])
        for b, s in enumerate(eng.scheduler.active):
            if s is not None:
                assert int(bases[b]) == len(s.bases)
    assert eng.telemetry.completed == 24


def test_report_after_flush_and_queue_fed_mode():
    eng = _port_engine(8, pipeline_depth=2)
    rep = eng.drain(max_steps=20_000)
    assert rep["reads"] == 24
    assert (rep["accepted"] + rep["ejected"] + rep["timeouts"]
            + rep["exhausted"]) == 24
    assert rep["decision_p99_ms"] >= rep["decision_p50_ms"] >= 0.0
    assert rep["flowcell_samples"] == eng.runtime._ticks * 64
    cfg, params = tfc.step_basecaller(U.CPU)
    ref = _reference()
    q = tengine.build("adaptive_sampling", params=params, cfg=cfg,
                      reference=ref, targets=[(0, GENOME_LEN // 2)],
                      channels=4, chunk=64, policy=_policy(TPolicy, TDecision),
                      device=U.CPU)
    for i in range(6):
        start = 500 + 700 * i
        q.submit(tfc.step_encode(ref[start:start + 80]), read_id=i,
                 on_target=start + 40 < GENOME_LEN // 2)
    qrep = q.drain()
    assert qrep["reads"] == 6 and qrep["accepted"] + qrep["ejected"] == 6
    with pytest.raises(ValueError, match="source-fed"):
        eng.runtime.submit(None)
    assert isinstance(eng.runtime.lane_state["bases"], torch.Tensor)
