"""A traced port engine against a traced JAX engine on the CPU.

The step-encoder flowcell decodes exactly, so both engines make the same
decisions on the same lanes at the same ticks, and their traces must hold
the same per-read spans (``read_id``, lane, decision), the same span names
and phases, and the same number of events of each name and phase (JAX's
``tests/test_obs.py`` pins its own engine's trace; this pins the port's to
it).  An untraced engine records nothing."""
import collections
import json

import numpy as np
import pytest
import torch  # noqa: F401

import torch_port_util as U
import repro.engine as jengine
import repro_torch.engine as tengine
from repro.data import genome as jG
from repro.obs import trace as jtrace
from repro.realtime import Decision as JDecision
from repro.realtime import PolicyConfig as JPolicy
from repro_torch.obs import trace as ttrace
from repro_torch.obs import validate as tvalidate
from repro_torch.realtime import Decision as TDecision
from repro_torch.realtime import PolicyConfig as TPolicy

GENOME_LEN = 6_000
FLOWCELL = {"encoder": "step", "n_reads": 24, "read_len": (64, 128),
            "recovery_samples": 64, "stagger_samples": 16, "seed": 3}


def _kw(policy_cls, decision):
    return dict(
        channels=8, chunk=64,
        reference=jG.random_genome(np.random.default_rng(7), GENOME_LEN),
        targets=[(0, GENOME_LEN // 2)], flowcell=dict(FLOWCELL),
        policy=policy_cls(min_prefix_bases=24, map_prefix_bases=32,
                          max_prefix_bases=96, min_mapq=4.0,
                          timeout_decision=decision.ACCEPT,
                          eject_latency_samples=32))


def _spans(doc, mod):
    return sorted((s["read_id"], s["args"]["decision"], s["args"]["reason"],
                   s["args"]["lane"]) for s in mod.read_spans(doc))


def _events(doc):
    return collections.Counter((e["name"], e["ph"])
                               for e in doc["traceEvents"])


@pytest.fixture(scope="module")
def jax_traces():
    out = {}
    for depth in (1, 2):
        for fused in (False, True):
            eng = jengine.build("adaptive_sampling",
                                **_kw(JPolicy, JDecision),
                                fabric="reference", pipeline_depth=depth,
                                fused=fused, trace=True)
            eng.drain(max_steps=20_000)
            out[depth, fused] = eng.telemetry.tracer.to_chrome()
    return out


@pytest.mark.parametrize("depth,fused", [(1, False), (2, False), (1, True),
                                         (2, True)])
def test_traced_engine_matches_jax(jax_traces, tmp_path, depth, fused):
    eng = tengine.build("adaptive_sampling", **_kw(TPolicy, TDecision),
                        device=U.CPU, pipeline_depth=depth, fused=fused,
                        trace=True)
    with U.one_thread():
        eng.drain(max_steps=20_000)
    path = tmp_path / "trace.json"
    doc = eng.telemetry.tracer.export_chrome(str(path))
    want = jax_traces[depth, fused]
    # JAX's schema checks pass on the port's trace, in memory and on disk
    assert jtrace.validate_chrome_trace(doc) == []
    assert jtrace.validate_chrome_trace(json.loads(path.read_text())) == []
    assert tvalidate.main([str(path), "--min-read-spans", "24"]) == 0
    spans = _spans(doc, jtrace)
    assert len(spans) == 24
    assert {s[1] for s in spans} == {"ACCEPT", "EJECT"}
    assert spans == _spans(want, jtrace)
    got, ref = _events(doc), _events(want)
    assert set(got) == set(ref)
    assert got == ref
    assert {ph for _, ph in got} >= {"B", "E", "X", "i", "C", "M"}


def test_traced_and_untraced_decide_alike():
    traced = tengine.build("adaptive_sampling", **_kw(TPolicy, TDecision),
                           device=U.CPU, pipeline_depth=2, trace=True)
    plain = tengine.build("adaptive_sampling", **_kw(TPolicy, TDecision),
                          device=U.CPU, pipeline_depth=2)
    with U.one_thread():
        traced.drain(max_steps=20_000)
        plain.drain(max_steps=20_000)

    def golden(e):
        return sorted((r.read_id, r.decision.value, r.reason,
                       r.bases_at_decision, r.mapped_pos) for r in e.records)
    assert golden(traced) == golden(plain)
    assert plain.telemetry.tracer is ttrace.NULL_TRACER
    assert plain.telemetry.tracer.events == []
    assert plain.telemetry.trace_pid == 0


@pytest.mark.parametrize("workload,preset", [("basecall", "smoke"),
                                             ("pathogen_pipeline", "smoke")])
def test_chunk_engines_trace_stages_and_scheduler(workload, preset):
    tracer = ttrace.Tracer()
    eng = tengine.build(workload, preset, device=U.CPU, trace=tracer,
                        seed=0)
    rows = np.random.default_rng(0).normal(size=(4, 512)).astype(np.float32)
    if workload == "basecall":
        eng.submit(rows)
    else:
        eng.submit(rows)
        eng.submit(rows)
    with U.one_thread():
        eng.drain()
    doc = tracer.to_chrome()
    assert jtrace.validate_chrome_trace(doc) == []
    names = {(e["name"], e["ph"]) for e in doc["traceEvents"]}
    assert ("basecall", "X") in names and ("decode", "X") in names
    assert ("sched.admit", "i") in names and ("sched.release", "i") in names
    assert ("fabric.dispatch.conv1d.reference", "i") in names
    untraced = tengine.build(workload, preset, device=U.CPU, seed=0)
    untraced.submit(rows)
    with U.one_thread():
        untraced.drain()
    assert untraced.telemetry.tracer.events == []


def test_drain_ticks_the_exporter():
    from repro_torch.obs.export import TimeSeriesExporter
    eng = tengine.build("basecall", "smoke", device=U.CPU, seed=0)
    exp = TimeSeriesExporter(eng.telemetry, interval_s=0.0,
                             scheduler=eng.scheduler)
    eng.telemetry.exporter = exp
    eng.submit(np.zeros((8, 512), np.float32))
    with U.one_thread():
        eng.drain()
    assert len(exp.records) == 2              # one per step
    assert exp.records[-1]["completed"] == 8
    assert "occupancy" in exp.records[-1]
    assert exp.records[0]["samples_per_s"] > 0
