"""The port's observability stack (``repro_torch.obs`` and the full
``Telemetry``) against the JAX package's on the CPU.

Pinned: the log histogram's percentiles bit for bit (exact mode) and its
folded buckets and values, merge associativity, ``Counters``/``Gauges``
merge rules, telemetry that crosses between the packages through
``to_dict``/``from_dict`` and merges to the same summary either way, and
port traces and time series that pass JAX's own validators."""
import io
import json
import os

import numpy as np
import pytest
import torch

import torch_port_util as U  # noqa: F401  (torch lazy-module registries)
from repro.engine.telemetry import Telemetry as JTelemetry
from repro.obs import export as jexport
from repro.obs import metrics as jm
from repro.obs import trace as jtrace
from repro_torch.engine.telemetry import Telemetry as TTelemetry
from repro_torch.kernels import fabric as tfabric
from repro_torch.obs import export as texport
from repro_torch.obs import metrics as tm
from repro_torch.obs import trace as ttrace
from repro_torch.obs import validate as tvalidate

QS = (0, 1, 10, 25, 50, 75, 90, 99, 100)


def _samples(seed, n):
    rng = np.random.default_rng(seed)
    vals = rng.lognormal(2.0, 1.5, size=n)
    vals[::17] = 0.0                     # underflow bucket
    vals[5::41] = 2e7                    # overflow bucket
    wts = rng.integers(1, 9, size=n).astype(float)
    return vals, wts


def _fill(mod, vals, wts, **kw):
    h = mod.LogHistogram(**kw)
    for v, w in zip(vals, wts):
        h.observe(v, w)
    return h


# ------------------------------------------------------------ histogram ----
@pytest.mark.parametrize("seed", range(3))
def test_exact_percentiles_bitwise_equal_jax(seed):
    vals, wts = _samples(seed, 700)
    th, jh = _fill(tm, vals, wts), _fill(jm, vals, wts)
    assert not th.folded and not jh.folded
    for q in QS:
        assert th.percentile(q) == jh.percentile(q)
        assert th.percentile(q) == jm.weighted_percentile(vals, wts, q)
    assert tm.weighted_percentile(vals, wts, 37.5) == \
        jm.weighted_percentile(vals, wts, 37.5)


@pytest.mark.parametrize("exact_until", [64, 256, 4096])
def test_folded_buckets_and_values_equal_jax(exact_until):
    vals, wts = _samples(11, 6000)
    th = _fill(tm, vals, wts, exact_until=exact_until)
    jh = _fill(jm, vals, wts, exact_until=exact_until)
    assert th.folded and jh.folded
    assert th.n_buckets == jh.n_buckets == 133
    np.testing.assert_array_equal(th.counts, jh.counts)
    for q in QS:
        assert th.percentile(q) == jh.percentile(q)
    assert th.to_dict() == jh.to_dict()
    assert th.mean == jh.mean


def test_bucket_layout_is_jax_default():
    th, jh = tm.LogHistogram(), jm.LogHistogram()
    assert (th.lo, th.growth, th.exact_until, th.n_buckets) == \
        (1e-3, 2 ** 0.25, 4096, jh.n_buckets)
    for i in (0, 1, 40, 133, 134):
        assert th.bucket_lower_edge(i) == jh.bucket_lower_edge(i)
    for v in (-1.0, 0.0, 1e-3, 0.5, 3.0, 9.99e6, 1e7, 5e9):
        assert th._bucket(v) == jh._bucket(v)


@pytest.mark.parametrize("exact_until", [8, 100, 4096])
def test_merge_associative(exact_until):
    rng = np.random.default_rng(2)
    shards = [rng.lognormal(1.0, 1.0, size=300) for _ in range(3)]

    def hist(values):
        return _fill(tm, values, np.ones(len(values)),
                     exact_until=exact_until)

    left = hist(shards[0]).merge(hist(shards[1])).merge(hist(shards[2]))
    right = hist(shards[0]).merge(hist(shards[1]).merge(hist(shards[2])))
    swapped = hist(shards[2]).merge(hist(shards[0])).merge(hist(shards[1]))
    assert left.n == right.n == swapped.n == 900
    for q in QS:
        assert left.percentile(q) == right.percentile(q) == \
            swapped.percentile(q)
    if left.folded:
        np.testing.assert_array_equal(left.counts, right.counts)
        np.testing.assert_array_equal(left.counts, swapped.counts)
    # and the same merge tree in JAX lands on the same state
    jl = _fill(jm, shards[0], np.ones(300), exact_until=exact_until)
    for s in shards[1:]:
        jl.merge(_fill(jm, s, np.ones(300), exact_until=exact_until))
    assert left.to_dict() == jl.to_dict()


def test_histogram_wire_crosses_packages():
    vals, wts = _samples(5, 900)
    th = _fill(tm, vals, wts, exact_until=300)
    back = jm.LogHistogram.from_dict(json.loads(json.dumps(th.to_dict())))
    again = tm.LogHistogram.from_dict(back.to_dict())
    for q in QS:
        assert back.percentile(q) == th.percentile(q) == again.percentile(q)
    empty = tm.LogHistogram().to_dict()
    assert empty["vmin"] is None and empty == jm.LogHistogram().to_dict()


def test_incompatible_layouts_refuse_to_merge():
    with pytest.raises(ValueError):
        tm.LogHistogram(growth=2.0).merge(tm.LogHistogram(growth=1.5))


def test_counters_and_gauges_merge_like_jax():
    for mod in (tm, jm):
        c = mod.Counters(a=1, b=2)
        c.merge({"a": 3, "c": 1})
        assert dict(c) == {"a": 4, "b": 2, "c": 1}
    out = {}
    for name, mod in (("port", tm), ("jax", jm)):
        old, new = mod.Gauges(), mod.Gauges()
        old["q"] = 1.0
        old["only_old"] = 7
        new["q"] = 2.0                  # written later: freshest wins
        merged = mod.Gauges().merge(old).merge(new)
        stale = mod.Gauges().merge(new).merge(old)
        out[name] = (dict(merged), dict(stale))
        back = mod.Gauges.from_dict(json.loads(json.dumps(merged.to_dict())))
        assert dict(back) == dict(merged)
    assert out["port"] == out["jax"] == (
        {"q": 2.0, "only_old": 7}, {"q": 2.0, "only_old": 7})


# ------------------------------------------------------------ telemetry ----
def _populate(t, seed):
    rng = np.random.default_rng(seed)
    t.steps = int(rng.integers(1, 50))
    t.completed = int(rng.integers(0, 40))
    t.bases = int(rng.integers(0, 5000))
    t.samples = int(rng.integers(0, 9000))
    t.samples_saved = int(rng.integers(0, 2000))
    t.tokens = int(rng.integers(0, 300))
    t.wall_s = float(rng.uniform(0.1, 5))
    for ms in rng.uniform(0.1, 50, size=rng.integers(1, 30)):
        t.observe_latency(float(ms), float(rng.integers(1, 4)))
    for i in range(int(rng.integers(1, 5))):
        t.count(f"c{i}", int(rng.integers(1, 9)))
        t.gauge(f"g{i}", float(rng.uniform(0, 1)))
    t.count("steps", 3)                 # collides with a scalar
    t.stage_s[f"stage{seed % 2}"] = float(rng.uniform(0, 1))
    t.fabric_scope.counts[f"fabric.dispatch.op{seed % 2}.reference"] = int(
        rng.integers(1, 7))
    return t


def _wire(d):
    return json.loads(json.dumps(d))


@pytest.mark.parametrize("seed", range(4))
def test_port_telemetry_read_and_merged_by_jax(seed):
    a = _populate(TTelemetry(workload="w"), seed)
    b = _populate(TTelemetry(workload="w"), seed + 100)
    port = TTelemetry(workload="roll").merge(a).merge(b)
    jax_side = JTelemetry(workload="roll")
    jax_side.merge(JTelemetry.from_dict(_wire(a.to_dict())))
    jax_side.merge(JTelemetry.from_dict(_wire(b.to_dict())))
    assert jax_side.summary() == port.summary()
    assert jax_side.to_dict() == port.to_dict()


@pytest.mark.parametrize("seed", range(4))
def test_jax_telemetry_read_and_merged_by_port(seed):
    a = _populate(JTelemetry(workload="w"), seed)
    b = _populate(JTelemetry(workload="w"), seed + 50)
    jax_side = JTelemetry(workload="roll")
    jax_side.merge(a)
    jax_side.merge(b)
    port = TTelemetry(workload="roll")
    port.merge(TTelemetry.from_dict(_wire(a.to_dict())))
    port.merge(TTelemetry.from_dict(_wire(b.to_dict())))
    assert port.summary() == jax_side.summary()
    assert port.summary()["counters.steps"] == 6


def test_summary_keys_match_jax():
    t, j = _populate(TTelemetry("w"), 3), _populate(JTelemetry("w"), 3)
    assert list(t.summary()) == list(j.summary())
    assert t.summary() == j.summary()
    assert t.summary()["tokens_per_s"] == t.tokens / t.wall_s > 0


def test_latency_window_folds_and_properties_follow():
    t = TTelemetry("w", latency_exact_window=16)
    for i in range(10):
        t.observe_latency(float(i + 1), 2.0)
    assert t.latencies_ms == [float(i + 1) for i in range(10)]
    assert t.latency_weights == [2.0] * 10
    for i in range(10):
        t.observe_latency(float(i + 1))
    assert t.latency_hist.folded and t.latencies_ms == []
    assert t.latency_percentile(50) > 0


# ------------------------------------------------------------- tracing -----
def test_stage_emits_x_span_and_untraced_records_nothing():
    tel = TTelemetry("w", tracer=True)
    with tel.stage("map"):
        pass
    xs = [e for e in tel.tracer.to_chrome()["traceEvents"]
          if e.get("ph") == "X"]
    assert [e["name"] for e in xs] == ["map"] and xs[0]["dur"] >= 0
    plain = TTelemetry("w")
    with plain.stage("map"):
        pass
    assert plain.tracer is ttrace.NULL_TRACER and plain.tracer.events == []
    assert ttrace.NULL_TRACER.span("x", pid=0, tid=0) is ttrace._NULL_SPAN


def test_fabric_listener_sees_every_bump():
    seen = []
    scope = tfabric.ScopedCounters(listener=seen.append)
    with tfabric.scoped(scope):
        tfabric.record("fabric.dispatch.conv1d.reference")
        tfabric.record("fabric.dispatch.matmul.reference", 2)
    assert seen == [(("fabric.dispatch.conv1d.reference", 1),),
                    (("fabric.dispatch.matmul.reference", 2),)]
    assert scope.snapshot() == {"fabric.dispatch.conv1d.reference": 1,
                                "fabric.dispatch.matmul.reference": 2}
    scope.clear()
    assert scope.snapshot() == {}
    tel = TTelemetry("w", tracer=True)
    with tel.scope():
        tfabric.dispatch("conv1d", torch.zeros(1))
    names = [e["name"] for e in tel.tracer.events if e.get("ph") == "i"]
    assert names == ["fabric.dispatch.conv1d.reference"]


def _traced_doc():
    t = ttrace.Tracer()
    pid = t.pid("engine")
    host = t.tid(pid, "host")
    hook = t.scheduler_hook(pid)
    for i in range(4):
        lane = t.tid(pid, f"lane{i:03d}")
        t.begin("read", pid=pid, tid=lane, cat="read", args={"read_id": i})
        hook("assign", i)
        with t.span("basecall", pid=pid, tid=host):
            pass
        t.counter("lanes", {"busy": i + 1}, pid=pid)
        t.instant("tick.dispatch", pid=pid, tid=host, args={"tick": i})
    t.begin("read", pid=pid, tid=t.tid(pid, "lane009"),
            args={"read_id": 9})        # left open: closed at export
    for i in range(4):
        t.end(pid=pid, tid=t.tid(pid, f"lane{i:03d}"),
              args={"decision": "ACCEPT"})
    return t


def test_port_trace_passes_jax_validator(tmp_path):
    t = _traced_doc()
    path = tmp_path / "trace.json"
    doc = t.export_chrome(str(path))
    assert ttrace.validate_chrome_trace(doc) == []
    assert jtrace.validate_chrome_trace(doc) == []
    assert jtrace.validate_chrome_trace(json.loads(path.read_text())) == []
    assert len(jtrace.read_spans(doc)) == len(ttrace.read_spans(doc)) == 5
    assert tvalidate.main([str(path), "--min-read-spans", "5"]) == 0
    assert tvalidate.main([str(path), "--min-read-spans", "6"]) == 1


def test_validators_reject_what_jax_rejects():
    bad = {"traceEvents": [
        {"name": "x", "ph": "E", "ts": 1.0, "pid": 1, "tid": 1},
        {"name": "y", "ph": "X", "ts": 0.5, "pid": 2, "tid": 1},
        {"name": "z", "ph": "Q", "ts": 2.0, "pid": 1, "tid": 1}]}
    assert ttrace.validate_chrome_trace(bad) == \
        jtrace.validate_chrome_trace(bad)
    assert len(ttrace.validate_chrome_trace(bad)) >= 3


def test_bounded_buffer_keeps_stream_well_formed():
    t = ttrace.Tracer(max_events=4)
    pid = t.pid("e")
    tid = t.tid(pid, "lane")
    for i in range(6):
        t.begin("read", pid=pid, tid=tid, args={"read_id": i})
    for _ in range(6):
        t.end(pid=pid, tid=tid)
    doc = t.to_chrome()
    assert t.dropped == 2 and doc["otherData"]["dropped_events"] == 2
    assert jtrace.validate_chrome_trace(doc) == []


def test_relabel_and_duplicate_labels_like_jax():
    for mod in (ttrace, jtrace):
        t = mod.Tracer()
        a, b = t.pid("basecall"), t.pid("basecall")
        t.relabel_pid(a, "tenant:x")
        names = sorted(m["args"]["name"] for m in t.meta
                       if m["name"] == "process_name")
        assert names == ["basecall#2", "tenant:x"] and a != b
    assert ttrace.as_tracer(False) is ttrace.NULL_TRACER
    assert ttrace.as_tracer(None) is ttrace.NULL_TRACER
    shared = ttrace.Tracer()
    assert ttrace.as_tracer(shared) is shared
    assert ttrace.as_tracer(True).enabled


def test_port_timeseries_passes_jax_validator(tmp_path):
    tel = TTelemetry("adaptive_sampling")
    path = tmp_path / "ts.jsonl"
    clock = iter(np.arange(0.0, 100.0, 0.25)).__next__
    stream = io.StringIO()
    exp = texport.TimeSeriesExporter(tel, interval_s=0.5, path=str(path),
                                     stream=stream, dashboard=True,
                                     clock=clock)
    exp._dash.stream = io.StringIO()
    tel.exporter = exp
    for i in range(8):
        tel.bases += 100
        tel.samples += 400
        tel.steps += 1
        tel.count("accepted")
        tel.tick_export()
    exp.close()
    assert texport.validate_timeseries(str(path)) == []
    assert jexport.validate_timeseries(str(path)) == []
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len(recs) == len(exp.records) >= 3
    assert sum(r["counter_deltas"].get("accepted", 0) for r in recs) == 8
    assert all(r["fallback_rate"] == 0 for r in recs)
    assert "bases/s" in exp._dash.stream.getvalue()
    assert tvalidate.main([str(_write_trace(tmp_path)), "--timeseries",
                           str(path)]) == 0


def _write_trace(tmp_path):
    path = tmp_path / "t.json"
    _traced_doc().export_chrome(str(path))
    return path


def test_profile_window():
    with ttrace.profile_window(None) as prof:
        assert prof is None
    with ttrace.profile_window("unused", enabled=False) as prof:
        assert prof is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            with ttrace.profile_window("unused", device="cuda"):
                pass


def test_profile_window_cpu_writes_a_trace(tmp_path):
    logdir = tmp_path / "prof"
    with ttrace.profile_window(str(logdir), device="cpu") as prof:
        assert prof is not None
        torch.ones(64, 64) @ torch.ones(64, 64)
    doc = json.loads((logdir / "device_trace.json").read_text())
    assert doc["traceEvents"]
    assert os.path.getsize(logdir / "device_trace.json") > 0
