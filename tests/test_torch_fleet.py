"""The port's multi-tenant fleet (``repro_torch.fleet``) on the CPU, against
its own solo engines and against JAX's ``Fleet``.

The fleet's contract (JAX ``tests/test_fleet.py``) is that multiplexing
changes scheduling, never results: each tenant's decisions, outputs and
fabric counters equal the same engine drained alone.  The step-encoder
flowcell and the step-codec basecaller decode exactly, so per-tenant
results also compare bitwise with JAX's fleet, and the DRR scheduler is
pure Python, so its picks equal JAX's pick for pick."""
import random

import numpy as np
import pytest
import torch

import torch_port_util as U
import repro_torch.engine as tengine
from repro.data import flowcell as jfc
from repro.data import genome as jG
from repro.fleet import Fleet as JFleet
from repro.fleet import FleetScheduler as JScheduler
from repro.obs import trace as jtrace
from repro.realtime import PolicyConfig as JPolicy
from repro_torch.data import flowcell as tfc
from repro_torch.fleet import SHAREABLE_WORKLOADS, Fleet, FleetScheduler
from repro_torch.fleet import Tenant
from repro_torch.obs import trace as ttrace
from repro_torch.realtime import PolicyConfig as TPolicy

GENOME_LEN = 6_000
FLOWCELL = {"encoder": "step", "n_reads": 8, "read_len": (64, 128),
            "recovery_samples": 64, "stagger_samples": 16, "seed": 3}


def _flowcell_kw(policy_cls, **kw):
    out = dict(channels=4, chunk=64, flowcell=dict(FLOWCELL),
               pipeline_depth=2,
               reference=jG.random_genome(np.random.default_rng(7),
                                          GENOME_LEN),
               targets=[(0, GENOME_LEN // 2)],
               policy=policy_cls(min_prefix_bases=24, map_prefix_bases=32,
                                 max_prefix_bases=96, min_mapq=4.0,
                                 eject_latency_samples=32))
    out.update(kw)
    return out


def _port_fc(**kw):
    return _flowcell_kw(TPolicy, device=U.CPU, **kw)


def _golden(engine):
    recs = sorted(engine.records, key=lambda r: r.read_id)
    return [(r.read_id, r.decision.value, r.reason, r.bases_at_decision,
             r.mapped_pos) for r in recs]


def _chunks(n, chunk=512, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=chunk).astype(np.float32) for _ in range(n)]


def _step_rows(n, seed):
    """Step-encoded rows of 128 bases (512 samples): the step codec
    basecalls them exactly, in either package."""
    rng = np.random.default_rng(seed)
    return [tfc.step_encode(rng.integers(1, 5, 128)) for _ in range(n)]


# ----------------------------------------------------- fleet-vs-solo oracle
@pytest.mark.parametrize("depth,fused", [(2, False), (1, False), (2, True)])
def test_two_tenant_fleet_equals_solo_runs(depth, fused):
    solo_fc = tengine.build("adaptive_sampling",
                            **_port_fc(fused=fused, pipeline_depth=depth))
    solo_fc.drain(max_steps=20_000)
    golden = _golden(solo_fc)
    assert len(golden) == 8
    assert {g[1] for g in golden} >= {"accept", "eject"}
    rows = _chunks(10)
    solo_bc = tengine.build("basecall", "smoke", seed=0, device=U.CPU)
    for r in rows:
        solo_bc.submit(r)
    solo_bc.drain()

    fleet = Fleet(device=U.CPU)
    fc = fleet.add_tenant("lab-fc", "adaptive_sampling", weight=2.0,
                          **_port_fc(fused=fused, pipeline_depth=depth))
    bc = fleet.add_tenant("lab-bc", "basecall", "smoke", seed=0)
    for r in rows:
        assert bc.submit(r)
    with pytest.raises(ValueError):
        fc.submit(np.zeros(64, np.float32))     # source-fed: no intake
    rep = fleet.drain()

    assert _golden(fc.engine) == golden
    assert len(bc.outputs) == 10
    for got, want in zip(bc.outputs, solo_bc.reads):
        np.testing.assert_array_equal(got, want)
    assert (fc.engine.telemetry.fabric_counters()
            == solo_fc.telemetry.fabric_counters())
    assert (bc.engine.telemetry.fabric_counters()
            == solo_bc.telemetry.fabric_counters())
    assert fc.telemetry.fabric_counters()
    assert rep["completed"] == (solo_fc.telemetry.completed
                                + solo_bc.telemetry.completed)
    assert rep["tenants"]["lab-fc"]["reads"] == 8
    assert rep["tenants"]["lab-bc"]["completed"] == 10
    assert rep["fleet"]["ticks"] == fc.state.ticks + bc.state.ticks
    assert rep["wall_s"] == pytest.approx(fleet.telemetry.wall_s)
    yields = fc.engine.telemetry.counters.get("mesh_yields_inflight", 0)
    assert (yields > 0) == (depth == 2)


# ---------------------------------------------------- against JAX's fleet
def _run_fleets():
    jcfg, jparams = jfc.step_basecaller()
    tcfg, tparams = tfc.step_basecaller(U.CPU)
    rows1, rows2 = _step_rows(6, 1), _step_rows(5, 2)
    out = {}
    for name, fleet, policy, extra, bc_kw in (
            ("jax", JFleet(), JPolicy, {"fabric": "reference"},
             {"params": jparams, "cfg": jcfg, "fabric": "reference"}),
            ("port", Fleet(device=U.CPU), TPolicy, {},
             {"params": tparams, "cfg": tcfg})):
        fc = fleet.add_tenant("lab-fc", "adaptive_sampling", weight=2.0,
                              **_flowcell_kw(policy, **extra))
        b1 = fleet.add_tenant("lab-bc1", "basecall", "smoke", **bc_kw)
        b2 = fleet.add_tenant("lab-bc2", "basecall", "smoke", **bc_kw)
        for r in rows1:
            b1.submit(r)
        for r in rows2:
            b2.submit(r)
        rep = fleet.drain()
        out[name] = {
            "golden": _golden(fc.engine),
            "bc1": [np.asarray(x) for x in b1.outputs],
            "bc2": [np.asarray(x) for x in b2.outputs],
            "shared": (b1.unit is b2.unit, b1.shared),
            "ticks": {n: rep["tenants"][n]["ticks"] for n in rep["tenants"]},
            "fleet_ticks": rep["fleet"]["ticks"],
            "shares": rep["fleet"]["tick_shares"],
            "fairness": rep["fleet"]["fairness_ratio"],
            "completed": rep["completed"],
            "fc_counters": {k: v for k, v in fc.engine.telemetry.counters
                            .items()},
            "dispatches": b1.engine.telemetry.dispatches}
    return out


@pytest.fixture(scope="module")
def fleets():
    return _run_fleets()


def test_flowcell_tenant_goldens_equal_jax(fleets):
    assert fleets["port"]["golden"] == fleets["jax"]["golden"]
    assert len(fleets["port"]["golden"]) == 8


@pytest.mark.parametrize("tenant", ["bc1", "bc2"])
def test_shared_basecall_tenants_equal_jax(fleets, tenant):
    port, jax_ = fleets["port"][tenant], fleets["jax"][tenant]
    assert len(port) == len(jax_) > 0
    for a, b in zip(port, jax_):
        np.testing.assert_array_equal(a, b.astype(a.dtype))
        assert len(a) == 128                    # the step codec is exact


@pytest.mark.parametrize("key", ["shared", "ticks", "fleet_ticks", "shares",
                                 "fairness", "completed", "fc_counters",
                                 "dispatches"])
def test_fleet_scheduling_equals_jax(fleets, key):
    assert fleets["port"][key] == fleets["jax"][key]


# ------------------------------------------------------ scheduler parity --
def _drive(sched_cls, seed):
    """A seeded random sequence of add/submit/pick/charge/idle/wake/remove;
    returns every observable outcome in order."""
    rng = random.Random(seed)
    fs = sched_cls()
    log, names, k = [], [], 0
    for _ in range(400):
        op = rng.random()
        if op < 0.08 or not names:
            name = f"t{k}"
            k += 1
            fs.add(name, weight=rng.choice((0.5, 1.0, 1.5, 2.0, 3.0)),
                   priority=rng.choice((0, 0, 0, 1)),
                   max_pending=rng.choice((None, 2, 5)))
            names.append(name)
            log.append(("add", name))
        elif op < 0.35:
            name = rng.choice(names)
            log.append(("submit", name, fs.submit(name, k)))
        elif op < 0.9:
            name = fs.pick()
            log.append(("pick", name))
            if name is not None:
                st = fs[name]
                if st.queue and rng.random() < 0.8:
                    st.queue.popleft()
                    fs.charge(name)
                else:
                    fs.idle(name)
        elif op < 0.95:
            name = rng.choice(names)
            fs.wake(name)
        elif len(names) > 1:
            name = names.pop(rng.randrange(len(names)))
            fs.remove(name)
            log.append(("remove", name))
    log.append(("shares", fs.tick_shares(), fs.fairness_ratio(),
                fs.total_ticks,
                [(t.name, t.ticks, t.deficit, t.rejected, t.pending)
                 for t in fs.tenants()]))
    return log


@pytest.mark.parametrize("seed", range(8))
def test_scheduler_picks_equal_jax(seed):
    port, jax_ = _drive(FleetScheduler, seed), _drive(JScheduler, seed)
    assert sum(1 for e in port if e[0] == "pick" and e[1]) > 50
    assert port == jax_


def test_scheduler_validates_like_jax():
    fs = FleetScheduler()
    fs.add("a")
    for kw in ({"name": "a"}, {"name": "b", "weight": 0.0},
               {"name": "c", "max_pending": 0}):
        with pytest.raises(ValueError):
            fs.add(**kw)
    with pytest.raises(KeyError):
        fs.remove("zz")


# ------------------------------------------------- quota + backpressure ---
def test_bounded_queue_rejects_and_counts():
    fleet = Fleet(device=U.CPU)
    t = fleet.add_tenant("t", "basecall", "smoke", max_pending=3)
    accepted = [t.submit(r) for r in _chunks(5)]
    assert accepted == [True, True, True, False, False]
    rep = fleet.drain()
    assert len(t.outputs) == 3
    ts = rep["tenants"]["t"]
    assert ts["submitted"] == 3 and ts["rejected"] == 2
    assert rep["fleet"]["counters"]["tenant.t.rejected"] == 2
    small = Fleet(device=U.CPU, max_pending=2)
    s = small.add_tenant("t", "basecall", "smoke")
    assert [s.submit(r) for r in _chunks(3)] == [True, True, False]


# ------------------------------------------------------ attach / detach ---
def test_detach_flowcell_mid_run_keeps_fleet_serving():
    fleet = Fleet(device=U.CPU)
    fc = fleet.add_tenant("fc", "adaptive_sampling", **_port_fc())
    bc = fleet.add_tenant("bc", "basecall", "smoke")
    for r in _chunks(12):
        bc.submit(r)
    for _ in range(4):
        fleet.step()
    fleet.remove_tenant("fc", drain=True)
    with pytest.raises(ValueError):
        fc.submit(np.zeros(64, np.float32))
    rep = fleet.drain()
    assert "fc" not in fleet.tenants
    assert len(fc.engine.records) == 4          # the first wave only
    assert fc.engine.telemetry.counters["source_detached"] == 1
    assert len(bc.outputs) == 12
    assert rep["tenants"]["fc"]["reads"] == 4
    assert rep["completed"] == 4 + 12


def test_detach_now_drops_queue_counted():
    fleet = Fleet(device=U.CPU)
    t = fleet.add_tenant("t", "basecall", "smoke")
    for r in _chunks(6):
        t.submit(r)
    fleet.step()
    final = fleet.remove_tenant("t", drain=False)
    assert fleet.telemetry.counters["tenant.t.dropped"] == 2
    assert final["completed"] == 4
    assert not fleet.step()


def test_attach_mid_run_through_the_registry():
    fleet = Fleet(device=U.CPU)
    a = fleet.add_tenant("a", "basecall", "smoke")
    for r in _chunks(2):
        a.submit(r)
    fleet.step()
    b = tengine.build("basecall", "smoke", device=U.CPU, fleet=fleet,
                      tenant="b", weight=2.0)
    assert isinstance(b, Tenant) and b.name == "b"
    for r in _chunks(2):
        b.submit(r)
    rep = fleet.drain()
    assert len(a.outputs) == 2 and len(b.outputs) == 2
    assert set(rep["tenants"]) == {"a", "b"}


def test_shared_member_detach_leaves_engine_serving():
    fleet = Fleet(device=U.CPU)
    a = fleet.add_tenant("a", "basecall", "smoke")
    b = fleet.add_tenant("b", "basecall", "smoke")
    for r in _chunks(4, seed=1):
        a.submit(r)
    for r in _chunks(4, seed=2):
        b.submit(r)
    fleet.remove_tenant("a", drain=True)
    rep = fleet.drain()
    assert len(a.outputs) == 4 and len(b.outputs) == 4
    assert rep["tenants"]["b"]["completed"] == 4


# ---------------------------------------------- cross-tenant batching -----
def test_compatible_basecall_tenants_share_one_engine():
    fleet = Fleet(device=U.CPU)
    a = fleet.add_tenant("a", "basecall", "smoke", weight=3.0)
    b = fleet.add_tenant("b", "basecall", "smoke")
    c = fleet.add_tenant("c", "basecall", "smoke", share=False)
    assert a.unit is b.unit and a.shared and b.shared
    assert c.unit is not a.unit and not c.shared
    for r in _chunks(8, seed=1):
        a.submit(r)
    for r in _chunks(8, seed=2):
        b.submit(r)
    fleet.drain()
    eng = a.unit.engine
    assert len(a.outputs) == len(b.outputs) == 8
    assert eng.telemetry.completed == 16 and eng.telemetry.dispatches == 4
    assert a.telemetry.completed == b.telemetry.completed == 8
    assert a.telemetry is not eng.telemetry
    assert SHAREABLE_WORKLOADS == ("basecall", "lm_decode")
    x = fleet.add_tenant("x", "adaptive_sampling", "smoke")
    y = fleet.add_tenant("y", "adaptive_sampling", "smoke")
    assert x.unit is not y.unit and not y.shared


def test_shared_batch_rows_equal_solo_outputs():
    rows_a, rows_b = _chunks(3, seed=5), _chunks(3, seed=6)
    solo = tengine.build("basecall", "smoke", seed=0, device=U.CPU)
    for r in rows_a + rows_b:
        solo.submit(r)
    solo.drain()
    fleet = Fleet(device=U.CPU)
    a = fleet.add_tenant("a", "basecall", "smoke", seed=0)
    b = fleet.add_tenant("b", "basecall", "smoke", seed=0)
    for r in rows_a:
        a.submit(r)
    for r in rows_b:
        b.submit(r)
    fleet.drain()
    np.testing.assert_array_equal(a.outputs[0], solo.reads[0])
    np.testing.assert_array_equal(b.outputs[0], solo.reads[3])
    assert len(a.outputs) == len(b.outputs) == 3


# ------------------------------------------------------------ lm_decode ---
def _lm_requests(cls, vocab, seed, base):
    rng = np.random.default_rng(seed)
    return [cls(uid=base + u, prompt=rng.integers(1, vocab, 4),
                max_new_tokens=4) for u in range(3)]


def test_lm_decode_tenants_share_one_unit_like_jax():
    """JAX's ``test_lm_tenants_share_slot_pool``: two ``lm_decode``
    tenants on one preset share one ``LMUnit``; each gets its own
    requests back, and the uids, per-request token counts, steps and
    dispatches equal JAX's fleet's (value-independent with eos -1)."""
    from repro.engine.lm import Request as JRequest
    from repro_torch.engine.lm import Request
    from repro_torch.fleet import LMUnit
    runs = {}
    for name, fleet, cls in (("jax", JFleet(), JRequest),
                             ("port", Fleet(device=U.CPU), Request)):
        a = fleet.add_tenant("a", "lm_decode", "smoke")
        b = fleet.add_tenant("b", "lm_decode", "smoke")
        assert a.unit is b.unit and a.shared
        vocab = a.engine.cfg.vocab_size
        for r in _lm_requests(cls, vocab, 0, 0):
            a.submit(r)
        for r in _lm_requests(cls, vocab, 1, 100):
            b.submit(r)
        fleet.drain()
        assert sorted(r.uid for r in a.outputs) == [0, 1, 2]
        assert sorted(r.uid for r in b.outputs) == [100, 101, 102]
        assert a.telemetry.tokens > 0 and b.telemetry.tokens > 0
        runs[name] = (
            [(r.uid, len(r.tokens_out)) for r in a.outputs + b.outputs],
            a.engine.telemetry.steps, a.engine.telemetry.dispatches,
            a.telemetry.tokens, b.telemetry.tokens, type(a.unit).__name__)
    assert runs["port"] == runs["jax"]
    assert isinstance(a.unit, LMUnit)


def test_lm_decode_tenant_tokens_equal_its_solo_run():
    """f32: a tenant's tokens do not depend on what fills the other
    slots, so each tenant of a shared pool decodes what it decodes
    alone (the same cfg and seed, so the same params)."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.engine.lm import Request
    cfg = dataclasses.replace(ARCHS["starcoder2-3b"].smoke_config(),
                              dtype="float32")
    fleet = Fleet(device=U.CPU)
    tenants = [fleet.add_tenant(n, "lm_decode", "smoke", cfg=cfg)
               for n in ("a", "b")]
    assert tenants[0].unit is tenants[1].unit
    for i, t in enumerate(tenants):
        for r in _lm_requests(Request, cfg.vocab_size, i, 100 * i):
            t.submit(r)
    fleet.drain()
    for i, t in enumerate(tenants):
        solo = tengine.build("lm_decode", "smoke", cfg=cfg, device=U.CPU)
        for r in _lm_requests(Request, cfg.vocab_size, i, 100 * i):
            solo.submit(r)
        solo.drain()
        want = {r.uid: r.tokens_out for r in solo.finished}
        assert {r.uid: r.tokens_out for r in t.outputs} == want
        assert len({tuple(v) for v in want.values()}) > 1


def test_fleet_takes_a_device_not_a_mesh():
    # a mesh goes to the flowcell tenants (tests/test_torch_lane_mesh.py):
    # two devices the CPU does not have are refused there
    with pytest.raises(ValueError):
        Fleet(device=U.CPU, mesh=2).add_tenant("t", "adaptive_sampling",
                                               "smoke")
    fleet = Fleet(device=U.CPU)
    assert fleet.device == torch.device("cpu")
    t = fleet.add_tenant("t", "basecall", "smoke")
    assert t.engine.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Fleet()


# --------------------------------------------------------- observability --
def test_fleet_trace_has_tenant_tracks_and_read_spans(tmp_path):
    fleet = Fleet(device=U.CPU, trace=True)
    fc = fleet.add_tenant("lab-fc", "adaptive_sampling", **_port_fc())
    a = fleet.add_tenant("lab-a", "basecall", "smoke")
    b = fleet.add_tenant("lab-b", "basecall", "smoke", share=False)
    for r in _chunks(3):
        a.submit(r)
        b.submit(r)
    fleet.drain()
    path = tmp_path / "fleet.json"
    doc = fleet.export_trace(str(path))
    assert jtrace.validate_chrome_trace(doc) == []
    assert ttrace.validate_chrome_trace(doc) == []
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert names == {"fleet", "tenant:lab-fc (adaptive_sampling)",
                     "tenant:lab-a (basecall)", "tenant:lab-b (basecall)"}
    spans = ttrace.read_spans(doc)
    assert sorted(s["read_id"] for s in spans) == \
        sorted(r.read_id for r in fc.engine.records)


def test_summary_has_fairness_and_shares():
    fleet = Fleet(device=U.CPU)
    fleet.add_tenant("a", "basecall", "smoke", weight=2.0, share=False)
    fleet.add_tenant("b", "basecall", "smoke", share=False)
    for r in _chunks(8):
        fleet.submit("a", r)
        fleet.submit("b", r)
    rep = fleet.drain()
    fl = rep["fleet"]
    assert fl["fairness_ratio"] >= 1.0
    assert fl["weights"] == {"a": 2.0, "b": 1.0}
    assert abs(sum(fl["tick_shares"].values()) - 1.0) < 1e-9
