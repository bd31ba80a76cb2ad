"""Lane meshes of the port's Read-Until flowcell against the JAX engine, on
the CPU.

JAX's lane mesh is one controller: ``shard_map`` runs the tick over the
devices with the lane-major state split on the lane axis and the params
replicated, no collectives.  The port's is a ``sharding.LaneMesh`` of
devices of one process, each running a contiguous block of lanes; a
device may appear twice, as JAX's virtual host devices put two on one CPU
(``("cpu", "cpu")`` here, ``("cuda:0", "cuda:0")`` on one card).

JAX's bar (``tests/test_flowcell.py:293``): one- and two-shard meshes give
per-read goldens ``(read_id, decision, reason, bases_at_decision,
mapped_pos)`` identical to the unmeshed runtime, fused and unfused.  Here
they are held to JAX's unmeshed engine and to the port's.  Beside them:
``resolve_lane_mesh`` (``"auto"``, ints, channels that do not divide),
and a lane mesh through ``Fleet(mesh=)`` and ``EdgeDevice(mesh=)``.
"""
import numpy as np
import pytest
import torch

import torch_port_util as U
import repro.engine as jengine
import repro_torch.engine as tengine
from repro.data import genome as jG
from repro.realtime import Decision as JDecision
from repro.realtime import PolicyConfig as JPolicy
from repro_torch.distributed.sharding import LANE_AXIS, LaneMesh, lane_mesh
from repro_torch.engine.adaptive import resolve_lane_mesh
from repro_torch.realtime import Decision as TDecision
from repro_torch.realtime import PolicyConfig as TPolicy

GENOME_LEN = 6_000
LANES = 8
FLOWCELL = {"encoder": "step", "n_reads": 24, "read_len": (64, 128),
            "recovery_samples": 64, "stagger_samples": 16, "seed": 3}
MESHES = {"one": ("cpu",), "two": ("cpu", "cpu"), "four": ("cpu",) * 4}


def _reference():
    return jG.random_genome(np.random.default_rng(7), GENOME_LEN)


def _policy(cls, decision):
    return cls(min_prefix_bases=24, map_prefix_bases=32, max_prefix_bases=96,
               min_mapq=4.0, timeout_decision=decision.ACCEPT,
               eject_latency_samples=32)


def _port_kw(**kw):
    return dict(channels=LANES, chunk=64, reference=_reference(),
                targets=[(0, GENOME_LEN // 2)], flowcell=dict(FLOWCELL),
                policy=_policy(TPolicy, TDecision), device=U.CPU, **kw)


def _golden(engine):
    recs = sorted(engine.records, key=lambda r: r.read_id)
    return [(r.read_id, r.decision.value, r.reason, r.bases_at_decision,
             r.mapped_pos) for r in recs]


@pytest.fixture(scope="module")
def unmeshed():
    jeng = jengine.build(
        "adaptive_sampling", channels=LANES, chunk=64,
        reference=_reference(), targets=[(0, GENOME_LEN // 2)],
        flowcell=dict(FLOWCELL), policy=_policy(JPolicy, JDecision),
        fabric="reference")
    jeng.drain(max_steps=20_000)
    teng = tengine.build("adaptive_sampling", **_port_kw())
    teng.drain(max_steps=20_000)
    return {"jax": _golden(jeng), "port": _golden(teng)}


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_lane_mesh_goldens_equal_unmeshed(unmeshed, mesh, fused, depth):
    lm = LaneMesh(MESHES[mesh])
    eng = tengine.build("adaptive_sampling", **_port_kw(
        mesh=lm, fused=fused, pipeline_depth=depth))
    assert eng.runtime.mesh is lm and eng.runtime.fused is fused
    eng.drain(max_steps=20_000)
    golden = _golden(eng)
    assert len(golden) == FLOWCELL["n_reads"]
    assert golden == unmeshed["jax"] == unmeshed["port"]


def test_lane_mesh_splits_lanes_in_blocks():
    """Each shard runs its contiguous block: the step sees LANES / n lanes
    a call, and the lane state comes back whole and in lane order."""
    eng = tengine.build("adaptive_sampling", **_port_kw(
        mesh=LaneMesh(MESHES["two"]), fused=False))
    seen = []
    from repro_torch.core import basecaller as bc
    real = bc.apply_stream_core

    def spy(params, conv, rows, **kw):
        seen.append(rows.shape[0])
        return real(params, conv, rows, **kw)
    bc.apply_stream_core = spy
    try:
        for _ in range(3):
            eng.step()
    finally:
        bc.apply_stream_core = real
    assert seen and set(seen) == {LANES // 2}
    assert eng.runtime.lane_state["bases"].shape == (LANES,)
    # two shards a tick, and the warm-up's tick
    assert len(seen) == 2 * (eng.runtime.telemetry.steps + 1)


def test_lane_mesh_refuses_lanes_that_do_not_split():
    with pytest.raises(ValueError, match="divide evenly"):
        tengine.build("adaptive_sampling", **_port_kw(
            mesh=LaneMesh(("cpu",) * 3)))


def test_resolve_lane_mesh(monkeypatch):
    assert LANE_AXIS == "data"
    for mesh in (None, "auto", 1):
        assert resolve_lane_mesh(mesh, 8, device="cpu") is None
    lm = LaneMesh(("cpu", "cpu"))
    assert resolve_lane_mesh(lm, 8, device="cpu") is lm
    assert lm.shape == {"data": 2} and lm.size == 2
    assert lm.devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="not in 1..1"):
        resolve_lane_mesh(2, 8, device="cpu")
    with pytest.raises(TypeError):
        resolve_lane_mesh(("lane", 2), 8, device="cpu")
    with pytest.raises(ValueError):
        LaneMesh(())
    # four visible cards: "auto" takes the largest count dividing the
    # lanes (never an error, None where only 1 divides), an int exactly
    # that many and no more
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cards = tuple(torch.device("cuda", i) for i in range(4))
    assert resolve_lane_mesh("auto", 512).devices == cards
    assert resolve_lane_mesh("auto", 6).devices == cards[:3]
    assert resolve_lane_mesh("auto", 7) is None
    assert resolve_lane_mesh(2, 8).devices == cards[:2]
    assert lane_mesh().devices == cards
    with pytest.raises(ValueError, match="not in 1..4"):
        resolve_lane_mesh(5, 10)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert resolve_lane_mesh("auto", 512) is None


def test_fleet_hands_its_lane_mesh_to_flowcell_tenants(unmeshed):
    from repro_torch.fleet import Fleet
    lm = LaneMesh(MESHES["two"])
    fleet = Fleet(device=U.CPU, mesh=lm)
    kw = _port_kw(fused=True, pipeline_depth=2)
    kw.pop("device")
    fc = fleet.add_tenant("lab-fc", "adaptive_sampling", **kw)
    bc = fleet.add_tenant("lab-bc", "basecall", "smoke")
    assert fc.engine.runtime.mesh is lm
    assert not hasattr(bc.engine, "runtime")
    fleet.drain()
    assert _golden(fc.engine) == unmeshed["port"]
    # a device count the CPU does not have is refused when the tenant is
    # built, not dropped
    with pytest.raises(ValueError, match="not in 1..1"):
        Fleet(device=U.CPU, mesh=2).add_tenant("t", "adaptive_sampling",
                                               "smoke")


def test_edge_device_runs_its_flowcell_on_a_lane_mesh():
    from repro_torch.field import EdgeDevice
    ref = _reference()
    out = {}
    for name, mesh in (("none", None), ("two", LaneMesh(MESHES["two"]))):
        dev = EdgeDevice(0, ref, [(0, GENOME_LEN // 2)], channels=LANES,
                         chunk=128, n_reads=12, device=U.CPU, mesh=mesh)
        frames = dev.drain()
        # read frames byte for byte (telemetry frames carry wall times)
        out[name] = (_golden(dev.engine),
                     [(f.read_id, f.payload) for f in frames
                      if f.read_id >= 0],
                     dev.engine.runtime.mesh)
    assert out["two"][2] is not None and out["none"][2] is None
    assert len(out["none"][0]) == 12 and out["none"][1]
    assert out["two"][:2] == out["none"][:2]
