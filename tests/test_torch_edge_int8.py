"""The paper's int8 edge path through the engine API, against the JAX
engines on the CPU: the ``edge_int8`` adaptive-sampling flowcell (per-read
goldens, fused and unfused, pipeline depth 1 and 2), the ``basecall``
workload (float and ``edge_int8`` reads), summaries and dispatch counters
key for key, the ``soc_energy_*`` block, and the ``fused=None`` default.
JAX's quantized params are carried across, so both packages serve the same
int8 weights and scales.

The flowcell runs the step codec in two int8 forms: as the ``edge_int8``
preset builds it (activation scales calibrated on normal noise, which
clips the codec's levels: every read times out or runs dry), and
calibrated on the codec's own signal (reads map, and are accepted or
ejected)."""
import jax
import numpy as np
import pytest
import torch

import torch_port_util as U
import repro.engine as jengine
import repro_torch.engine as tengine
from repro.core import basecaller as jbc
from repro.data import flowcell as jfc
from repro.data import genome as jG
from repro.realtime import Decision as JDecision
from repro.realtime import PolicyConfig as JPolicy
from repro_torch.core import basecaller as tbc
from repro_torch.realtime import Decision as TDecision
from repro_torch.realtime import PolicyConfig as TPolicy
from repro_torch.realtime import runtime as trt

SEED = 3
GENOME_LEN = 6_000
FLOWCELL = {"encoder": "step", "n_reads": 24, "read_len": (64, 128),
            "recovery_samples": 64, "stagger_samples": 16, "seed": SEED}
ENERGY = ("soc_energy_precision", "soc_energy_est_j",
          "soc_energy_ratio_vs_fp32")


def _reference():
    return jG.random_genome(np.random.default_rng(7), GENOME_LEN)


def _policy(cls, decision):
    return cls(min_prefix_bases=24, map_prefix_bases=32, max_prefix_bases=96,
               min_mapq=4.0, timeout_decision=decision.ACCEPT,
               eject_latency_samples=32)


def _golden(engine):
    return [(r.read_id, r.decision.value, r.reason, r.bases_at_decision,
             r.mapped_pos)
            for r in sorted(engine.records, key=lambda r: r.read_id)]


def _fabric(rep):
    return {k: v for k, v in rep.items() if k.startswith("fabric.")}


def _signal_calibrated():
    """The step codec calibrated on step-encoded reference signal."""
    cfg, params = jfc.step_basecaller()
    ref = _reference()
    chunks = [jfc.step_encode(ref[i:i + 200])[None, :512]
              for i in range(0, 4000, 1000)]
    return {"params": jbc.quantize(params, cfg, chunks=chunks,
                                   observer="percentile", pct=99.9),
            "cfg": cfg}


def _jax_edge(fused, calibration):
    extra = _signal_calibrated() if calibration == "signal" else {}
    return jengine.build(
        "adaptive_sampling", preset="edge_int8", channels=8, chunk=64,
        reference=_reference(), targets=[(0, GENOME_LEN // 2)],
        flowcell=dict(FLOWCELL), policy=_policy(JPolicy, JDecision),
        fabric="reference", fused=fused, **extra)


@pytest.fixture(scope="module", params=["preset", "signal"])
def jax_edge(request):
    runs = {"calibration": request.param}
    for fused in (True, False):
        eng = _jax_edge(fused, request.param)
        rep = eng.drain(max_steps=20_000)
        runs[fused] = {"golden": _golden(eng), "report": rep,
                       "bases": eng.telemetry.bases}
    eng = _jax_edge(True, request.param)
    runs["params"] = tbc.load_numpy_params(
        jax.tree.map(np.asarray, eng.runtime.params), U.CPU)
    runs["cfg"] = eng.runtime.cfg
    return runs


def _port_edge(jax_edge, *, fused, depth=1):
    jcfg = jax_edge["cfg"]
    cfg = tbc.BasecallerConfig(kernels=jcfg.kernels, channels=jcfg.channels,
                               strides=jcfg.strides)
    return tengine.build(
        "adaptive_sampling", preset="edge_int8", params=jax_edge["params"],
        cfg=cfg, channels=8, chunk=64, reference=_reference(),
        targets=[(0, GENOME_LEN // 2)], flowcell=dict(FLOWCELL),
        policy=_policy(TPolicy, TDecision), device=U.CPU, fused=fused,
        pipeline_depth=depth)


def test_jax_edge_params_are_calibrated_int8(jax_edge):
    for layer in jax_edge["params"].values():
        w = layer["w"]
        assert w.q.dtype == torch.int8 and w.act_scale is not None


@pytest.mark.parametrize("fused,depth", [(True, 1), (True, 2), (False, 1),
                                         (False, 2)])
def test_edge_int8_goldens_match_jax(jax_edge, fused, depth):
    eng = _port_edge(jax_edge, fused=fused, depth=depth)
    rep = eng.drain(max_steps=20_000)
    want = jax_edge[fused]
    golden = _golden(eng)
    assert len(golden) == 24
    reasons = {g[2] for g in golden}
    if jax_edge["calibration"] == "signal":
        assert {g[1] for g in golden} == {"accept", "eject"}
    else:
        assert reasons <= {"timeout", "exhausted"}
    assert golden == want["golden"]
    assert golden == jax_edge[not fused]["golden"]
    jrep = want["report"]
    for key in ("reads", "accepted", "ejected", "timeouts", "exhausted"):
        assert rep[key] == jrep[key], key
    assert eng.telemetry.bases == want["bases"]
    # the JAX runs are depth 1; at depth 2 an eject lands a tick later, so
    # more signal is sequenced and the energy estimate grows with it
    for key in ENERGY if depth == 1 else ENERGY[::2]:
        assert rep[key] == jrep[key], key
    assert rep["soc_energy_precision"] == "int8"


@pytest.mark.parametrize("fused", [True, False])
def test_edge_int8_counters_match_jax_key_for_key(jax_edge, fused):
    rep = _port_edge(jax_edge, fused=fused).drain(max_steps=20_000)
    assert _fabric(rep) == _fabric(jax_edge[fused]["report"])
    assert rep["fabric.precision.conv1d.int8"] > 0


def test_edge_int8_preset_quantizes_at_build():
    eng = tengine.build("adaptive_sampling", preset="edge_int8",
                        device=U.CPU, channels=4, chunk=64)
    w = eng.runtime.params["conv5"]["w"]
    assert w.q.dtype == torch.int8 and w.act_scale is not None
    assert eng.runtime.fused          # the preset asks for the fused step
    assert eng.summary()["soc_energy_precision"] == "int8"


# ---------------------------------------------------------------- basecall --
@pytest.fixture(scope="module")
def signal():
    return np.random.default_rng(5).standard_normal((6, 512)).astype(
        np.float32)


@pytest.mark.parametrize("preset", ["smoke", "edge_int8"])
def test_basecall_reads_match_jax(signal, preset):
    """Six rows in batches of 4 at chunk 512 through the paper's CNN
    (weights from JAX's seed 0): the decoded reads, the summary counters
    and the energy block.  The float reads are compared whole: the random
    CNN left no frame whose top-2 logit margin is within float32 reach."""
    over = {"chunk": 512, "batch": 4}
    jeng = jengine.build("basecall", preset=preset, fabric="reference",
                         **over)
    params = tbc.load_numpy_params(jax.tree.map(np.asarray, jeng.params),
                                   U.CPU)
    teng = tengine.build("basecall", preset=preset, params=params,
                         device=U.CPU, **over)
    want = jeng.serve(signal)
    got = teng.serve(signal)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    jrep, trep = jeng.summary(), teng.summary()
    for key in ("completed", "steps", "dispatches", "workload", *ENERGY):
        assert trep[key] == jrep[key], key
    assert teng.telemetry.bases == jeng.telemetry.bases
    assert teng.telemetry.samples == jeng.telemetry.samples
    assert _fabric(trep) == _fabric(jrep)
    want_precision = "int8" if preset == "edge_int8" else "fp32"
    assert trep["soc_energy_precision"] == want_precision


def test_basecall_presets_and_own_calibration():
    assert set(tengine.presets("basecall")) == {"default", "smoke",
                                                "edge_int8"}
    eng = tengine.build("basecall", preset="edge_int8", device=U.CPU,
                        batch=2, chunk=256)
    assert eng.params["conv1"]["w"].act_scale is not None
    reads = eng.serve(np.zeros((3, 256), np.float32))
    assert len(reads) == 3 and all(r.dtype == np.int32 for r in reads)


# ----------------------------------------------------------------- repairs --
def test_float_summary_carries_soc_energy():
    """Repair: every basecalling engine's summary has the energy block,
    float ones too, equal to JAX's."""
    jeng = jengine.build("adaptive_sampling", preset="smoke",
                         fabric="reference")
    params = tbc.load_numpy_params(
        jax.tree.map(np.asarray, jeng.runtime.params), U.CPU)
    teng = tengine.build("adaptive_sampling", preset="smoke", params=params,
                         device=U.CPU)
    rng = np.random.default_rng(1)
    for i in range(3):
        sig = rng.standard_normal(400).astype(np.float32)
        jeng.submit(sig, read_id=i)
        teng.submit(sig, read_id=i)
    jrep, trep = jeng.drain(), teng.drain()
    assert trep["soc_energy_precision"] == "fp32"
    for key in ENERGY:
        assert trep[key] == jrep[key], key
        assert teng.summary()[key] == jeng.summary()[key], key


def test_fused_none_resolves_to_the_card():
    """Repair: ``fused=None`` (the builder's and runtime's default) fuses
    exactly on a CUDA device, as JAX fuses where the op has a Pallas
    target; an explicit choice wins."""
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert trt.resolve_fused(None, cuda) is True
    assert trt.resolve_fused(None, cpu) is False
    assert trt.resolve_fused(False, cuda) is False
    assert trt.resolve_fused(True, cpu) is True
    eng = tengine.build("adaptive_sampling", preset="smoke", device=U.CPU)
    assert eng.runtime.fused is False
    eng = tengine.build("adaptive_sampling", preset="smoke", device=U.CPU,
                        fused=True)
    assert eng.runtime.fused is True
