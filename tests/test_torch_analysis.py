"""The port's analysis package against JAX's: the roofline's closed forms
(``model_params``, ``model_flops``, ``kv_cache_bytes``,
``analytic_memory_bytes``) exactly, for all ten archs, smoke and
published, at every shape kind; the report's pure tables (quant, field,
trace) as the same text; the H100 rates the kernel bounds read; and
``utils.shapes``.

JAX's ``_mesh_extents`` fixes the model axis at 16: at data 16 and model
16 (its 256 devices) the port's ``(data, model)`` signature must give its
numbers; at two other meshes JAX's closed form is read with its extents
set to the same pair.
"""
import json

import numpy as np
import pytest
import torch

import torch_port_util as U
import jax.numpy as jnp
from repro.analysis import report as jreport
from repro.analysis import roofline as jroof
from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.utils import shapes as jshapes
from repro_torch.analysis import report, roofline
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.utils import ceil_div, next_multiple, pad_to_multiple

ARCH_NAMES = sorted(ARCHS)
OTHER_MESHES = ((1, 1), (8, 8))


def _cfgs(arch, smoke):
    if smoke:
        return ARCHS[arch].smoke_config(), JARCHS[arch].smoke_config()
    return ARCHS[arch].config(), JARCHS[arch].config()


@pytest.mark.parametrize("smoke", [False, True], ids=["published", "smoke"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_closed_forms_equal_jax(arch, smoke, monkeypatch):
    cfg, jcfg = _cfgs(arch, smoke)
    assert roofline.model_params(cfg) == jroof.model_params(jcfg)
    assert roofline.model_params(cfg, active=True) == \
        jroof.model_params(jcfg, active=True)
    assert SHAPES.keys() == JSHAPES.keys()
    for name, sh in SHAPES.items():
        args = (sh.kind, sh.seq_len, sh.global_batch)
        assert roofline.model_flops(cfg, *args) == \
            jroof.model_flops(jcfg, *args), name
        assert roofline.kv_cache_bytes(cfg, sh.global_batch, sh.seq_len) \
            == jroof.kv_cache_bytes(jcfg, sh.global_batch, sh.seq_len), name
        for fsdp in (False, True):
            for osb in (2, 4):
                kw = dict(grad_accum=ARCHS[arch].accum_for(name), fsdp=fsdp,
                          opt_state_bytes=osb)
                want = jroof.analytic_memory_bytes(jcfg, *args, 256, **kw)
                got = roofline.analytic_memory_bytes(cfg, *args, (16, 16),
                                                     **kw)
                assert got == want, (name, fsdp, osb)
                for d, m in OTHER_MESHES:
                    monkeypatch.setattr(jroof, "_mesh_extents",
                                        lambda n, d=d, m=m: (d, m))
                    want = jroof.analytic_memory_bytes(jcfg, *args, d * m,
                                                       **kw)
                    monkeypatch.undo()
                    assert roofline.analytic_memory_bytes(
                        cfg, *args, (d, m), **kw) == want, (name, d, m)


def test_h100_rates_and_links():
    """The data sheet's rates the kernel bounds in chip_smoke.py read (the
    PERF.md section 6 bounds were computed at these numbers)."""
    assert roofline.PEAKS["sxm"] == {
        "fp32_flops": 67e12, "tf32_flops": 495e12, "bf16_flops": 989e12,
        "int8_ops": 1979e12, "bytes_per_s": 3.35e12}
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12
    assert roofline.peaks_for("NVIDIA H100 80GB HBM3") is \
        roofline.PEAKS["sxm"]
    assert roofline.peaks_for("NVIDIA H100 PCIe") is roofline.PEAKS["pcie"]
    assert roofline.peaks_for("NVIDIA H100 NVL") is roofline.PEAKS["nvl"]
    assert roofline.link_bw(1, 8) == roofline.link_bw(2, 4) == 450e9
    assert roofline.link_bw(8, 8) == roofline.link_bw(1, 16) == 50e9


def test_analyze_terms_at_h100_rates():
    from repro_torch.analysis.cost import WeightedCost
    cfg = ARCHS["qwen3-4b"].config()
    cost = WeightedCost(flops=989e12, hbm_bytes=3.35e12,
                        wire_bytes={"all-reduce": 50e9},
                        collective_ops={"all-reduce": 3})
    sh = SHAPES["prefill_32k"]
    rl = roofline.analyze(cost, cfg, sh.kind, sh.seq_len, sh.global_batch,
                          (8, 8))
    assert rl.compute_s == 1.0 and rl.hlo_memory_s == 1.0
    assert rl.collective_s == 1.0                 # 64 GPUs: the network
    assert rl.memory_s == roofline.analytic_memory_bytes(
        cfg, sh.kind, sh.seq_len, sh.global_batch, (8, 8)) / 3.35e12
    assert rl.dominant == "compute"
    d = rl.as_dict()
    assert d["collective_ops"] == {"all-reduce": 3}
    assert set(d) == {
        "flops_per_device", "bytes_per_device", "hlo_bytes_per_device",
        "wire_bytes_per_device", "compute_s", "memory_s", "hlo_memory_s",
        "collective_s", "dominant", "model_flops_total", "useful_flops_ratio",
        "collective_ops", "collective_wire_bytes"}
    assert d["useful_flops_ratio"] == roofline.model_flops(
        cfg, sh.kind, sh.seq_len, sh.global_batch) / (989e12 * 64)


QUANT_ROWS = [
    {"name": "quant:fp32", "derived": "read_acc=0.91;acc_delta_vs_fp32=0;"
     "host_bases_per_s=1.2e5;soc_pj_per_base=3.1;energy_ratio_vs_fp32=1"},
    {"name": "quant:int8", "derived": "read_acc=0.90;acc_delta_vs_fp32="
     "-0.01;soc_pj_per_base=0.8;energy_ratio_vs_fp32=0.26"},
    {"name": "flowcell:512", "derived": "x=1"},
]
FIELD_ROWS = [
    {"name": "field:e2e", "derived": "devices=4;infected=2;detected=True;"
     "latency_ticks=17;decoy_absent=True"},
    {"name": "field:wire", "derived": "bytes_on_wire=1200;raw_sequenced="
     "90000;reduction_vs_sequenced=75.0;reduction_vs_accepted=12.5;"
     "read_path_reduction=8.1"},
    {"name": "field:conservation", "derived": "accepted_sum=40;"
     "ingested_unique=40;per_device_exact=True;dup_detected=3;late=1"},
    {"name": "field:device:1", "derived": "infected=True;accepted_reads=12;"
     "wire_bytes=400;enrichment=3.2"},
    {"name": "field:device:0", "derived": "infected=False;accepted_reads=9"},
    {"name": "field:variants", "derived": "seeded_snps=6;candidate_sites=9;"
     "recovered_snps=5"},
]


def test_quant_and_field_tables_equal_jax():
    assert report.quant_table(QUANT_ROWS) == jreport.quant_table(QUANT_ROWS)
    assert report.field_tables(FIELD_ROWS) == \
        jreport.field_tables(FIELD_ROWS)
    assert report.field_tables([]) == jreport.field_tables([])


def _port_flowcell_trace() -> dict:
    """A traced run of the port's flowcell engine (adaptive sampling on
    the step encoder, eight reads) on the CPU."""
    import repro_torch.engine as tengine
    from repro_torch.data import genome as G
    from repro_torch.realtime import Decision, PolicyConfig
    n = 6_000
    eng = tengine.build(
        "adaptive_sampling", channels=8, chunk=64,
        reference=G.random_genome(np.random.default_rng(7), n),
        targets=[(0, n // 2)],
        flowcell={"encoder": "step", "n_reads": 8, "read_len": (64, 128),
                  "recovery_samples": 64, "stagger_samples": 16, "seed": 3},
        policy=PolicyConfig(min_prefix_bases=24, map_prefix_bases=32,
                            max_prefix_bases=96, min_mapq=4.0,
                            timeout_decision=Decision.ACCEPT,
                            eject_latency_samples=32),
        device=U.CPU, trace=True)
    with U.one_thread():
        eng.drain(max_steps=20_000)
    return eng.telemetry.tracer.to_chrome()


def test_trace_tables_equal_jax_on_a_port_trace(tmp_path, capsys):
    doc = _port_flowcell_trace()
    text = report.trace_tables(doc)
    assert text == jreport.trace_tables(doc)
    assert "**Per-read spans**" in text and "| ACCEPT |" in text
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(doc))
    report.main(["--section", "trace", "--trace", str(path)])
    assert text in capsys.readouterr().out


def test_report_sections_on_rows(tmp_path, capsys):
    q, f = tmp_path / "q.json", tmp_path / "f.json"
    q.write_text(json.dumps(QUANT_ROWS))
    f.write_text(json.dumps(FIELD_ROWS))
    report.main(["--section", "quant", "--quant", str(q)])
    assert jreport.quant_table(QUANT_ROWS) in capsys.readouterr().out
    report.main(["--section", "field", "--field", str(f)])
    assert jreport.field_tables(FIELD_ROWS) in capsys.readouterr().out
    with pytest.raises(SystemExit, match="not found"):
        report.main(["--section", "quant", "--quant",
                     str(tmp_path / "none.json")])


@pytest.mark.parametrize("seed", range(4))
def test_shapes_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        a, b = int(rng.integers(0, 100)), int(rng.integers(1, 17))
        assert ceil_div(a, b) == jshapes.ceil_div(a, b)
        assert next_multiple(a, b) == jshapes.next_multiple(a, b)
    shape = tuple(int(v) for v in rng.integers(1, 9, size=3))
    x = rng.normal(size=shape).astype(np.float32)
    for axis in (0, 1, 2, -1):
        for mult in (1, 4, 5):
            got = pad_to_multiple(torch.from_numpy(x), mult, axis, value=-2)
            want = jshapes.pad_to_multiple(jnp.asarray(x), mult, axis,
                                           value=-2)
            np.testing.assert_array_equal(U.n(got), np.asarray(want))
