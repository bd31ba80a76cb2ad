"""The genomics pipeline's CORE helpers and the ``pathogen_pipeline``
engine, the port against the JAX package on the CPU.

``normalize_chunk``, ``demux_reads`` and ``trim_primer`` are bitwise.  The
engine runs the small CNN of ``tests/test_genomics_pipeline.py`` with JAX's
params carried across: ``edge_int8`` tokens bitwise against JAX's jitted
engine (JAX's quantized params, so both serve the same int8 weights and
scales), ``default`` tokens under the margin rule (a frame may differ only
where JAX's top-2 logit margin is < 1e-4), and the counters, fabric keys
and ``soc_energy_*`` block equal."""
import jax
import numpy as np
import pytest
import torch

import torch_port_util as U
import repro.engine as jengine
import repro_torch.engine as tengine
from repro.core import basecaller as jbc
from repro.core import pathogen as jpath
from repro.core import pipeline as jpipe
from repro.data import genome as jG
from repro_torch.core import basecaller as tbc
from repro_torch.core import pathogen as tpath
from repro_torch.core import pipeline as tpipe

ENERGY = ("soc_energy_precision", "soc_energy_est_j",
          "soc_energy_ratio_vs_fp32")
MARGIN = 1e-4
SMALL = dict(kernels=(3, 3, 1), channels=(16, 16, 5), strides=(1, 2, 1))


def _barcoded(seed, n_reads=40, n_bar=6, width=60):
    """Reads whose first 12 bases are one of ``n_bar`` barcodes, every other
    read with one substitution, and a few with no barcode at all."""
    rng = np.random.default_rng(seed)
    barcodes = rng.integers(1, 5, (n_bar, 12)).astype(np.int32)
    barcodes[1] = barcodes[0]                  # a tie: the first must win
    reads = rng.integers(1, 5, (n_reads, width)).astype(np.int32)
    owners = rng.integers(0, n_bar, n_reads)
    for i, o in enumerate(owners):
        if i % 7 == 6:
            continue                           # noise prefix
        reads[i, :12] = barcodes[o]
        if i % 2 == 0:
            reads[i, 3] = (reads[i, 3] % 4) + 1
    return reads, barcodes


def test_normalize_chunk_bitwise():
    x = np.random.default_rng(0).normal(3.0, 2.0, (5, 301)).astype(
        np.float32)
    np.testing.assert_array_equal(tpipe.normalize_chunk(x),
                                  jpipe.normalize_chunk(x))


@pytest.mark.parametrize("target", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("max_dist", [1, 3])
def test_demux_reads_bitwise(target, max_dist):
    reads, barcodes = _barcoded(3)
    got = tpipe.demux_reads(reads, barcodes, max_dist=max_dist,
                            device=U.CPU)
    want = jpipe.demux_reads(reads, barcodes, max_dist=max_dist,
                             fabric=target)
    np.testing.assert_array_equal(got, want)
    assert (got == -1).any() and (got >= 0).any()
    assert 1 not in got.tolist()               # tie with barcode 0


def test_demux_assigns_barcodes():
    """``tests/test_genomics_pipeline.py``'s example on the port."""
    rng = np.random.default_rng(6)
    barcodes = rng.integers(1, 5, (4, 12)).astype(np.int32)
    reads = np.zeros((8, 60), np.int32)
    owners = rng.integers(0, 4, 8)
    for i, o in enumerate(owners):
        reads[i, :12] = barcodes[o]
        reads[i, 12:] = rng.integers(1, 5, 48)
        if i % 2 == 0:
            reads[i, 3] = (reads[i, 3] % 4) + 1
    got = tpipe.demux_reads(reads, barcodes, max_dist=3, device=U.CPU)
    np.testing.assert_array_equal(got, owners)


@pytest.mark.parametrize("primer", [0, 2, 12, 70])
def test_trim_primer_bitwise(primer):
    rng = np.random.default_rng(primer)
    toks = rng.integers(0, 5, (6, 64)).astype(np.int32)
    lens = rng.integers(0, 65, 6)
    got = tpipe.trim_primer(toks, lens, primer)
    want = jpipe.trim_primer(toks, lens, primer)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_pipeline_config_defaults():
    assert tpipe.PipelineConfig() == tpipe.PipelineConfig(
        **vars(jpipe.PipelineConfig()))


# ------------------------------------------------------------------ engine --
def _chunks(n=3, channels=4, samples=512):
    rng = np.random.default_rng(7)
    return [rng.normal(size=(channels, samples)).astype(np.float32)
            for _ in range(n)]


def _panel(cls):
    rng = np.random.default_rng(3)
    return cls.build({"virusA": jG.random_genome(rng, 600),
                      "virusB": jG.random_genome(rng, 400)})


@pytest.fixture(scope="module", params=["default", "edge_int8"])
def jax_run(request):
    cfg = jbc.BasecallerConfig(**SMALL)
    params = jbc.init(jax.random.key(0), cfg)
    eng = jengine.build("pathogen_pipeline", preset=request.param,
                        params=params, cfg=cfg, fabric="reference",
                        panel=_panel(jpath.Panel),
                        detect_cfg=jpath.DetectConfig(window=64))
    for c in _chunks():
        eng.submit(c)
    rep = eng.drain()
    logits = [np.asarray(jbc.apply(eng.params, jax.numpy.asarray(
        jpipe.normalize_chunk(c)), cfg, fabric="reference"))
        for c in _chunks()]
    return {"preset": request.param, "report": rep,
            "outputs": list(eng.outputs), "logits": logits,
            "tel": eng.telemetry, "detect": eng.detect(32),
            "params": tbc.load_numpy_params(
                jax.tree.map(np.asarray, eng.params), U.CPU)}


def _port(jax_run, depth=2):
    eng = tengine.build("pathogen_pipeline", preset=jax_run["preset"],
                        params=jax_run["params"],
                        cfg=tbc.BasecallerConfig(**SMALL), depth=depth,
                        panel=_panel(tpath.Panel),
                        detect_cfg=tpath.DetectConfig(window=64),
                        device=U.CPU)
    for c in _chunks():
        eng.submit(c)
    return eng, eng.drain()


def _top2_margin(logits):
    top = np.sort(logits, axis=-1)
    return top[..., -1] - top[..., -2]


def test_engine_tokens_match_jax(jax_run):
    eng, _ = _port(jax_run)
    assert len(eng.outputs) == len(jax_run["outputs"]) == 3
    for k, ((tok, lens), (jtok, jlens)) in enumerate(
            zip(eng.outputs, jax_run["outputs"])):
        assert tok.dtype == np.int32 and lens.dtype == np.int32
        if jax_run["preset"] == "edge_int8" or (
                np.array_equal(tok, jtok) and np.array_equal(lens, jlens)):
            np.testing.assert_array_equal(tok, np.asarray(jtok))
            np.testing.assert_array_equal(lens, np.asarray(jlens))
            continue
        # margin rule: every frame whose class differs is a near tie
        jl = jax_run["logits"][k]
        sig = torch.from_numpy(tpipe.normalize_chunk(_chunks()[k]))
        tl = U.n(tbc.apply(eng.params, sig, eng.cfg))
        split = tl.argmax(-1) != jl.argmax(-1)
        assert split.any()
        assert (_top2_margin(jl)[split] < MARGIN).all()


def test_engine_counters_and_energy_match_jax(jax_run):
    eng, rep = _port(jax_run)
    jrep, jtel = jax_run["report"], jax_run["tel"]
    for key in ("workload", "steps", "dispatches", "completed", "chunks",
                "in_flight", *ENERGY):
        assert rep[key] == jrep[key], key
    tel = eng.telemetry
    assert (tel.bases, tel.samples) == (jtel.bases, jtel.samples)
    assert tel.counters["chunks"] == 3 and tel.samples == 3 * 4 * 512
    assert ({k: v for k, v in rep.items() if k.startswith("fabric.")}
            == {k: v for k, v in jrep.items() if k.startswith("fabric.")})
    assert set(k for k in rep if k.startswith("stage_")) == {
        "stage_normalize_s", "stage_basecall_s", "stage_decode_s"}
    want = "int8" if jax_run["preset"] == "edge_int8" else "fp32"
    assert rep["soc_energy_precision"] == want


def test_engine_detect_matches_jax(jax_run):
    eng, _ = _port(jax_run)
    got = eng.detect(32)
    want = jax_run["detect"]
    assert got.counts == want.counts and got.present == want.present
    np.testing.assert_array_equal(got.read_assignment, want.read_assignment)
    np.testing.assert_array_equal(got.read_scores, want.read_scores)
    assert "stage_classify_s" in eng.summary()
    assert eng.summary()["fabric.dispatch.banded_align.reference"] == 2


@pytest.mark.parametrize("depth", [1, 3])
def test_engine_depth_keeps_order(jax_run, depth):
    """Any in-flight bound yields the same reads in submit order."""
    eng, rep = _port(jax_run, depth=depth)
    ref_eng, _ = _port(jax_run)
    for (a, la), (b, lb) in zip(eng.outputs, ref_eng.outputs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    assert rep["steps"] == 3 and eng.scheduler.n_busy == 0


def test_reads_are_fixed_width(jax_run):
    eng, _ = _port(jax_run)
    reads = eng.reads(40)
    assert reads.shape == (12, 40) and reads.dtype == np.int32
    tok, lens = eng.outputs[0]
    n0 = min(int(lens[0]), 40)
    np.testing.assert_array_equal(reads[0, :n0], tok[0, :n0])
    assert (reads[0, n0:] == 0).all()


def test_presets_and_errors(monkeypatch):
    assert set(tengine.presets("pathogen_pipeline")) == {
        "default", "smoke", "edge_int8"}
    assert "pathogen_pipeline" in tengine.workloads()
    eng = tengine.build("pathogen_pipeline", preset="smoke",
                        cfg=tbc.BasecallerConfig(**SMALL), device=U.CPU)
    assert eng.scheduler.slots == 2 and eng.device == torch.device("cpu")
    assert eng.reads(8).shape == (0, 8)
    with pytest.raises(ValueError, match="panel"):
        eng.detect(8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.build("pathogen_pipeline", cfg=tbc.BasecallerConfig(**SMALL))


def test_edge_int8_build_calibrates_at_chunk_2048():
    """``build("pathogen_pipeline", preset="edge_int8")`` calibrates at
    chunk 2048, as JAX's does: the activation scales equal a direct
    ``quantize_edge_params`` call at 2048 on the same float params, not at
    the 512 that ``adaptive_sampling`` uses."""
    from repro_torch.engine.base import quantize_edge_params
    cfg = tbc.BasecallerConfig(**SMALL)
    params = tbc.init(torch.Generator().manual_seed(0), cfg, device=U.CPU)
    eng = tengine.build("pathogen_pipeline", preset="edge_int8",
                        params=params, cfg=cfg, device=U.CPU)
    want = quantize_edge_params(params, cfg, chunk=2048)
    other = quantize_edge_params(params, cfg, chunk=512)
    got = [float(eng.params[k]["w"].act_scale) for k in sorted(want)]
    assert got == [float(want[k]["w"].act_scale) for k in sorted(want)]
    assert got != [float(other[k]["w"].act_scale) for k in sorted(want)]
