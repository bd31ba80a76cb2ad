"""The port's field deployment (``repro_torch.field``) and its codecs
(``repro_torch.distributed.compression``) against the JAX package's on the
CPU.

Bytes compare byte for byte: 2-bit base packing, read frames, int8 and
top-k codecs (equal magnitudes included: ``jax.lax.top_k`` takes the lower
index first).  The step codec decodes exactly, so ``calibrated_step_params``
and an edge device's uplinked read frames are bitwise JAX's, and so is the
aggregator's surveillance state on the same (duplicated, reordered,
partly undecodable) frame stream.  ``run_field_scenario`` at the field
benchmark's smoke spec (``benchmarks/field.py``) must give JAX's outbreak
call, conservation, variants, per-device accepted reads and read-frame
bytes.  Telemetry frames carry wall times, so their bytes are not
compared."""
import dataclasses
import json
import random

import numpy as np
import pytest
import torch

import torch_port_util as U
from repro.core import pathogen as jpathogen
from repro.distributed import compression as jcomp
from repro.engine.telemetry import Telemetry as JTelemetry
from repro.field import FieldSpec as JSpec
from repro.field import aggregator as jagg
from repro.field import device as jdevice
from repro.field import run_field_scenario as jrun
from repro.field import uplink as jup
from repro.obs import trace as jtrace
from repro_torch.core import pathogen as tpathogen
from repro_torch.distributed import compression as tcomp
from repro_torch.engine.telemetry import Telemetry as TTelemetry
from repro_torch.field import FieldSpec as TSpec
from repro_torch.field import LossyChannel
from repro_torch.field import aggregator as tagg
from repro_torch.field import device as tdevice
from repro_torch.field import run_field_scenario as trun
from repro_torch.field import uplink as tup

# benchmarks/field.py's smoke spec
SMOKE = dict(n_devices=4, n_infected=1, host_len=2000, pathogen_len=1000,
             n_reads=16, min_reads=2, min_abundance=0.01, detect_window=192,
             max_delay_ticks=2, dup_prob=0.1, seed=3)


@dataclasses.dataclass
class FakeRecord:
    """Just the ReadRecord fields the uplink codec reads."""
    read_id: int
    bases: np.ndarray
    mapped_pos: int = -1
    samples_at_decision: int = 256
    samples_sequenced: int = 256
    total_samples: int = 512


# ---------------------------------------------------------------- codecs --
@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 7, 8, 33, 128, 1001])
def test_pack_bases_bytewise(n):
    tokens = np.random.default_rng(n).integers(1, 5, n).astype(np.int32)
    buf = tup.pack_bases(tokens)
    assert buf == jup.pack_bases(tokens) and len(buf) == (n + 3) // 4
    np.testing.assert_array_equal(tup.unpack_bases(buf, n), tokens)


@pytest.mark.parametrize("seed", range(4))
def test_read_frame_bytes_equal_jax(seed):
    rng = np.random.default_rng(seed)
    rec = FakeRecord(read_id=int(rng.integers(0, 500)),
                     bases=rng.integers(1, 5, int(rng.integers(1, 300))),
                     mapped_pos=int(rng.integers(-1, 9000)),
                     samples_at_decision=300, samples_sequenced=388,
                     total_samples=512)
    frame = tup.read_frame(3, 42 + seed, rec)
    assert frame.to_bytes() == jup.read_frame(3, 42 + seed, rec).to_bytes()
    back = jup.decode_read(jup.UplinkFrame.from_bytes(frame.to_bytes()))
    np.testing.assert_array_equal(back.bases, rec.bases)
    sig = rng.normal(size=512).astype(np.float32) * 3.0
    snip = tup.read_frame(1, 2, rec, signal=sig, signal_snippet=64)
    assert snip.to_bytes() == jup.read_frame(
        1, 2, rec, signal=sig, signal_snippet=64).to_bytes()
    dec = tup.decode_read(snip)
    np.testing.assert_array_equal(dec.signal,
                                  jup.decode_read(snip).signal)


def test_bad_frames_raise():
    rec = FakeRecord(read_id=0, bases=np.array([1, 2, 3]))
    good = tup.read_frame(0, 0, rec).to_bytes()
    with pytest.raises(ValueError):
        tup.UplinkFrame.from_bytes(b"\x00\x00" + good[2:])
    with pytest.raises(ValueError):
        tup.UplinkFrame.from_bytes(good[:-1])
    tel = tup.telemetry_frame(0, 1, TTelemetry(workload="x"))
    with pytest.raises(ValueError):
        tup.decode_read(tel)


def test_telemetry_frames_cross_packages():
    t = TTelemetry(workload="adaptive_sampling")
    t.completed, t.bases, t.wall_s = 5, 500, 1.5
    t.observe_latency(3.0, 2.0)
    t.count("accepted", 4)
    back = jup.decode_telemetry(
        jup.UplinkFrame.from_bytes(tup.telemetry_frame(4, 9, t).to_bytes()))
    assert back.summary() == t.summary()
    j = JTelemetry(workload="adaptive_sampling")
    j.completed, j.bases = 3, 300
    again = tup.decode_telemetry(jup.telemetry_frame(1, 1, j))
    assert again.summary() == j.summary()


def _tied(seed, n=1000):
    x = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    x[::7] = x[0]
    x[3::11] = -x[0]
    x[5::13] = 0.0
    return x


@pytest.mark.parametrize("seed", range(3))
def test_compress_int8_bytewise(seed):
    x = _tied(seed) * (seed + 1)
    q, s = tcomp.compress_int8(torch.from_numpy(x))
    jq, js = jcomp.compress_int8(x)
    assert q.dtype == torch.int8
    assert q.numpy().tobytes() == np.asarray(jq).tobytes()
    assert float(s) == float(js)
    np.testing.assert_array_equal(tcomp.decompress_int8(q, s).numpy(),
                                  np.asarray(jcomp.decompress_int8(jq, js)))
    zero_q, zero_s = tcomp.compress_int8(torch.zeros(8))
    assert float(zero_s) == float(jcomp.compress_int8(np.zeros(8))[1])


@pytest.mark.parametrize("frac", [0.001, 0.01, 0.1, 0.5, 1.0])
def test_compress_topk_bytewise_ties_included(frac):
    x = _tied(7)
    vals, idx, n = tcomp.compress_topk(torch.from_numpy(x), frac)
    jv, ji, jn = jcomp.compress_topk(x, frac)
    assert n == jn
    assert idx.dtype == torch.int32
    assert idx.numpy().tobytes() == np.asarray(ji).tobytes()
    assert vals.numpy().tobytes() == np.asarray(jv).tobytes()
    back = tcomp.decompress_topk(vals, idx, n, (n,))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jcomp.decompress_topk(jv, ji, jn, (jn,))))
    tv, ti, tn = tup.encode_signal_topk(x, frac)
    np.testing.assert_array_equal(tup.decode_signal_topk(tv, ti, tn), back)


@pytest.mark.parametrize("kind", ["none", "int8", "topk"])
def test_apply_compression_and_wire_bytes_equal_jax(kind):
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    grads = {"a": rng.normal(size=(40, 3)).astype(np.float32),
             "b": {"c": _tied(2, 64)}}
    cfg_t = tcomp.CompressionConfig(kind=kind, topk_frac=0.1)
    cfg_j = jcomp.CompressionConfig(kind=kind, topk_frac=0.1)
    tg = {"a": torch.from_numpy(grads["a"]),
          "b": {"c": torch.from_numpy(grads["b"]["c"])}}
    jg = {"a": jnp.asarray(grads["a"]), "b": {"c": jnp.asarray(
        grads["b"]["c"])}}
    res_t, res_j = tcomp.init_residual(tg), jcomp.init_residual(jg)
    for _ in range(3):      # error feedback carries across steps
        out_t, res_t = tcomp.apply_compression(tg, res_t, cfg_t)
        out_j, res_j = jcomp.apply_compression(jg, res_j, cfg_j)
        for path in (("a",), ("b", "c")):
            got_t, got_j, r_t, r_j = out_t, out_j, res_t, res_j
            for k in path:
                got_t, got_j = got_t[k], got_j[k]
                r_t, r_j = r_t[k], r_j[k]
            np.testing.assert_array_equal(U.n(got_t), np.asarray(got_j))
            np.testing.assert_array_equal(U.n(r_t), np.asarray(r_j))
    assert tcomp.wire_bytes(tg, cfg_t) == jcomp.wire_bytes(jg, cfg_j)


# ------------------------------------------------------------ the device --
def test_calibrated_step_params_bitwise():
    tcfg, tq = tdevice.calibrated_step_params(128, seed=5, device=U.CPU)
    jcfg, jq = jdevice.calibrated_step_params(128, seed=5)
    assert (tcfg.kernels, tcfg.channels, tcfg.strides) == \
        (jcfg.kernels, jcfg.channels, jcfg.strides)
    for layer in ("conv1", "conv2"):
        tw, jw = tq[layer]["w"], jq[layer]["w"]
        np.testing.assert_array_equal(U.n(tw.q), np.asarray(jw.q))
        np.testing.assert_array_equal(U.n(tw.scale), np.asarray(jw.scale))
        assert float(tw.act_scale) == float(jw.act_scale)
        np.testing.assert_array_equal(U.n(tq[layer]["b"]),
                                      np.asarray(jq[layer]["b"]))


def _edge(mod, **kw):
    from repro.data import genome as G
    rng = np.random.default_rng(5)
    host = G.random_genome(rng, 1500)
    sample, _ = G.mutate(rng, host, G.MutationProfile(
        snp_rate=0.03, ins_rate=0.0, del_rate=0.0))
    return mod.EdgeDevice(0, sample, [(0, len(host))], channels=8,
                          chunk=128, n_reads=16, read_len=(96, 160),
                          seed=7, **kw), sample


def test_edge_device_read_frames_equal_jax():
    tdev, sample = _edge(tdevice, device=U.CPU)
    jdev, _ = _edge(jdevice)
    with U.one_thread():
        tframes = [f for f in tdev.drain() if f.kind == tup.KIND_READ]
    jframes = [f for f in jdev.drain() if f.kind == jup.KIND_READ]
    assert len(tframes) == len(jframes) == tdev.accepted_reads > 0
    assert [f.to_bytes() for f in tframes] == [f.to_bytes() for f in jframes]
    assert tdev.full_read_uplinks == jdev.full_read_uplinks == \
        tdev.accepted_reads
    assert tdev.wire_read_bytes == jdev.wire_read_bytes
    assert tdev.raw_signal_bytes == jdev.raw_signal_bytes
    # the full reads are the molecules' true sequences
    src = tdev.engine.flowcell
    for f in tframes:
        dec = tup.decode_read(f)
        read = src.peek_read(dec.read_id)
        truth = sample[read.position: read.position + len(read.signal) // 4]
        np.testing.assert_array_equal(dec.bases, truth)
    with pytest.raises(ValueError):
        src.peek_read(10_000)


# -------------------------------------------------------- the aggregator --
PAD_LEN = 64
GENOME_LEN = 300


def _panel_genomes(seed=11):
    rng = np.random.default_rng(seed)
    host = rng.integers(1, 5, GENOME_LEN).astype(np.int32)
    px = rng.integers(1, 5, GENOME_LEN).astype(np.int32)
    py = rng.integers(1, 5, GENOME_LEN).astype(np.int32)
    return {"px": px, "py": py}, host, px


def _frames(rng, host, px, n_devices):
    """Unique read + telemetry frames: pathogen reads, host reads (mapped,
    feeding the pileup) and noise, built with the port's codec."""
    frames = []
    for d in range(n_devices):
        seq = 0
        for i in range(rng.randint(3, 6)):
            kind = rng.random()
            length = rng.randint(36, PAD_LEN)
            if kind < 0.4:
                start = rng.randint(0, GENOME_LEN - length)
                bases, pos = px[start:start + length], -1
            elif kind < 0.8:
                start = rng.randint(0, GENOME_LEN - length)
                bases, pos = host[start:start + length], start
            else:
                bases = np.array([rng.randint(1, 4) for _ in range(length)],
                                 np.int32)
                pos = -1
            rec = FakeRecord(read_id=i, bases=np.asarray(bases, np.int32),
                             mapped_pos=pos,
                             samples_at_decision=length * 4,
                             samples_sequenced=length * 4,
                             total_samples=length * 8)
            frames.append(tup.read_frame(d, seq, rec).to_bytes())
            seq += 1
        tel = TTelemetry(workload="adaptive_sampling")
        tel.completed = seq
        frames.append(tup.telemetry_frame(d, seq, tel).to_bytes())
    return frames


def _aggregators(genomes, host):
    det_t = tpathogen.DetectConfig(window=96, min_reads=2, min_abundance=0.01)
    det_j = jpathogen.DetectConfig(window=96, min_reads=2, min_abundance=0.01)
    return (tagg.AggregatorEngine(
                tpathogen.Panel.build(genomes, with_index=False),
                genome=host, detect_cfg=det_t, pad_len=PAD_LEN,
                device=U.CPU),
            jagg.AggregatorEngine(
                jpathogen.Panel.build(genomes, with_index=False),
                genome=host, detect_cfg=det_j, pad_len=PAD_LEN))


def _state(agg):
    rep = agg.detector.report()
    summ = agg.summary()
    return {"present": rep.present, "counts": rep.counts,
            "assignment": np.asarray(rep.read_assignment).tolist(),
            "scores": np.asarray(rep.read_scores).tolist(),
            "reads": agg.reads_ingested,
            "device_reads": dict(agg.device_reads),
            "pileup": agg.pileup.counts.tolist(),
            "n_pileup_reads": agg.pileup.n_reads,
            "counters": dict(agg.telemetry.counters),
            "surveillance": summ["surveillance"],
            "variants": summ["variants"],
            "rollup": agg.fleet_rollup().completed}


@pytest.mark.parametrize("seed", range(3))
def test_aggregator_equals_jax_on_a_lossy_stream(seed):
    rng = random.Random(seed)
    genomes, host, px = _panel_genomes()
    frames = _frames(rng, host, px, n_devices=rng.randint(2, 4))
    stream = list(frames)
    rng.shuffle(stream)
    dups = [f for f in frames if rng.random() < 0.4]
    stream += dups + [b"junk-bytes", b"", frames[0][:-1]]
    rng.shuffle(stream)
    groups = []
    i = 0
    while i < len(stream):
        n = rng.randint(1, 5)
        groups.append(stream[i:i + n])
        i += n
    aggs = _aggregators(genomes, host)
    for agg in aggs:
        for group in groups:
            for f in group:
                agg.submit(f)
            agg.step()
        agg.drain()
    got, want = (_state(a) for a in aggs)
    assert got == want
    assert got["counters"]["frames.dup"] == len(dups)
    assert got["counters"]["frames.decode_error"] == 3
    assert got["reads"] == sum(1 for f in frames
                               if tup.UplinkFrame.from_bytes(f).kind
                               == tup.KIND_READ)


def test_aggregator_builder_and_registry():
    import repro_torch.engine as te
    agg = te.build("field_aggregator", "smoke", device=U.CPU)
    assert isinstance(agg, tagg.AggregatorEngine)
    assert agg.step() is False
    assert set(agg.panel.names) == {"pathogen-a", "pathogen-b"}
    assert "field_aggregator" in te.workloads()


# -------------------------------------------------------- the scenario ----
def test_lossy_channel_draws_like_jax():
    from repro.field import LossyChannel as JChannel
    frames = [tup.UplinkFrame(0, i, tup.KIND_READ, i, b"x" * i)
              for i in range(40)]
    t, j = LossyChannel(17, max_delay_ticks=3, dup_prob=0.3), \
        JChannel(17, max_delay_ticks=3, dup_prob=0.3)
    out_t, out_j = [], []
    for tick in range(12):
        t.send(frames[tick * 3:tick * 3 + 3], tick)
        j.send(frames[tick * 3:tick * 3 + 3], tick)
        out_t.append([(f.seq, f.read_id) for f in t.deliver(tick)])
        out_j.append([(f.seq, f.read_id) for f in j.deliver(tick)])
    assert out_t == out_j
    assert t.frames_duplicated == j.frames_duplicated > 0


@pytest.fixture(scope="module")
def smoke_runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("field") / "trace_field.json"
    # the port's scenario is a long chain of small CPU ops: one intra-op
    # thread, so the test workers beside it do not thrash the cores
    with U.one_thread():
        port = trun(TSpec(**SMOKE), trace_path=str(path), device=U.CPU)
    return port, jrun(JSpec(**SMOKE)), path


@pytest.mark.parametrize("key", ["outbreak", "conservation", "variants",
                                 "ticks"])
def test_field_scenario_equals_jax(smoke_runs, key):
    port, jax_, _ = smoke_runs
    assert port[key] == jax_[key]


def test_field_scenario_devices_and_wire_equal_jax(smoke_runs):
    port, jax_, _ = smoke_runs
    assert [d["accepted_reads"] for d in port["per_device"]] == \
        [d["accepted_reads"] for d in jax_["per_device"]]
    for key in ("read_frame_bytes", "raw_signal_bytes_accepted",
                "raw_signal_bytes_sequenced", "frames_duplicated"):
        assert port["wire"][key] == jax_["wire"][key], key
    assert port["outbreak"]["detected"] and port["outbreak"]["decoy_absent"]
    assert port["conservation"]["per_device_exact"]
    wire = port["wire"]
    assert wire["bytes_on_wire"] == (wire["read_frame_bytes"]
                                     + wire["telemetry_frame_bytes"])
    assert port["fleet_rollup"]["devices_reporting"] == 4


def test_field_trace_validates_with_device_and_aggregator_tracks(smoke_runs):
    port, _, path = smoke_runs
    doc = json.loads(path.read_text())
    assert jtrace.validate_chrome_trace(doc) == []
    names = [e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"]
    assert sum(n.startswith("adaptive_sampling") for n in names) == 4
    assert "tenant:aggregator (field_aggregator)" in names
    assert port["trace"]["events"] > 0
    # one read span per molecule of every device
    assert len(jtrace.read_spans(doc)) == SMOKE["n_devices"] * SMOKE["n_reads"]
