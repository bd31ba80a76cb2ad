"""End-to-end field surveillance: N edge sequencers, one aggregator
(``repro/field/scenario.py``).

The three workloads the repo grew separately (flowcell Read-Until,
pathogen detection, variant calling) composed into one deployment:

  * a shared **outbreak sample**: the host reference with seeded SNPs;
    ``n_infected`` of the ``n_devices`` sequencers additionally carry the
    pathogen (its genome is appended to their flowcell's reference and to
    their Read-Until target panel, so infected devices *enrich* for
    pathogen reads — the adaptive-sampling story);
  * every device streams accepted reads as compressed uplink frames
    through a seeded :class:`LossyChannel` (reordering, duplication,
    optional mid-run dropout);
  * a :class:`~repro_torch.fleet.Fleet`-hosted
    :class:`~repro_torch.field.aggregator.AggregatorEngine` ingests the
    frames: incremental pathogen presence,
    incremental pileup against the *clean* reference (recovering the
    seeded SNPs), per-device + fleet-wide telemetry rollups.

Headline numbers in the result: **outbreak detection latency** (scenario
ticks from the first infected-device read frame to the aggregator's
presence call) and **bytes-on-wire vs raw signal** (target >= 20x).  With
``trace_path`` every device and the aggregator share one tracer, so the
Perfetto timeline shows device tracks and aggregator tracks side by side.
Every device, the aggregator and the fleet run on ``device`` (default
``"cuda"``; ``"cpu"`` runs the plain versions).
"""
from __future__ import annotations

import dataclasses
import random

import numpy as np

from repro_torch.field import uplink
from repro_torch.field.device import EdgeDevice


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Shape of one field deployment run (JSON-friendly: every field is a
    scalar or a pair, so ``FieldSpec(**json.load(f))`` works)."""
    n_devices: int = 8
    n_infected: int = 2
    host_len: int = 4000
    pathogen_len: int = 1200
    snp_rate: float = 0.01
    channels: int = 8
    chunk: int = 128
    n_reads: int = 32               # molecules per device
    read_len: tuple[int, int] = (96, 160)
    telemetry_every: int = 16
    full_reads: bool = True         # accepted reads uplink the full call
    # lossy channel
    max_delay_ticks: int = 3
    dup_prob: float = 0.05
    dropout_device: int = -1        # device id that goes dark (-1: none)
    dropout_tick: int = 0           # tick it stops sending
    # aggregator: pad_len covers a full read (read_len hi), not just the
    # decision prefix, so full-read uplinks are never clipped when scored
    pad_len: int = 192
    min_reads: int = 5
    min_abundance: float = 0.02
    detect_window: int = 256
    seed: int = 0
    max_ticks: int = 5000

    def __post_init__(self):
        if self.n_infected > self.n_devices:
            raise ValueError("n_infected exceeds n_devices")
        if isinstance(self.read_len, list):    # JSON spelling
            object.__setattr__(self, "read_len", tuple(self.read_len))


class LossyChannel:
    """Seeded uplink impairment: per-frame delivery delay (reordering
    across frames) and duplication.  Deterministic for a given seed: the
    draws come from ``random.Random(seed)`` in JAX's order, so frame
    delivery equals JAX's."""

    def __init__(self, seed: int, *, max_delay_ticks: int = 3,
                 dup_prob: float = 0.05):
        self.rng = random.Random(seed)
        self.max_delay = int(max_delay_ticks)
        self.dup_prob = float(dup_prob)
        self._inflight: list[tuple[int, int, uplink.UplinkFrame]] = []
        self._arrival = 0           # FIFO tiebreak within a tick
        self.frames_duplicated = 0

    def send(self, frames, now_tick: int) -> None:
        for frame in frames:
            copies = 1
            if self.rng.random() < self.dup_prob:
                copies = 2
                self.frames_duplicated += 1
            for _ in range(copies):
                delay = self.rng.randint(0, self.max_delay)
                self._inflight.append((now_tick + delay, self._arrival,
                                       frame))
                self._arrival += 1

    def deliver(self, now_tick: int) -> list[uplink.UplinkFrame]:
        due = sorted(e for e in self._inflight if e[0] <= now_tick)
        self._inflight = [e for e in self._inflight if e[0] > now_tick]
        return [frame for _, _, frame in due]

    @property
    def empty(self) -> bool:
        return not self._inflight


def build_field(spec: FieldSpec, *, tracer=None, device="cuda", mesh=None):
    """(devices, fleet, aggregator tenant, truth) for one deployment.

    ``truth`` carries evaluation-only ground truth: the clean reference,
    the seeded variant list, and which devices are infected.  ``mesh``
    (a lane mesh) goes to every edge device's flowcell."""
    from repro_torch.data import genome as G
    from repro_torch.engine import build
    from repro_torch.fleet import Fleet

    rng = np.random.default_rng(spec.seed)
    host = G.random_genome(rng, spec.host_len)
    pathogen_x = G.random_genome(rng, spec.pathogen_len)
    decoy_y = G.random_genome(rng, spec.pathogen_len)
    # the outbreak sample every device sequences: host + SNPs only, so
    # sample coordinates line up with the clean reference for the pileup
    sample, variants = G.mutate(
        rng, host, G.MutationProfile(snp_rate=spec.snp_rate,
                                     ins_rate=0.0, del_rate=0.0))
    infected = set(range(spec.n_infected))

    devices = []
    for d in range(spec.n_devices):
        if d in infected:
            reference = np.concatenate([sample, pathogen_x])
            targets = [(0, spec.host_len // 4),
                       (len(sample), len(reference))]
        else:
            reference = sample
            targets = [(0, spec.host_len // 4)]
        devices.append(EdgeDevice(
            d, reference, targets, channels=spec.channels, chunk=spec.chunk,
            n_reads=spec.n_reads, read_len=spec.read_len,
            seed=spec.seed * 1000 + d, telemetry_every=spec.telemetry_every,
            trace=tracer, device=device, mesh=mesh,
            full_reads=spec.full_reads))

    fleet = Fleet(device=device,
                  trace=tracer if tracer is not None else False,
                  max_pending=8192)
    agg = build("field_aggregator", "default",
                panel={"pathogen-x": pathogen_x, "decoy-y": decoy_y},
                genome=host, pad_len=spec.pad_len,
                window=spec.detect_window, min_reads=spec.min_reads,
                min_abundance=spec.min_abundance, device=fleet.device,
                trace=fleet.tracer if fleet.tracer.enabled else False)
    tenant = fleet.attach("aggregator", agg, workload="field_aggregator")
    truth = {"host": host, "sample": sample, "variants": variants,
             "infected": sorted(infected), "pathogen": pathogen_x}
    return devices, fleet, tenant, truth


def run_field_scenario(spec: FieldSpec, *, trace_path: str | None = None,
                       device="cuda", mesh=None) -> dict:
    """Drive the deployment to completion; returns the headline report.
    ``mesh``: each edge device's lane mesh (:func:`build_field`)."""
    from repro_torch.obs.trace import Tracer

    tracer = Tracer(enabled=True) if trace_path else None
    devices, fleet, tenant, truth = build_field(spec, tracer=tracer,
                                                device=device, mesh=mesh)
    agg = tenant.engine
    channel = LossyChannel(spec.seed + 17,
                           max_delay_ticks=spec.max_delay_ticks,
                           dup_prob=spec.dup_prob)
    infected = set(truth["infected"])
    dropped: set[int] = set()

    t_first_infected = None         # tick of first infected read frame
    t_detect = None                 # tick presence first flips true
    tick = 0
    for tick in range(1, spec.max_ticks + 1):
        live = False
        for dev in devices:
            if dev.device_id in dropped or dev.done:
                continue
            if (dev.device_id == spec.dropout_device
                    and tick >= spec.dropout_tick > 0):
                dropped.add(dev.device_id)      # goes dark mid-run
                continue
            frames = dev.tick()
            live = live or not dev.done
            if frames:
                channel.send(frames, tick)
                if (t_first_infected is None and dev.device_id in infected
                        and any(f.kind == uplink.KIND_READ
                                for f in frames)):
                    t_first_infected = tick
        for frame in channel.deliver(tick):
            fleet.submit("aggregator", frame)
        while fleet.step():
            pass
        if t_detect is None and agg.presence().get("pathogen-x"):
            t_detect = tick
        if not live and channel.empty and not agg.pending:
            break

    # flush: final device telemetry, stragglers in the channel
    for dev in devices:
        if dev.device_id not in dropped:
            channel.send(dev.drain(), tick)
    for t in range(tick, tick + spec.max_delay_ticks + 1):
        for frame in channel.deliver(t):
            fleet.submit("aggregator", frame)
        while fleet.step():
            pass
    if t_detect is None and agg.presence().get("pathogen-x"):
        t_detect = tick

    summary = fleet.summary()
    agg_summary = agg.summary()
    rollup = agg.fleet_rollup()

    wire = sum(d.wire_bytes_sent for d in devices)
    wire_reads = sum(d.wire_read_bytes for d in devices)
    wire_tel = sum(d.wire_telemetry_bytes for d in devices)
    raw_accepted = sum(d.raw_signal_bytes for d in devices)
    raw_sequenced = sum(uplink.raw_signal_bytes(d.engine.telemetry.samples)
                        for d in devices)
    # conservation: a live device's every accepted read reaches the
    # aggregator exactly once; a dropped device contributes exactly what it
    # delivered before going dark (counted by the aggregator itself)
    accepted_total = sum(
        d.accepted_reads if d.device_id not in dropped
        else agg.device_reads.get(d.device_id, 0)
        for d in devices)
    per_device_conserved = all(
        agg.device_reads.get(d.device_id, 0) == d.accepted_reads
        for d in devices if d.device_id not in dropped)

    snp_pos = {v[0] for v in truth["variants"] if v[1] == "SNP"}
    sites = set(agg_summary.get("variants", {}).get("candidate_sites", []))
    recovered = len(sites & snp_pos)

    per_device = []
    for d in devices:
        rep = d.report()
        per_device.append({
            "device_id": d.device_id,
            "infected": d.device_id in infected,
            "dropped": d.device_id in dropped,
            "accepted_reads": d.accepted_reads,
            "frames_sent": d.frames_sent,
            "wire_bytes": d.wire_bytes_sent,
            "enrichment": rep.get("enrichment"),
            "signal_saved_frac": rep.get("signal_saved_frac"),
        })

    result = {
        "spec": dataclasses.asdict(spec),
        "outbreak": {
            "detected": bool(agg.presence().get("pathogen-x")),
            "decoy_absent": not agg.presence().get("decoy-y", False),
            "t_first_infected_frame": t_first_infected,
            "t_detect": t_detect,
            "latency_ticks": (t_detect - t_first_infected
                              if t_detect is not None
                              and t_first_infected is not None else None),
        },
        "wire": {
            "bytes_on_wire": int(wire),
            "read_frame_bytes": int(wire_reads),
            "telemetry_frame_bytes": int(wire_tel),
            "raw_signal_bytes_accepted": int(raw_accepted),
            "raw_signal_bytes_sequenced": int(raw_sequenced),
            "reduction_vs_accepted": raw_accepted / max(wire, 1),
            "reduction_vs_sequenced": raw_sequenced / max(wire, 1),
            "read_path_reduction": raw_accepted / max(wire_reads, 1),
            "frames_duplicated": channel.frames_duplicated,
        },
        "conservation": {
            "accepted_reads_sum": int(accepted_total),
            "reads_ingested_unique": int(agg.reads_ingested),
            "per_device_exact": bool(per_device_conserved),
            "dup_frames_detected": int(
                agg.telemetry.counters.get("frames.dup", 0)),
            "late_frames": int(
                agg.telemetry.counters.get("frames.late", 0)),
        },
        "variants": {
            "seeded_snps": len(snp_pos),
            "candidate_sites": len(sites),
            "recovered_snps": recovered,
        },
        "per_device": per_device,
        "surveillance": agg_summary["surveillance"],
        "fleet_rollup": {
            "completed": rollup.completed,
            "bases": rollup.bases,
            "samples": rollup.samples,
            "samples_saved": rollup.samples_saved,
            "devices_reporting": len(agg.device_telemetry),
        },
        "ticks": tick,
        "fleet": summary["fleet"],
    }
    if tracer is not None:
        doc = tracer.export_chrome(trace_path)
        result["trace"] = {
            "path": trace_path,
            "events": sum(1 for e in doc["traceEvents"]
                          if e.get("ph") != "M"),
        }
    return result
