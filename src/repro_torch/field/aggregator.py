"""The aggregator tier: one analysis service fed by every device's uplink
(``repro/field/aggregator.py``).

:class:`AggregatorEngine` speaks the engine protocol so a
:class:`repro_torch.fleet.Fleet` can host it as a tenant (time-sliced
against anything else on the card): ``submit`` takes
:class:`~repro_torch.field.uplink.UplinkFrame`\\ s (or their raw bytes),
``step`` ingests one batch.  Per batch it

  * **dedups and orders-tolerates** — per-device seen-set over frame
    ``seq``: duplicates are dropped and counted, late (out-of-order)
    frames are counted and processed; a device going dark mid-run simply
    stops contributing (no timeout state to corrupt);
  * **classifies** the new reads against the pathogen panel through
    :class:`repro_torch.core.pathogen.IncrementalDetector` (the
    ``banded_align`` kernel on the card) — O(batch) per ingest, exactly
    equal to batch ``detect`` over everything seen;
  * **accumulates the pileup** via
    :class:`repro_torch.core.variant_caller.PileupState` (vectorized
    scatter per batch) for incremental variant candidate calling against
    the reference;
  * **merges device telemetry** (``Telemetry.from_dict`` + ``merge``) into
    per-device and fleet-wide rollups.

Classification determinism under regrouping: every read batch is padded to
a fixed ``pad_len`` before scoring, so a read's panel assignment is
identical no matter which frames share its batch — the invariant the
reorder/duplication property tests pin.
"""
from __future__ import annotations

import collections
import struct

import numpy as np

from repro_torch.core import pathogen
from repro_torch.core.variant_caller import PileupState, candidate_sites
from repro_torch.device import resolve_device
from repro_torch.engine.registry import register
from repro_torch.engine.telemetry import Telemetry
from repro_torch.field import uplink


class AggregatorEngine:
    """Fleet-hostable surveillance service over the device uplink."""

    workload = "field_aggregator"

    def __init__(self, panel: pathogen.Panel, *,
                 genome: np.ndarray | None = None,
                 detect_cfg: pathogen.DetectConfig | None = None,
                 mode: str = "ed", pad_len: int = 128, device="cuda",
                 trace=False):
        self.panel = panel
        self.cfg = detect_cfg or pathogen.DetectConfig(
            window=256, min_reads=5, min_abundance=0.02)
        self.pad_len = int(pad_len)
        self.telemetry = Telemetry(workload=self.workload, tracer=trace)
        self.device = resolve_device(device)
        self.detector = pathogen.IncrementalDetector(
            panel, self.cfg, mode=mode, device=self.device)
        self.genome = None if genome is None else np.asarray(genome)
        self.pileup = None if genome is None else PileupState(self.genome)
        self.pending: collections.deque = collections.deque()
        # per-device ingest state
        self.seen_seqs: dict[int, set] = {}
        self.max_seq: dict[int, int] = {}
        self.device_reads: dict[int, int] = {}
        self.device_telemetry: dict[int, Telemetry] = {}
        self.reads_ingested = 0     # unique read frames folded in

    # ------------------------------------------------------------ intake --
    def submit(self, frame, **_) -> None:
        """Queue one uplink frame (an :class:`UplinkFrame` or its bytes)."""
        self.pending.append(frame)

    # ------------------------------------------------------------- ticks --
    def step(self) -> bool:
        """Ingest everything currently queued as one batch; False when
        idle."""
        if not self.pending:
            return False
        batch, self.pending = list(self.pending), collections.deque()
        reads = []
        with self.telemetry.scope():
            with self.telemetry.stage("ingest"):
                for raw in batch:
                    decoded = self._admit(raw)
                    if decoded is not None:
                        reads.append(decoded)
            if reads:
                with self.telemetry.stage("surveillance"):
                    self._classify(reads)
                if self.pileup is not None:
                    with self.telemetry.stage("pileup"):
                        self.pileup.ingest(
                            [r.bases for r in reads],
                            np.array([r.mapped_pos for r in reads]))
        self.telemetry.steps += 1
        self.telemetry.tick_export()
        return True

    def _admit(self, raw) -> uplink.DecodedRead | None:
        """Frame -> decoded read, or None (telemetry / dup / undecodable).

        Every anomaly is a counter, never an exception: the uplink is a
        lossy channel and the aggregator's contract is to degrade into
        accounting."""
        tel = self.telemetry
        try:
            frame = (raw if isinstance(raw, uplink.UplinkFrame)
                     else uplink.UplinkFrame.from_bytes(raw))
        except (ValueError, struct.error):
            tel.count("frames.decode_error")
            return None
        dev = frame.device_id
        seen = self.seen_seqs.setdefault(dev, set())
        if frame.seq in seen:
            tel.count("frames.dup")
            tel.count(f"device.{dev}.dup")
            return None
        if frame.seq < self.max_seq.get(dev, -1):
            tel.count("frames.late")          # reordered, still processed
        seen.add(frame.seq)
        self.max_seq[dev] = max(self.max_seq.get(dev, -1), frame.seq)
        if frame.kind == uplink.KIND_TELEMETRY:
            tel.count("frames.telemetry")
            self._merge_device_telemetry(dev, frame)
            return None
        if frame.kind != uplink.KIND_READ:
            tel.count("frames.unknown_kind")
            return None
        try:
            decoded = uplink.decode_read(frame)
        except (ValueError, struct.error):
            tel.count("frames.decode_error")
            return None
        tel.count("frames.read")
        tel.count(f"device.{dev}.reads")
        self.device_reads[dev] = self.device_reads.get(dev, 0) + 1
        self.reads_ingested += 1
        tel.completed += 1
        tel.bases += int(len(decoded.bases))
        tel.samples += int(decoded.samples_at_decision)
        return decoded

    def _merge_device_telemetry(self, dev: int,
                                frame: uplink.UplinkFrame) -> None:
        try:
            snap = uplink.decode_telemetry(frame)
        except (ValueError, KeyError):
            self.telemetry.count("frames.decode_error")
            return
        # snapshots are cumulative: the latest replaces, never sums
        self.device_telemetry[dev] = snap

    def _classify(self, reads: list) -> None:
        """Score one batch, padded to the fixed ``pad_len`` so assignment
        is independent of batch grouping."""
        lens = np.array([min(len(r.bases), self.pad_len) for r in reads],
                        np.int64)
        batch = np.zeros((len(reads), self.pad_len), np.int32)
        for i, r in enumerate(reads):
            batch[i, :lens[i]] = r.bases[:self.pad_len]
        report = self.detector.ingest(batch, read_lens=lens)
        for name, flag in report.present.items():
            self.telemetry.gauge(f"present.{name}", float(flag))

    # --------------------------------------------------------- fleet API --
    def flush(self) -> None:
        self.step()

    def drain(self, max_steps: int = 100_000) -> dict:
        steps = 0
        while steps < max_steps and self.step():
            steps += 1
        return self.summary()

    # ----------------------------------------------------------- reports --
    def presence(self) -> dict[str, bool]:
        return self.detector.report().present

    def fleet_rollup(self) -> Telemetry:
        """One merged Telemetry over every device snapshot received plus
        the aggregator's own accounting."""
        roll = Telemetry(workload="field")
        for snap in self.device_telemetry.values():
            roll.merge(snap)
        roll.merge(self.telemetry)
        return roll

    def variant_sites(self, *, min_alt_frac: float = 0.2,
                      min_cov: float = 4.0) -> np.ndarray:
        """Candidate variant positions from the incremental pileup."""
        if self.pileup is None:
            return np.zeros(0, np.int64)
        return candidate_sites(self.pileup.features(),
                               min_alt_frac=min_alt_frac, min_cov=min_cov)

    def summary(self) -> dict:
        out = self.telemetry.summary()
        report = self.detector.report()
        out["surveillance"] = {
            "present": report.present,
            "counts": report.counts,
            "abundance": report.abundance,
            "reads_ingested": self.reads_ingested,
            "device_reads": dict(self.device_reads),
            "devices_reporting": len(self.seen_seqs),
        }
        if self.pileup is not None:
            sites = self.variant_sites()
            out["variants"] = {
                "candidate_sites": [int(s) for s in sites],
                "n_candidate_sites": int(len(sites)),
                "reads_in_pileup": int(self.pileup.n_reads),
            }
        return out


@register("field_aggregator", presets={
    "default": {"pad_len": 128, "window": 256, "min_reads": 5,
                "min_abundance": 0.02},
    "smoke": {"pad_len": 128, "window": 192, "min_reads": 3,
              "min_abundance": 0.01},
})
def build_field_aggregator(panel=None, genome=None, *, pad_len: int,
                           window: int, min_reads: int,
                           min_abundance: float, mode: str = "ed",
                           seed: int = 0, device="cuda", trace=False):
    """Builder: supply a :class:`~repro_torch.core.pathogen.Panel` (or a
    dict of name -> token genome) plus the reference ``genome`` for
    pileup; with no panel a small random two-pathogen demo panel is
    generated."""
    if panel is None:
        from repro_torch.data import genome as G
        rng = np.random.default_rng(seed)
        panel = {"pathogen-a": G.random_genome(rng, 1000),
                 "pathogen-b": G.random_genome(rng, 1000)}
    if isinstance(panel, dict):
        panel = pathogen.Panel.build(panel, with_index=(mode == "fm"))
    cfg = pathogen.DetectConfig(window=window, min_reads=min_reads,
                                min_abundance=min_abundance)
    return AggregatorEngine(panel, genome=genome, detect_cfg=cfg, mode=mode,
                            pad_len=pad_len, device=device, trace=trace)
