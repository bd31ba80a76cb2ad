"""The device tier: one simulated edge sequencer
(``repro/field/device.py``).

:class:`EdgeDevice` is the paper's mobile SoC in the field — a
:class:`~repro_torch.data.flowcell.FlowcellSimulator`-fed adaptive-sampling
engine under the ``edge_int8`` preset (the fused int8 tick, depth 2, on the
card), whose *output* is not a report but a stream of
:class:`~repro_torch.field.uplink.UplinkFrame`\\ s: every accepted read
leaves the device as a compressed read frame, and device telemetry
periodically rides along as a telemetry frame.

Calibration detail that matters: ``edge_int8``'s default calibration draws
normal(0,1) chunks, but the step-encoded flowcell emits levels 0..8 — so
the device pre-calibrates the exact
:func:`~repro_torch.data.flowcell.step_basecaller` on *step-encoded*
signal (``basecaller.quantize(..., chunks=...)``) and hands the
already-quantized params to the builder (which passes stored-int8 params
through untouched).  Per-channel weight quantization of the step decoder
is exact (each output channel's weights are a constant level), so the int8
device still decodes the step code within its class margin.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import torch

from repro_torch.device import resolve_device
from repro_torch.field import uplink
from repro_torch.realtime.policy import Decision


def calibrated_step_params(chunk: int, *, seed: int = 0,
                           calib_chunks: int = 4, device="cuda"):
    """(cfg, int8 params on ``device``) for the step decoder, activation
    scales calibrated on step-encoded signal (not the normal(0,1)
    default).  The decoder's weights and levels are small integers, so the
    calibration forward pass is exact on the card as on the CPU."""
    from repro_torch.core import basecaller as bc
    from repro_torch.data.flowcell import (STEP_SAMPLES_PER_BASE,
                                           step_basecaller, step_encode)

    cfg, params = step_basecaller(device)
    rng = np.random.default_rng((seed, 0xCA11B))
    n_bases = max(chunk, 512) // STEP_SAMPLES_PER_BASE
    chunks = []
    for _ in range(calib_chunks):
        seqs = rng.integers(1, 5, size=(2, n_bases))
        chunks.append(np.stack([step_encode(s) for s in seqs]))
    qparams = bc.quantize(params, cfg, chunks=chunks, observer="minmax")
    return cfg, qparams


class EdgeDevice:
    """One edge sequencer: flowcell -> int8 Read-Until -> uplink frames.

    ``tick()`` advances the engine one tick and returns the frames that
    became ready: one read frame per newly accepted read (per-device
    monotone ``seq``), plus a telemetry frame every ``telemetry_every``
    ticks.  ``drain()`` runs the flowcell dry and flushes a final
    telemetry frame.  ``accepted_reads`` / ``wire_bytes_sent`` /
    ``raw_signal_bytes`` feed the bytes-on-wire benchmark.

    ``full_reads=True`` (the default): an ACCEPT decision means the pore
    sequenced the whole molecule, so the uplink ships its *full*
    basecalled sequence — the device re-basecalls the accepted read's
    complete signal on the card (one int8 CNN pass, padded to the max read
    length as JAX pads it, so the tokens are JAX's bit for bit) instead of
    sending only the decision-time prefix.  Downstream variant pileups
    then see whole reads; at 0.25 B/base the extra bases barely dent the
    wire reduction.

    ``mesh`` (a lane mesh, ``"auto"`` or a device count) shards the
    flowcell's lanes (``engine.adaptive.resolve_lane_mesh``).
    """

    def __init__(self, device_id: int, reference: np.ndarray,
                 targets, *, channels: int = 8, chunk: int = 128,
                 n_reads: int = 48, read_len: tuple[int, int] = (96, 160),
                 seed: int = 0, telemetry_every: int = 16,
                 signal_snippet: int = 0, trace=None, device="cuda",
                 mesh=None, full_reads: bool = True):
        from repro_torch.engine import build

        self.device_id = int(device_id)
        self.device = resolve_device(device)
        cfg, qparams = calibrated_step_params(chunk, seed=seed,
                                              device=self.device)
        self.engine = build(
            "adaptive_sampling", "edge_int8",
            params=qparams, cfg=cfg, reference=np.asarray(reference),
            targets=list(targets), channels=channels, chunk=chunk,
            flowcell={"encoder": "step", "n_reads": n_reads,
                      "read_len": read_len, "seed": seed},
            pipeline_depth=2, mesh=mesh, device=self.device,
            trace=trace if trace is not None else False)
        self.telemetry_every = int(telemetry_every)
        self.signal_snippet = int(signal_snippet)
        self.full_reads = bool(full_reads)
        # fixed-shape full-read pass: pad every accepted read's signal to
        # the longest molecule the flowcell can emit (JAX's shape, so its
        # jitted CNN traces once per device)
        from repro_torch.data.flowcell import STEP_SAMPLES_PER_BASE
        stride = cfg.total_stride
        self._full_pad = -(-int(read_len[1]) * STEP_SAMPLES_PER_BASE
                           // stride) * stride
        self.full_read_uplinks = 0
        self._seq = 0
        self._emitted = 0           # records scanned for uplink so far
        self._ticks = 0
        self.accepted_reads = 0
        self.frames_sent = 0
        self.wire_bytes_sent = 0
        self.wire_read_bytes = 0      # read frames only (the data path)
        self.wire_telemetry_bytes = 0  # telemetry snapshots (control path)
        self.raw_signal_bytes = 0   # float32 cost of the uplinked reads
        self._live = True

    # ------------------------------------------------------------- ticks --
    def tick(self) -> list[uplink.UplinkFrame]:
        """One engine tick; returns the frames that became ready (possibly
        none).  An exhausted flowcell keeps returning [] once drained."""
        if self._live:
            self._live = self.engine.step()
        self._ticks += 1
        frames = self._collect_read_frames()
        if self.telemetry_every and self._ticks % self.telemetry_every == 0:
            frames.append(self._telemetry_frame())
        return frames

    @property
    def done(self) -> bool:
        """Flowcell dry, every lane resolved, nothing left to emit."""
        return not self._live and self._emitted >= len(self.engine.records)

    def drain(self, max_ticks: int = 100_000) -> list[uplink.UplinkFrame]:
        """Run the flowcell dry; returns every remaining frame plus the
        final telemetry frame."""
        frames: list[uplink.UplinkFrame] = []
        for _ in range(max_ticks):
            if self.done:
                break
            frames.extend(self.tick())
        self.engine.flush()
        frames.extend(self._collect_read_frames())
        frames.append(self._telemetry_frame())
        return frames

    # ------------------------------------------------------------ frames --
    def _collect_read_frames(self) -> list[uplink.UplinkFrame]:
        frames = []
        records = self.engine.records
        while self._emitted < len(records):
            rec = records[self._emitted]
            self._emitted += 1
            if rec.decision is not Decision.ACCEPT or rec.bases is None \
                    or len(rec.bases) == 0:
                continue        # ejected / timeout-ejected reads stay local
            if self.full_reads:
                full = self._full_bases(rec)
                if full is not None and len(full) > len(rec.bases):
                    rec = dataclasses.replace(rec, bases=full)
                    self.full_read_uplinks += 1
            frame = uplink.read_frame(self.device_id, self._next_seq(), rec,
                                      signal_snippet=self.signal_snippet)
            frames.append(frame)
            self.accepted_reads += 1
            self.raw_signal_bytes += uplink.raw_signal_bytes(
                rec.samples_sequenced)
            self._account(frame)
        return frames

    def _full_bases(self, rec) -> np.ndarray | None:
        """Basecall an accepted read's full signal (the pore sequenced the
        whole molecule; the decision loop only called its prefix)."""
        from repro_torch.core import basecaller as bc
        from repro_torch.core import ctc
        src = self.engine.flowcell
        if src is None:                 # source detached mid-run
            return None
        read = src.peek_read(rec.read_id)
        sig = np.asarray(read.signal, np.float32)
        cfg = self.engine.runtime.cfg
        if len(sig) > self._full_pad:   # defensive: never truncate silently
            return None
        rows = np.zeros((1, self._full_pad), np.float32)
        rows[0, :len(sig)] = sig
        pads = np.ones((1, self._full_pad // cfg.total_stride), np.float32)
        pads[0, :len(sig) // cfg.total_stride] = 0.0
        logits = bc.apply(self.engine.runtime.params,
                          torch.from_numpy(rows).to(self.device), cfg,
                          padding="stream")
        tokens, lens = ctc.greedy_decode(
            logits, torch.from_numpy(pads).to(self.device))
        n = int(lens[0])
        return tokens[0, :n].cpu().numpy().astype(np.int32)

    def _telemetry_frame(self) -> uplink.UplinkFrame:
        frame = uplink.telemetry_frame(self.device_id, self._next_seq(),
                                       self.engine.telemetry)
        self._account(frame)
        return frame

    def _next_seq(self) -> int:
        seq = self._seq
        self._seq += 1
        return seq

    def _account(self, frame: uplink.UplinkFrame) -> None:
        self.frames_sent += 1
        self.wire_bytes_sent += frame.wire_bytes
        if frame.kind == uplink.KIND_READ:
            self.wire_read_bytes += frame.wire_bytes
        else:
            self.wire_telemetry_bytes += frame.wire_bytes

    # ----------------------------------------------------------- reports --
    def report(self) -> dict:
        """Engine report plus uplink accounting."""
        out = self.engine.summary()
        out.update({
            "device_id": self.device_id,
            "accepted_reads": self.accepted_reads,
            "full_read_uplinks": self.full_read_uplinks,
            "frames_sent": self.frames_sent,
            "wire_bytes_sent": self.wire_bytes_sent,
            "wire_read_bytes": self.wire_read_bytes,
            "wire_telemetry_bytes": self.wire_telemetry_bytes,
            "raw_signal_bytes": self.raw_signal_bytes,
        })
        return out
