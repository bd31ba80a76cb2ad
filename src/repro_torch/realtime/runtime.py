"""Adaptive-sampling (Read-Until) runtime: sense -> basecall -> map -> decide
(``repro/realtime/runtime.py``).

All per-lane device state — conv carries, the CTC ``prev_class`` carry and
the ``bases``/``ticks`` counters — lives in one lane-major dict of tensors
(:func:`init_lane_state`).  Each tick is one step over every lane: the
unfused chain (conv1d kernels, the matmul head, CTC collapse, counters) or
the single fused kernel, which also folds in the reset of recycled lanes.

``pipeline_depth=2`` maps and decides on tick t-1's calls while the card
runs tick t.  JAX arrays never change, so the JAX runtime could hand tick
t-1's counters to the host one tick late; here lane state is updated in
place (the unfused lane reset zeroes rows), so right after each step the
runtime starts non-blocking copies of the step's tokens, lens and bases
into one of two pinned host buffer sets and records a CUDA event, and
``_process_one`` waits on that event.  That snapshots the evidence and
keeps host work overlapped with the card.  Signal goes up through two
pinned staging sets in the same ring.

``mesh=`` (a :class:`repro_torch.distributed.sharding.LaneMesh`) is JAX's
lane mesh, one controller: the lane-major state splits into contiguous
blocks of ``channels / mesh.size`` lanes, each block's step launches on
its device with the params replicated there, and the outputs concatenate
in lane order on the first device.  Lanes are independent, so there are
no collectives and the decisions are the unmeshed runtime's.

``tracer=`` records what JAX's runtime records: one B/E ``read`` span per
read on its lane's track (``read_id`` at capture, the decision at the
end), the stage X spans, the scheduler's instants, ``tick.dispatch`` /
``tick.complete`` instants and the per-tick ``lanes`` counter.  They are
host times; the untraced tick pays one ``tracer.enabled`` check a call.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import basecaller as bc
from repro_torch.core import ctc
from repro_torch.device import resolve_device
from repro_torch.engine.scheduler import SlotScheduler
from repro_torch.engine.telemetry import Telemetry
from repro_torch.realtime import policy as policy_mod
from repro_torch.realtime.mapper import PrefixMapper
from repro_torch.realtime.policy import Decision, PolicyConfig
from repro_torch.realtime.session import ChannelSession, ReadRecord, SimulatedRead
from repro_torch.utils.tree import tree_map


def init_lane_state(cfg: bc.BasecallerConfig, channels: int, *,
                    device="cuda") -> dict:
    """The per-lane device state, lane-major on every leaf: ``conv``
    carries, ``prev_class`` (BLANK at read start), ``bases`` and ``ticks``
    since lane reset (int32).  Every leaf zeroes on lane reset."""
    dev = resolve_device(device)
    return {
        "conv": bc.init_stream_state(cfg, channels, device=dev),
        "prev_class": torch.full((channels,), ctc.BLANK, dtype=torch.int32,
                                 device=dev),
        "bases": torch.zeros((channels,), dtype=torch.int32, device=dev),
        "ticks": torch.zeros((channels,), dtype=torch.int32, device=dev),
    }


def build_step_fn(cfg: bc.BasecallerConfig, fused: bool = False,
                  mesh=None, params=None):
    """One tick over all lanes: basecall + CTC collapse + counters.

    Unfused: ``(params, lane, rows, frame_pads) -> (tokens, lens, lane')``.
    Fused: one more lane-major argument, the ``reset`` mask, folded inside
    the kernel, so the runtime skips its own lane reset.  ``mesh`` (a
    ``LaneMesh``) runs the step on each device's block of lanes, with
    ``params`` put on each device once here."""
    if fused:
        from repro_torch.kernels import fused_stream as fs

        def step(params, lane, rows, frame_pads, reset):
            return fs.fused_stream_step(params, lane, rows, frame_pads,
                                        reset, cfg=cfg)
    else:
        def step(params, lane, rows, frame_pads):
            logits, conv = bc.apply_stream_core(params, lane["conv"], rows,
                                                cfg=cfg)
            tokens, lens, prev = ctc.greedy_decode_stream(
                logits, lane["prev_class"], frame_pads)
            new_lane = {
                "conv": conv,
                "prev_class": prev,
                "bases": lane["bases"] + lens,
                "ticks": lane["ticks"] + 1,
            }
            return tokens, lens, new_lane
    if mesh is None:
        return step
    return _lane_sharded(step, mesh, params)


def _lane_sharded(step, mesh, params):
    """``step`` over ``mesh.size`` contiguous lane blocks, block ``i`` on
    ``mesh.devices[i]`` (JAX's ``shard_map`` with lane-major leaves on the
    lane axis and params replicated), outputs concatenated in lane order
    on the first device."""
    n = mesh.size
    home = mesh.devices[0]
    replicas = {dev: bc.params_to(params, dev) for dev in set(mesh.devices)}

    def sharded(_params, *lane_args):
        lanes = lane_args[1].shape[0]           # rows: (lanes, chunk)
        if lanes % n:
            raise ValueError(f"{lanes} lanes do not split over the "
                             f"{n}-device lane mesh")
        b = lanes // n
        outs = []
        for i, dev in enumerate(mesh.devices):
            block = tree_map(lambda t: t[i * b: (i + 1) * b].to(dev),
                             lane_args)
            outs.append(step(replicas[dev], *block))
        return tuple(_cat([o[j] for o in outs], home)
                     for j in range(len(outs[0])))
    return sharded


def _cat(parts, home):
    """Concatenate same-structured trees of lane-major tensors on
    ``home``."""
    return tree_map(lambda *ts: torch.cat([t.to(home) for t in ts]),
                    *parts)


def resolve_fused(fused, device: torch.device) -> bool:
    """The fused-step choice: an explicit ``True``/``False`` wins; ``None``
    fuses exactly where the fused op has a kernel, i.e. on the card (the JAX
    runtime resolves ``None`` to whether the fused op's target is Pallas)."""
    if fused is None:
        return device.type == "cuda"
    return bool(fused)


class _HostRing:
    """Two sets of host buffers for the tick's signal (up) and evidence
    (down), pinned when the step runs on the card."""

    def __init__(self, channels: int, chunk: int, n_frames: int,
                 device: torch.device):
        self.device = device
        self.pinned = device.type == "cuda"
        f32, i32 = torch.float32, torch.int32
        shapes = {"rows": ((channels, chunk), f32),
                  "pads": ((channels, n_frames), f32),
                  "reset": ((channels,), f32),
                  "tokens": ((channels, n_frames), i32),
                  "lens": ((channels,), i32),
                  "bases": ((channels,), i32)}
        self.sets = [{k: torch.zeros(shape, dtype=dt, pin_memory=self.pinned)
                      for k, (shape, dt) in shapes.items()}
                     for _ in range(2)]

    def upload(self, slot: int, name: str) -> torch.Tensor:
        buf = self.sets[slot][name]
        if not self.pinned:
            return buf   # the step copies its inputs (torch.cat) before use
        return buf.to(self.device, non_blocking=True)

    def snapshot(self, slot: int, tokens, lens, bases):
        """Start copying the step's evidence to the host; returns the host
        arrays and the event that marks them complete (None on the CPU)."""
        s = self.sets[slot]
        for name, t in (("tokens", tokens), ("lens", lens), ("bases", bases)):
            s[name].copy_(t, non_blocking=self.pinned)
        event = None
        if self.pinned:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return (s["tokens"].numpy(), s["lens"].numpy(),
                s["bases"].numpy()), event


class AdaptiveSamplingRuntime:
    """Manages a pool of concurrent channel sessions with streaming state."""

    def __init__(self, params, cfg: bc.BasecallerConfig, mapper: PrefixMapper,
                 policy: PolicyConfig = PolicyConfig(), *, channels: int = 32,
                 chunk_samples: int = 256, device="cuda", mesh=None,
                 pipeline_depth: int = 1, source=None, tracer=None,
                 fused=None):
        if chunk_samples % cfg.total_stride:
            raise ValueError(
                f"chunk_samples={chunk_samples} must be a multiple of the "
                f"basecaller total_stride={cfg.total_stride}")
        if pipeline_depth not in (1, 2):
            raise ValueError(f"pipeline_depth must be 1 or 2, "
                             f"got {pipeline_depth}")
        if mesh is not None and channels % mesh.size:
            raise ValueError(
                f"channels={channels} must divide evenly over the "
                f"{mesh.size}-device lane mesh")
        if source is not None and source.config.channels != channels:
            raise ValueError(
                f"flowcell source has {source.config.channels} channels, "
                f"runtime has {channels}")
        self.device = resolve_device(device)
        if mesh is not None and resolve_device(mesh.devices[0]) != self.device:
            raise ValueError(
                f"the lane mesh's first device {mesh.devices[0]} holds the "
                f"lane state; the runtime's device is {self.device}")
        self.mesh = mesh
        self.params = params
        self.cfg = cfg
        self.mapper = mapper
        self.policy = policy
        self.channels = channels
        self.chunk_samples = chunk_samples
        self.pipeline_depth = pipeline_depth
        self.fused = resolve_fused(fused, self.device)
        self._step = build_step_fn(cfg, fused=self.fused, mesh=mesh,
                                   params=params)
        self.lane_state = init_lane_state(cfg, channels, device=self.device)
        self.records: list[ReadRecord] = []
        self.telemetry = Telemetry(workload="adaptive_sampling",
                                   tracer=tracer)
        self._trace = self.telemetry.tracer
        self._pid = self.telemetry.trace_pid
        # channel lanes: slot = sensor channel, payload = ChannelSession
        self.scheduler = SlotScheduler(
            channels, on_event=self._trace.scheduler_hook(self._pid))
        self._source = source
        self._n_frames = chunk_samples // cfg.total_stride
        self._ring = _HostRing(channels, chunk_samples, self._n_frames,
                               self.device)
        self._pending = None            # in-flight tick awaiting map/decide
        self._ticks = 0                 # flowcell time, in chunks (incl idle)
        self._busy_ticks = np.zeros(channels, np.int64)
        self._lane_reads = np.zeros(channels, np.int64)
        self._warm = False

    @property
    def flowcell_samples(self) -> int:
        """Flowcell time: every tick advances each channel by one chunk."""
        return self._ticks * self.chunk_samples

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        """Run every path once (loading the kernels, building them if
        needed) before any session is timed."""
        if self._warm:
            return
        dev = self.device
        rows = torch.zeros((self.channels, self.chunk_samples),
                           dtype=torch.float32, device=dev)
        pads = torch.zeros((self.channels, self._n_frames),
                           dtype=torch.float32, device=dev)
        with self.telemetry.scope():
            if self.fused:
                self._step(self.params, self.lane_state, rows, pads,
                           torch.zeros((self.channels,), dtype=torch.float32,
                                       device=dev))
            else:
                self._step(self.params, self.lane_state, rows, pads)
            self.mapper.map_prefixes(
                np.zeros((self.channels, self.policy.map_prefix_bases),
                         np.int32))
        self._sync()
        self._warm = True

    # ------------------------------------------------------------ intake --
    def submit(self, read: SimulatedRead) -> None:
        """Queue a read for the next free lane (queue-fed mode only)."""
        if self._source is not None:
            raise ValueError(
                "runtime is source-fed (flowcell attached): reads arrive by "
                "pore capture, not submit()")
        self.scheduler.submit(read)

    def submit_all(self, reads) -> None:
        for r in reads:
            self.submit(r)

    # ------------------------------------------------------ lane control --
    def _reset_lanes(self, lanes: list[int]) -> None:
        """Zero every lane-state leaf of channels starting a new read, in
        place: conv carries, CTC carry (BLANK == 0) and the counters."""
        if not lanes:
            return
        idx = torch.as_tensor(lanes, dtype=torch.long, device=self.device)
        for leaf in (*self.lane_state["conv"], self.lane_state["prev_class"],
                     self.lane_state["bases"], self.lane_state["ticks"]):
            leaf[idx] = 0

    def _poll_source(self) -> list[int]:
        """Capture the next arrival-ordered molecule on every recovered
        channel (flowcell mode only); returns the freshly occupied lanes."""
        src = self._source
        if src is None:
            return []
        t = self.flowcell_samples
        now = time.perf_counter()
        active = self.scheduler.active
        fresh = []
        for b in range(self.channels):
            if active[b] is not None:
                continue
            read = src.next_read(b, t)
            if read is None:
                continue
            self.scheduler.assign(b, ChannelSession(channel=b, read=read,
                                                    started_wall=now))
            fresh.append(b)
        return fresh

    def _assign_free(self) -> list[int]:
        now = time.perf_counter()
        fresh = self.scheduler.admit(
            wrap=lambda b, read: ChannelSession(channel=b, read=read,
                                                started_wall=now))
        return [b for b, _ in fresh]

    # ------------------------------------------------------------ tracing --
    def _lane_tid(self, b: int) -> int:
        return self._trace.tid(self._pid, f"lane{b:03d}")

    def _begin_read_spans(self, lanes: list[int]) -> None:
        """Open one B span per freshly captured read on its lane track
        (closed by :meth:`_finish` with the decision args)."""
        if not self._trace.enabled or not lanes:
            return
        active = self.scheduler.active
        for b in lanes:
            s = active[b]
            self._trace.begin(
                "read", pid=self._pid, tid=self._lane_tid(b), cat="read",
                args={"read_id": int(s.read.read_id), "lane": b,
                      "total_samples": int(s.read.total_samples),
                      "capture_tick": self._ticks})

    def _finish(self, b: int, decision: Decision, reason: str,
                mapped_pos: int, now: float) -> None:
        s = self.scheduler.release(b)
        total = s.read.total_samples
        if decision is Decision.EJECT:
            consumed = min(s.offset + self.policy.eject_latency_samples, total)
        else:
            consumed = total
        if self._source is not None:
            self._source.read_done(b, self.flowcell_samples,
                                   consumed - s.offset)
        self._lane_reads[b] += 1
        rec = ReadRecord(
            channel=b, read_id=s.read.read_id, decision=decision,
            reason=reason, bases_at_decision=int(len(s.bases)),
            samples_at_decision=s.offset, samples_sequenced=consumed,
            total_samples=total, on_target=s.read.on_target,
            mapped_pos=int(mapped_pos),
            decision_ms=(now - s.started_wall) * 1e3,
            bases=s.bases)
        self.records.append(rec)
        if self._trace.enabled:
            self._trace.end(
                pid=self._pid, tid=self._lane_tid(b),
                args={"read_id": int(s.read.read_id),
                      "decision": decision.name, "reason": reason,
                      "bases": int(len(s.bases)),
                      "samples_sequenced": int(consumed),
                      "samples_saved": int(total - consumed)})
        tel = self.telemetry
        tel.completed += 1
        tel.samples += consumed
        tel.samples_saved += total - consumed
        if reason == "exhausted":
            tel.count("exhausted")
        elif reason == "timeout":
            tel.count("timeouts")
            tel.observe_latency(rec.decision_ms)
        else:
            tel.count("accepted", int(decision is Decision.ACCEPT))
            tel.count("ejected", int(decision is Decision.EJECT))
            tel.observe_latency(rec.decision_ms)

    # ------------------------------------------------------------- ticks --
    def _process_pending(self) -> None:
        p, self._pending = self._pending, None
        if p is not None:
            self._process_one(p)

    def _process_one(self, p: dict) -> None:
        """Map + decide on one dispatched tick's basecalls (one tick behind
        the card under ``pipeline_depth=2``)."""
        tel = self.telemetry
        sessions = p["sessions"]
        with tel.stage("basecall"):
            if p["event"] is not None:
                p["event"].synchronize()
            tokens_np, lens_np, bases_np = p["host"]
        if self._trace.enabled:
            # completion lands one tick after its launch under depth 2: the
            # args carry the evidence tick
            self._trace.instant(
                "tick.complete", pid=self._pid,
                tid=self._trace.tid(self._pid, "host"), cat="tick",
                args={"evidence_tick": p["tick"], "lanes": len(sessions)})
        active = self.scheduler.active
        for b, s in sessions.items():
            if active[b] is not s:     # lane already recycled (defensive)
                continue
            n = int(lens_np[b])
            s.append_bases(tokens_np[b, :n])
            tel.bases += n

        map_len = self.policy.map_prefix_bases
        cand = [b for b, s in sessions.items()
                if active[b] is s
                and bases_np[b] >= self.policy.min_prefix_bases]
        if cand:
            prefixes = np.zeros((self.channels, map_len), np.int32)
            prefix_lens = np.zeros((self.channels,), np.int64)
            for b in cand:
                window = sessions[b].bases[-map_len:]
                prefixes[b, :len(window)] = window
                prefix_lens[b] = int(bases_np[b])
            with tel.scope(), tel.stage("map"):
                res = self.mapper.map_prefixes(prefixes)
                decisions, reasons = policy_mod.decide(
                    res.mapped, res.on_target, res.mapq, prefix_lens,
                    self.policy)
            now = time.perf_counter()
            for b in cand:
                if decisions[b] is not Decision.WAIT:
                    self._finish(b, decisions[b], reasons[b],
                                 res.positions[b], now)

        # reads that ran dry without a decision were sequenced in full,
        # judged on the offset at this evidence tick's dispatch
        now = time.perf_counter()
        for b, s in sessions.items():
            if active[b] is s and p["offsets"][b] >= s.read.total_samples:
                self._finish(b, Decision.ACCEPT, "exhausted", -1, now)

    def flush(self) -> None:
        """Resolve the in-flight double-buffered tick, if any."""
        self._process_pending()

    def yield_mesh(self) -> None:
        """Hand the card to another engine between ticks.

        Waits on the pending tick's CUDA event (depth 2 keeps one tick in
        flight), so no launch of ours is still running when the fleet runs
        the next tenant.  The pending tick is still mapped and decided on
        our next tick, so decisions are identical to an undisturbed run;
        only the overlap across the yield is given up."""
        p = self._pending
        if p is not None:
            if p["event"] is not None:
                p["event"].synchronize()
            self.telemetry.count("mesh_yields_inflight")

    def detach_source(self) -> None:
        """Live flowcell detach: stop capturing new molecules and let every
        read in flight stream to its decision; ``tick()`` returns False
        once the occupied lanes drain."""
        if self._source is not None:
            self._source = None
            self.telemetry.count("source_detached")

    def tick(self) -> bool:
        """Advance every busy channel by one chunk; returns False when idle."""
        self.warmup()
        t0 = time.perf_counter()
        tel = self.telemetry
        fresh = self._poll_source() + self._assign_free()
        if not self.fused:
            self._reset_lanes(fresh)
        self._begin_read_spans(fresh)
        sessions = self.scheduler.active
        busy = self.scheduler.busy
        if not busy:
            self._process_pending()
            src = self._source
            if (not self.scheduler.pending
                    and (src is None or src.exhausted)):
                return False
            self._ticks += 1
            tel.count("idle_ticks")
            tel.wall_s += time.perf_counter() - t0
            return True
        tel.steps += 1
        self._ticks += 1
        self._busy_ticks[busy] += 1
        slot = self._ticks % 2
        host = self._ring.sets[slot]

        # 1. sense: one fixed-shape chunk matrix across all channels; frames
        # derived from the zero fill past a read's end are padding
        chunk, stride = self.chunk_samples, self.cfg.total_stride
        rows = host["rows"].numpy()
        frame_pads = host["pads"].numpy()
        with tel.stage("sense"):
            rows.fill(0.0)
            frame_pads.fill(1.0)
            for b in busy:
                s = sessions[b]
                piece = s.read.signal[s.offset: s.offset + chunk]
                rows[b, :len(piece)] = piece
                frame_pads[b, : len(piece) // stride] = 0.0
                s.offset = min(s.offset + chunk, s.read.total_samples)

        # 2. launch the step for every lane, then start the evidence copy
        with tel.scope(), tel.stage("basecall"):
            rows_d = self._ring.upload(slot, "rows")
            pads_d = self._ring.upload(slot, "pads")
            if self.fused:
                reset = host["reset"].numpy()
                reset.fill(0.0)
                reset[fresh] = 1.0
                tokens, lens, self.lane_state = self._step(
                    self.params, self.lane_state, rows_d, pads_d,
                    self._ring.upload(slot, "reset"))
            else:
                tokens, lens, self.lane_state = self._step(
                    self.params, self.lane_state, rows_d, pads_d)
            evidence, event = self._ring.snapshot(
                slot, tokens, lens, self.lane_state["bases"])
        tel.dispatches += 1
        if self._trace.enabled:
            # launch marker: this tick's evidence is mapped in a later
            # tick.complete under depth 2
            self._trace.instant(
                "tick.dispatch", pid=self._pid,
                tid=self._trace.tid(self._pid, "host"), cat="tick",
                args={"tick": self._ticks, "lanes": len(busy)})
            self._trace.counter(
                "lanes", {"busy": len(busy),
                          "queue": self.scheduler.pending},
                pid=self._pid)
        tel.gauge("queue_depth", self.scheduler.pending)
        tel.gauge("lanes_busy", len(busy))
        prev = self._pending
        self._pending = {
            "host": evidence, "event": event,
            "sessions": {b: sessions[b] for b in busy},
            "offsets": {b: sessions[b].offset for b in busy},
            "tick": self._ticks,
        }
        if self.pipeline_depth == 1:
            self._process_pending()
        elif prev is not None:
            # the double buffer: map + decide tick t-1 on the host while the
            # card runs the step just launched for tick t
            self._process_one(prev)

        tel.wall_s += time.perf_counter() - t0
        return True

    def run(self, max_ticks: int = 100_000) -> dict:
        while self.tick():
            self.telemetry.tick_export()
            if self._ticks >= max_ticks:
                break
        self.flush()
        return self.report()

    # ----------------------------------------------------------- metrics --
    def report(self) -> dict:
        tel = self.telemetry
        if self._ticks:
            occ = self._busy_ticks / self._ticks
            tel.gauge("occupancy_mean", float(occ.mean()))
            tel.gauge("occupancy_min", float(occ.min()))
            tel.gauge("occupancy_max", float(occ.max()))
            tel.gauge("flowcell_ticks", self._ticks)
            tel.gauge("flowcell_samples", self.flowcell_samples)
        tel.gauge("pore_time_saved_samples", tel.samples_saved)
        tel.gauge("reads_per_channel_mean", float(self._lane_reads.mean()))
        out = tel.summary()
        out["reads"] = tel.completed
        out["decision_p50_ms"] = out["p50_ms"]
        out["decision_p99_ms"] = out["p99_ms"]
        for k in ("accepted", "ejected", "timeouts", "exhausted"):
            out.setdefault(k, 0)
        recs = self.records
        truth = [r for r in recs if r.on_target is not None]
        if truth:
            seq_on = sum(r.samples_sequenced for r in truth if r.on_target)
            seq_all = sum(r.samples_sequenced for r in truth)
            tot_on = sum(r.total_samples for r in truth if r.on_target)
            tot_all = sum(r.total_samples for r in truth)
            naive = tot_on / max(tot_all, 1)
            selective = seq_on / max(seq_all, 1)
            out["on_target_frac_nonselective"] = naive
            out["on_target_frac_selective"] = selective
            out["enrichment"] = selective / max(naive, 1e-9)
            wrong_ejects = sum(r.decision is Decision.EJECT and r.on_target
                               for r in truth)
            out["on_target_eject_rate"] = wrong_ejects / max(
                sum(1 for r in truth if r.on_target), 1)
        return out
