"""Per-channel session state and read bookkeeping for adaptive sampling.

A sensor array is a fixed pool of channels; each channel sequences one
molecule at a time.  ``ChannelSession`` is the host-side view of one
in-flight read (the device-side conv carries live in the runtime's batched
stream state, indexed by the same channel lane).  ``ReadRecord`` is the
immutable outcome of a completed read — the unit every enrichment /
signal-saved metric aggregates over.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.realtime.policy import Decision


@dataclasses.dataclass
class SimulatedRead:
    """One molecule's raw (normalized) signal plus evaluation metadata."""
    signal: np.ndarray              # (T,) normalized current
    read_id: int = 0
    on_target: bool | None = None   # ground truth, evaluation only
    position: int = -1              # true genome origin, evaluation only

    @property
    def total_samples(self) -> int:
        return int(len(self.signal))


@dataclasses.dataclass
class ChannelSession:
    """Host-side state of the read currently occupying a channel."""
    channel: int
    read: SimulatedRead
    started_wall: float
    offset: int = 0                 # raw samples consumed so far
    bases: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))

    @property
    def exhausted(self) -> bool:
        return self.offset >= self.read.total_samples

    def append_bases(self, tokens: np.ndarray) -> None:
        if len(tokens):
            self.bases = np.concatenate([self.bases, tokens.astype(np.int32)])


@dataclasses.dataclass(frozen=True)
class ReadRecord:
    """Outcome of one completed read."""
    channel: int
    read_id: int
    decision: Decision
    reason: str                     # "mapped" | "timeout" | "exhausted"
    bases_at_decision: int
    samples_at_decision: int
    samples_sequenced: int
    total_samples: int
    on_target: bool | None
    mapped_pos: int
    decision_ms: float              # wall-clock time from read start
    bases: np.ndarray | None = None  # tokens called by decision time
    #   (the uplink payload for accepted reads; None when the runtime was
    #   built without base retention — metrics above never depend on it)

    @property
    def samples_saved(self) -> int:
        return self.total_samples - self.samples_sequenced
