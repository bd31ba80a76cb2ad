"""Flowcell simulator: N channels of staggered, arrival-ordered reads
(``repro/data/flowcell.py``, numpy, copied).

Each channel cycles sequencing -> decision -> recovery -> next capture;
molecules arrive in a global order keyed on ``read_id``, so the i-th
capture is the same molecule for any lane count.  Two signal encoders:
``"pore"`` (the squiggle model of :mod:`repro_torch.data.nanopore`) and
``"step"`` (a noiseless level-per-base code that :func:`step_basecaller`
decodes exactly).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data import nanopore

# ------------------------------------------------------- step encoding ----
# Base b in 1..4 -> STEP_DWELL samples at level STEP_LEVELS[b], then
# STEP_DWELL samples at the blank level 0.  The gap frames decode to CTC
# blank, so repeated bases survive the CTC collapse.
STEP_DWELL = 2
STEP_LEVELS = np.array([0.0, 2.0, 4.0, 6.0, 8.0], np.float32)
STEP_SAMPLES_PER_BASE = 2 * STEP_DWELL


def step_encode(seq: np.ndarray) -> np.ndarray:
    """(L,) bases 1..4 -> (L * STEP_SAMPLES_PER_BASE,) noiseless signal."""
    seq = np.asarray(seq)
    seg = np.zeros((len(seq), STEP_SAMPLES_PER_BASE), np.float32)
    seg[:, :STEP_DWELL] = STEP_LEVELS[seq][:, None]
    return seg.reshape(-1)


def step_basecaller(device="cuda"):
    """A hand-built CNN that decodes :func:`step_encode` exactly.

    conv1 (K=2, stride=2) scores each 2-sample segment against every class
    centre, ``score_c = 2*mu_c*mean(x) - mu_c**2``; level segments win
    their base's class by a margin of at least 4, gap segments ReLU to an
    all-zero tie which the first-maximum argmax resolves to BLANK.  conv2
    is a 1x1 identity, so the streaming path also runs the GEMM head.
    Returns ``(BasecallerConfig, params)`` with the params on ``device``.
    """
    import torch

    from repro_torch.core import basecaller as bc
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    cfg = bc.BasecallerConfig(kernels=(2, 1), channels=(5, 5),
                              strides=(2, 1))
    mu = torch.from_numpy(STEP_LEVELS)
    params = {
        "conv1": {"w": mu.expand(2, 1, 5).contiguous().to(dev),
                  "b": (-(mu ** 2)).to(dev)},
        "conv2": {"w": torch.eye(5, dtype=torch.float32)[None].to(dev),
                  "b": torch.zeros(5, dtype=torch.float32, device=dev)},
    }
    return cfg, params


# ------------------------------------------------------------ simulator ---
@dataclasses.dataclass(frozen=True)
class FlowcellConfig:
    """Shape and physics of one simulated flowcell run."""
    channels: int = 512
    n_reads: int = 1024             # molecules available to the whole run
    read_len: tuple[int, int] = (150, 400)   # bases, inclusive uniform range
    recovery_samples: int = 128     # pore recovery time after any completion
    stagger_samples: int = 32       # per-channel initial capture stagger
    encoder: str = "pore"           # "pore" | "step"
    seed: int = 0
    pm: nanopore.PoreModel = nanopore.PoreModel()


class FlowcellSimulator:
    """Per-channel pore lifecycle over a fixed pool of molecules.

    The runtime polls ``next_read(channel, now)`` for every free lane each
    tick (``now`` in flowcell samples) and calls ``read_done`` when a lane's
    read resolves.  Molecule content depends only on ``read_id``.
    """

    def __init__(self, reference: np.ndarray,
                 config: FlowcellConfig = FlowcellConfig(), *,
                 target_mask: np.ndarray | None = None):
        self.reference = np.asarray(reference, np.int32)
        self.config = config
        self.target_mask = target_mask
        lo, hi = config.read_len
        if not (0 < lo <= hi):
            raise ValueError(f"bad read_len range {config.read_len}")
        if hi >= len(self.reference):
            raise ValueError("read_len exceeds the reference")
        if config.encoder not in ("pore", "step"):
            raise ValueError(f"unknown encoder {config.encoder!r}")
        rng = np.random.default_rng(config.seed)
        self._starts = rng.integers(0, len(self.reference) - hi,
                                    size=config.n_reads)
        self._lens = rng.integers(lo, hi + 1, size=config.n_reads)
        self._ready_at = np.arange(config.channels, dtype=np.int64) \
            * config.stagger_samples
        self._next = 0

    @property
    def emitted(self) -> int:
        return self._next

    @property
    def exhausted(self) -> bool:
        """All molecules captured (channels may still be sequencing them)."""
        return self._next >= self.config.n_reads

    def ready_at(self, channel: int) -> int:
        return int(self._ready_at[channel])

    def next_read(self, channel: int, now_samples: int):
        """The next captured molecule for a recovered channel, or None when
        the channel is still busy/recovering or the pool ran dry."""
        if self.exhausted or now_samples < self._ready_at[channel]:
            return None
        read = self._synthesize(self._next)
        self._next += 1
        return read

    def peek_read(self, read_id: int):
        """Re-synthesize an already-captured molecule without touching the
        pore lifecycle.  Signal content is keyed on ``read_id`` alone, so
        this returns exactly what ``next_read`` handed out: the device tier
        re-basecalls an accepted read's *full* signal with it."""
        if not 0 <= read_id < self._next:
            raise ValueError(
                f"read_id {read_id} has not been captured yet "
                f"(emitted={self._next})")
        return self._synthesize(read_id)

    def read_done(self, channel: int, now_samples: int,
                  hold_samples: int) -> None:
        """Account the pore-time tail of a resolved read: ``hold_samples``
        is what the pore still spends on the molecule after the decision."""
        self._ready_at[channel] = (now_samples + max(int(hold_samples), 0)
                                   + self.config.recovery_samples)

    def _synthesize(self, read_id: int):
        from repro_torch.realtime.session import SimulatedRead

        cfg = self.config
        start = int(self._starts[read_id])
        length = int(self._lens[read_id])
        seq = self.reference[start: start + length]
        if cfg.encoder == "step":
            signal = step_encode(seq)
        else:
            rng = np.random.default_rng((cfg.seed, 7919, read_id))
            sig, _ = nanopore.simulate_read(rng, seq, cfg.pm)
            signal = nanopore.normalize(sig)
        on_target = None
        if self.target_mask is not None:
            on_target = bool(self.target_mask[start + length // 2])
        return SimulatedRead(signal=signal, read_id=read_id,
                             on_target=on_target, position=start)
