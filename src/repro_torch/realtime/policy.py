"""Accept / eject / wait decision policy for adaptive sampling (Read-Until).

Selective sequencing turns the mapped prefix of a read into a real-time
control action on the pore: keep sequencing the molecule (ACCEPT), reverse
the voltage and eject it (EJECT), or keep reading signal until the evidence
is conclusive (WAIT).  Ejecting is the risky, irreversible action — the
policy only takes it on a confident off-target mapping — while on-target or
undecidable reads default to sequencing through.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np


class Decision(enum.Enum):
    WAIT = "wait"      # evidence inconclusive: keep accumulating signal
    ACCEPT = "accept"  # on-target: sequence the molecule to completion
    EJECT = "eject"    # off-target: reverse pore voltage, free the channel


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    min_prefix_bases: int = 32      # do not consult the mapper before this
    map_prefix_bases: int = 48      # mapping window size (tail zero-padded
                                    # while fewer bases have been called)
    max_prefix_bases: int = 128     # give up waiting: take timeout_decision
    min_mapq: float = 4.0           # confidence gate for the EJECT action
    timeout_decision: Decision = Decision.ACCEPT
    eject_latency_samples: int = 64  # signal cost of reversing the voltage


def decide(mapped: np.ndarray, on_target: np.ndarray, mapq: np.ndarray,
           prefix_len: np.ndarray, cfg: PolicyConfig = PolicyConfig()):
    """Vectorized decision rule over a batch of mapped prefixes.

    mapped/on_target: (R,) bool; mapq: (R,) float; prefix_len: (R,) int.
    Returns (decisions (R,) object array of Decision, reasons (R,) object
    array of "mapped"/"timeout"/"" — "" for WAIT).
    """
    mapped = np.asarray(mapped, bool)
    on_target = np.asarray(on_target, bool)
    mapq = np.asarray(mapq, np.float64)
    prefix_len = np.asarray(prefix_len, np.int64)
    n = mapped.shape[0]

    decisions = np.full(n, Decision.WAIT, object)
    reasons = np.full(n, "", object)

    accept = mapped & on_target
    eject = mapped & ~on_target & (mapq >= cfg.min_mapq)
    decisions[accept] = Decision.ACCEPT
    decisions[eject] = Decision.EJECT
    reasons[accept | eject] = "mapped"

    timeout = (decisions == Decision.WAIT) & (prefix_len >= cfg.max_prefix_bases)
    decisions[timeout] = cfg.timeout_decision
    reasons[timeout] = "timeout"
    return decisions, reasons
