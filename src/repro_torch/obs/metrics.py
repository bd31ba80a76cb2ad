"""Bounded, mergeable metrics primitives (``repro/obs/metrics.py``).

A long-running flowcell makes one latency observation per decision forever;
the accounting structures must therefore be **bounded** (O(buckets), not
O(observations)) and **mergeable** (the multi-tenant fleet rolls per-engine
telemetry up into per-tenant and per-mesh views).  Three primitives cover
every quantity the engines report:

  :class:`LogHistogram`  log-bucketed weighted histogram with an exact mode
                         for short runs (see below)
  :class:`Counters`      monotonically accumulating event counts
  :class:`Gauges`        point-in-time values; merge keeps the freshest

:func:`weighted_percentile` — the exactness oracle the histogram is tested
against — lives here too (re-exported by
``repro_torch.engine.telemetry``).
"""
from __future__ import annotations

import collections
import itertools
import math

import numpy as np


def weighted_percentile(values, weights, q: float) -> float:
    """Percentile ``q`` (0..100) of ``values`` under integer/float weights.

    Equivalent to ``np.percentile(np.repeat(values, weights), q)`` with
    ``interpolation='lower'``-style behaviour on the weighted CDF, but
    without materializing the expansion.  This is the exactness oracle for
    :meth:`LogHistogram.percentile`.
    """
    v = np.asarray(values, np.float64)
    w = np.asarray(weights, np.float64)
    if v.size == 0:
        return 0.0
    order = np.argsort(v, kind="stable")
    v, w = v[order], w[order]
    cdf = np.cumsum(w)
    target = q / 100.0 * cdf[-1]
    return float(v[np.searchsorted(cdf, target, side="left").clip(0, len(v) - 1)])


class LogHistogram:
    """Weighted histogram over log-spaced buckets, exact for short runs.

    Observations are kept verbatim until ``exact_until`` of them have been
    recorded (percentiles are then *exact* — bit-identical to
    :func:`weighted_percentile`); past that the stored samples fold into
    log-spaced buckets and memory stays O(buckets) forever.  Folding maps
    each value to its bucket deterministically, so :meth:`merge` is
    associative: any merge order of the same observation multiset yields the
    same bucket state and the same percentiles.

    In folded mode ``percentile`` returns the lower edge of the bucket the
    weighted CDF crosses (clipped to the observed [min, max]); the true
    weighted percentile lies inside that bucket, so the error is bounded by
    one bucket width — a relative ``growth - 1`` (~19% at the default
    ``growth = 2**0.25``).
    """

    __slots__ = ("lo", "growth", "exact_until", "n_buckets", "counts",
                 "values", "weights", "n", "wsum", "vwsum", "vmin", "vmax",
                 "_log_growth")

    def __init__(self, lo: float = 1e-3, hi: float = 1e7,
                 growth: float = 2 ** 0.25, exact_until: int = 4096):
        if not (lo > 0 and hi > lo and growth > 1):
            raise ValueError(f"invalid histogram bounds lo={lo} hi={hi} "
                             f"growth={growth}")
        self.lo = float(lo)
        self.growth = float(growth)
        self.exact_until = int(exact_until)
        self._log_growth = math.log(growth)
        # main buckets cover [lo, hi); index 0 is underflow (v < lo,
        # including non-positive values), index -1 is overflow (v >= hi)
        self.n_buckets = int(math.ceil(math.log(hi / lo) / self._log_growth))
        self.counts = None                   # allocated on first fold
        self.values: list = []               # exact mode storage
        self.weights: list = []
        self.n = 0                           # observations (not weight)
        self.wsum = 0.0                      # total weight
        self.vwsum = 0.0                     # weighted value sum (for mean)
        self.vmin = math.inf
        self.vmax = -math.inf

    # ---------------------------------------------------------- record --
    @property
    def folded(self) -> bool:
        return self.counts is not None

    def observe(self, value: float, weight: float = 1.0) -> None:
        value, weight = float(value), float(weight)
        self.n += 1
        self.wsum += weight
        self.vwsum += value * weight
        self.vmin = min(self.vmin, value)
        self.vmax = max(self.vmax, value)
        if self.counts is None:
            self.values.append(value)
            self.weights.append(weight)
            if self.n > self.exact_until:
                self._fold()
        else:
            self.counts[self._bucket(value)] += weight

    def _bucket(self, v: float) -> int:
        """Deterministic value -> bucket index (0 = underflow, last =
        overflow); merge associativity rests on this being order-free."""
        if v < self.lo:
            return 0
        i = int(math.floor(math.log(v / self.lo) / self._log_growth))
        return min(i + 1, self.n_buckets + 1)

    def _fold(self) -> None:
        self.counts = np.zeros(self.n_buckets + 2, np.float64)
        for v, w in zip(self.values, self.weights):
            self.counts[self._bucket(v)] += w
        self.values = []
        self.weights = []

    # ---------------------------------------------------------- derive --
    @property
    def mean(self) -> float:
        return self.vwsum / self.wsum if self.wsum else 0.0

    def bucket_lower_edge(self, i: int) -> float:
        """Lower edge of bucket ``i`` (underflow edge is 0.0)."""
        return 0.0 if i == 0 else self.lo * self.growth ** (i - 1)

    def percentile(self, q: float) -> float:
        if self.n == 0:
            return 0.0
        if self.counts is None:
            return weighted_percentile(self.values, self.weights, q)
        cdf = np.cumsum(self.counts)
        target = q / 100.0 * cdf[-1]
        i = int(np.searchsorted(cdf, target, side="left")
                .clip(0, len(cdf) - 1))
        # the true percentile lies inside bucket i: report its lower edge,
        # clipped to the observed range (tightens underflow/overflow)
        return float(min(max(self.bucket_lower_edge(i), self.vmin),
                         self.vmax))

    def relative_error_bound(self) -> float:
        """Worst-case relative error of ``percentile`` in folded mode."""
        return self.growth - 1.0

    # ----------------------------------------------------------- merge --
    def _compatible(self, other: "LogHistogram") -> bool:
        return (self.lo == other.lo and self.growth == other.growth
                and self.n_buckets == other.n_buckets
                and self.exact_until == other.exact_until)

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Fold ``other`` into ``self`` (in place; returns self).

        Associative over the final observation multiset: bucket state after
        any merge tree of the same observations is identical, because
        folding assigns each value its bucket independently of order."""
        if not self._compatible(other):
            raise ValueError("cannot merge histograms with different "
                             "bucket layouts")
        self.n += other.n
        self.wsum += other.wsum
        self.vwsum += other.vwsum
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        if self.counts is None and other.counts is None \
                and self.n <= self.exact_until:
            self.values.extend(other.values)
            self.weights.extend(other.weights)
            return self
        if self.counts is None:
            self._fold()
        if other.counts is None:
            for v, w in zip(other.values, other.weights):
                self.counts[self._bucket(v)] += w
        else:
            self.counts = self.counts + other.counts
        return self

    def copy(self) -> "LogHistogram":
        out = LogHistogram(self.lo,
                           self.lo * self.growth ** self.n_buckets,
                           self.growth, self.exact_until)
        out.n_buckets = self.n_buckets      # guard rounding drift
        out.merge(self)
        return out

    # ------------------------------------------------------- wire format --
    def to_dict(self) -> dict:
        """JSON-safe snapshot of the full histogram state (both exact and
        folded modes).  ``vmin``/``vmax`` are ±inf before the first
        observation — not representable in JSON — so an empty histogram
        serializes them as ``None``."""
        return {
            "lo": self.lo,
            "growth": self.growth,
            "exact_until": self.exact_until,
            "n_buckets": self.n_buckets,
            "counts": None if self.counts is None
            else [float(c) for c in self.counts],
            "values": [float(v) for v in self.values],
            "weights": [float(w) for w in self.weights],
            "n": self.n,
            "wsum": self.wsum,
            "vwsum": self.vwsum,
            "vmin": None if self.vmin == math.inf else self.vmin,
            "vmax": None if self.vmax == -math.inf else self.vmax,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LogHistogram":
        """Inverse of :meth:`to_dict` — bit-exact state restore, so
        round-trip-then-merge equals merge-then-round-trip."""
        out = cls.__new__(cls)
        out.lo = float(d["lo"])
        out.growth = float(d["growth"])
        out.exact_until = int(d["exact_until"])
        out._log_growth = math.log(out.growth)
        out.n_buckets = int(d["n_buckets"])
        out.counts = (None if d["counts"] is None
                      else np.asarray(d["counts"], np.float64))
        out.values = [float(v) for v in d["values"]]
        out.weights = [float(w) for w in d["weights"]]
        out.n = int(d["n"])
        out.wsum = float(d["wsum"])
        out.vwsum = float(d["vwsum"])
        out.vmin = math.inf if d["vmin"] is None else float(d["vmin"])
        out.vmax = -math.inf if d["vmax"] is None else float(d["vmax"])
        return out

    def __repr__(self) -> str:
        mode = f"folded[{self.n_buckets + 2}]" if self.folded else "exact"
        return (f"LogHistogram(n={self.n}, wsum={self.wsum:.1f}, "
                f"mode={mode})")


class Counters(collections.Counter):
    """Monotonic event counts; fleet rollup is a plain sum."""

    def merge(self, other) -> "Counters":
        self.update(other)
        return self


_GAUGE_SEQ = itertools.count(1)


class Gauges(dict):
    """Point-in-time values: the latest write wins — including across
    :meth:`merge`, which keeps whichever side wrote each key most recently
    (per a process-wide write sequence, so fleet rollups of live engines
    surface the freshest occupancy/queue-depth reading, not the stalest)."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self._seq: dict = {}
        if args or kwargs:
            self.update(dict(*args, **kwargs))

    def __setitem__(self, key, value) -> None:
        super().__setitem__(key, value)
        self._seq[key] = next(_GAUGE_SEQ)

    def set(self, key, value) -> None:
        self[key] = value

    def update(self, other=(), **kwargs) -> None:  # keep seq bookkeeping
        items = other.items() if hasattr(other, "items") else other
        for k, v in items:
            self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    def merge(self, other: "Gauges") -> "Gauges":
        other_seq = getattr(other, "_seq", {})
        for k, v in other.items():
            if k not in self or other_seq.get(k, 0) >= self._seq.get(k, 0):
                super().__setitem__(k, v)
                self._seq[k] = other_seq.get(k, next(_GAUGE_SEQ))
        return self

    def to_dict(self) -> dict:
        """JSON-safe snapshot preserving per-key write sequence numbers, so
        freshest-wins merge semantics survive a wire boundary."""
        return {"values": dict(self), "seq": dict(self._seq)}

    @classmethod
    def from_dict(cls, d: dict) -> "Gauges":
        out = cls()
        seq = d.get("seq", {})
        for k, v in d["values"].items():
            dict.__setitem__(out, k, v)
            out._seq[k] = int(seq.get(k, 0))
        return out
