"""Calibration observers (``repro/quant/observers.py``, a numpy copy):
activation ranges from streaming chunks.

Post-training quantization needs one number per activation tensor — the
scale — and the edge deployment shape dictates how it is found: signal
streams through in chunks, so observers fold one chunk at a time into a
running statistic and never hold more than a histogram.

``MinMaxObserver``      running absmax (exact, outlier-sensitive)
``PercentileObserver``  histogram of |x| with range doubling; the scale
                        comes from a high percentile (e.g. 99.9), which
                        clips rare outliers — usually tighter scales and
                        better int8 accuracy on heavy-tailed activations.

Observers are host-side (numpy): calibration is an offline pass, not part
of the serving path.  A tensor on the card is copied to the host first.
"""
from __future__ import annotations

import numpy as np

from repro_torch.quant.core import EPS, QMAX


def _scale(amax) -> np.ndarray:
    """``max(absmax, eps) / qmax`` in float32, as ``quant.core``."""
    a = np.asarray(amax, np.float32)
    return np.maximum(a, np.float32(EPS)) / np.float32(QMAX)


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):           # a torch tensor, possibly on the card
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


class MinMaxObserver:
    """Running absmax over every chunk seen."""

    def __init__(self, axis: int | None = None):
        self.axis = axis
        self._amax: np.ndarray | None = None

    def update(self, x) -> None:
        x = np.abs(_host(x))
        if self.axis is None:
            amax = x.max() if x.size else np.float32(0.0)
        else:
            reduce_axes = tuple(i for i in range(x.ndim)
                                if i != (self.axis % x.ndim))
            amax = x.max(axis=reduce_axes)
        self._amax = amax if self._amax is None else np.maximum(self._amax,
                                                                amax)

    @property
    def observed_absmax(self):
        return np.float32(0.0) if self._amax is None else self._amax

    def scale(self):
        return _scale(self.observed_absmax)


class PercentileObserver:
    """Streaming percentile of |x| via a range-doubling histogram.

    Keeps ``bins`` counts over [0, range); when a chunk exceeds the range,
    the range doubles and counts fold pairwise (bin i -> bin i//2), so
    memory stays O(bins) for arbitrarily long streams.  ``scale()`` reads
    the ``pct`` percentile off the histogram CDF (upper bin edge —
    conservative) and turns it into the canonical symmetric scale.
    """

    def __init__(self, pct: float = 99.9, bins: int = 2048):
        if not 0.0 < pct <= 100.0:
            raise ValueError(f"pct must be in (0, 100], got {pct}")
        self.pct = pct
        self.bins = bins
        self._counts = np.zeros(bins, np.int64)
        self._range = 0.0   # histogram covers [0, _range)

    def update(self, x) -> None:
        x = np.abs(_host(x)).reshape(-1)
        if x.size == 0:
            return
        amax = float(x.max())
        if self._range == 0.0:
            self._range = amax if amax > 0 else 1.0
        while amax > self._range:
            # fold counts pairwise: bin i covers what bins 2i, 2i+1 did
            folded = self._counts.reshape(self.bins // 2, 2).sum(axis=1)
            self._counts[: self.bins // 2] = folded
            self._counts[self.bins // 2:] = 0
            self._range *= 2.0
        idx = np.minimum((x / self._range * self.bins).astype(np.int64),
                         self.bins - 1)
        np.add.at(self._counts, idx, 1)

    @property
    def observed_absmax(self):
        """The ``pct``-percentile of |x| (upper edge of the covering bin)."""
        total = self._counts.sum()
        if total == 0:
            return np.float32(0.0)
        cdf = np.cumsum(self._counts)
        target = self.pct / 100.0 * total
        bin_idx = int(np.searchsorted(cdf, target, side="left"))
        edge = (bin_idx + 1) / self.bins * self._range
        return np.float32(edge)

    def scale(self):
        return _scale(self.observed_absmax)


OBSERVERS = {"minmax": MinMaxObserver, "percentile": PercentileObserver}


def make_observer(kind: str = "minmax", **kwargs):
    if kind not in OBSERVERS:
        raise KeyError(f"unknown observer {kind!r}; one of {sorted(OBSERVERS)}")
    return OBSERVERS[kind](**kwargs)
