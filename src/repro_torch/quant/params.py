"""Calibrate once, quantize weights once (``repro/quant/params.py``), on a
parameter dict of tensors.

    calib   = quant.calibrate(feed, observer="percentile", pct=99.9)
    qparams = quant.quantize_params(params, calib)

``quantize_params`` walks nested dicts and replaces weight leaves (by key
name, rank >= 2) with :class:`~repro_torch.quant.core.QuantizedTensor`:
per-channel symmetric int8 along the last (output) axis, with the scope's
calibrated input scale as ``act_scale``.  ``ops.conv1d`` and ``ops.mat_mul``
then take the int8 MAC path with no per-call weight work.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Mapping, Optional

import numpy as np
import torch

from repro_torch.quant.core import is_quantized, quantize_tensor
from repro_torch.quant.observers import make_observer

# weight-leaf key names eligible for int8: the operands of matmul/conv ops
DEFAULT_WEIGHT_KEYS = frozenset({
    "w", "wi", "wi_gate", "wo", "wq", "wk", "wv", "in_proj", "out_proj",
})


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Per-op input-activation scales, keyed by the op's scope name
    (``"conv1"`` for basecaller params ``{"conv1": {"w": ...}}``)."""
    act_scales: Mapping[str, np.ndarray]

    def act_scale(self, scope: str):
        return self.act_scales.get(scope)


def calibrate(feed: Iterable, *, observer: str = "minmax",
              **observer_kwargs) -> Calibration:
    """Fold streaming ``(scope, activation)`` pairs into per-scope scales
    (one observer per scope)."""
    obs: dict = {}
    for scope, x in feed:
        if scope not in obs:
            obs[scope] = make_observer(observer, **observer_kwargs)
        obs[scope].update(x)
    return Calibration({k: o.scale() for k, o in obs.items()})


def param_leaves(tree, path=()):
    """``(path, leaf)`` pairs of nested dicts; quantized leaves are opaque."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from param_leaves(v, path + (str(k),))
    else:
        yield path, tree


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (str(k),)) for k, v in tree.items()}
    return fn(path, tree)


def select_weight_leaf(names, leaf, weight_keys=DEFAULT_WEIGHT_KEYS) -> bool:
    """The one weight-leaf rule, shared by :func:`quantize_params` and
    QAT's ``fake_quant_params``, so training fake-quantizes exactly the
    leaves serving stores as int8: the last key in ``weight_keys``, a
    tensor of rank >= 2, not already quantized."""
    return bool(names and names[-1] in weight_keys
                and isinstance(leaf, torch.Tensor) and leaf.dim() >= 2)


def quantize_params(params, calib: Optional[Calibration] = None, *,
                    weight_keys: frozenset = DEFAULT_WEIGHT_KEYS,
                    per_channel: bool = True,
                    predicate: Optional[Callable] = None,
                    stack_dims: int = 0):
    """Replace weight leaves with int8 :class:`QuantizedTensor`s, once.

    ``calib``        optional :class:`Calibration`; a leaf under scope
                     ``foo`` picks up ``calib.act_scale("foo")`` as its
                     static input scale.
    ``weight_keys``  leaf key names to quantize (``DEFAULT_WEIGHT_KEYS``).
    ``per_channel``  one scale per output channel (last axis), else one
                     per tensor.
    ``predicate``    optional ``f(path_names, leaf) -> bool`` replacing the
                     key-name rule.
    ``stack_dims``   leading stack dims on every weight: per-channel scales
                     per stack entry, stored ``(*stack, C)`` with
                     ``axis=-1``.

    Biases and every other leaf pass through; already quantized leaves
    pass through unchanged, whatever the predicate says."""
    def leaf_fn(names, leaf):
        if is_quantized(leaf):
            return leaf
        take = (predicate(list(names), leaf) if predicate is not None
                else select_weight_leaf(names, leaf, weight_keys))
        if not take:
            return leaf
        act_scale = None
        if calib is not None:
            scope = names[-2] if len(names) >= 2 else names[-1]
            act_scale = calib.act_scale(scope)
        axis = leaf.dim() - 1 if per_channel else None
        return quantize_tensor(leaf, axis=axis, act_scale=act_scale,
                               stack_dims=stack_dims)
    return _map(params, leaf_fn)


def dequantize_params(params):
    """QuantizedTensor leaves -> float32 tensors."""
    return _map(params, lambda _, x: x.dequantize() if is_quantized(x) else x)


def params_precision(params) -> str:
    """The MAC datapath a parameter dict implies: ``"int8"`` when any
    weight is a stored :class:`QuantizedTensor`, else ``"bf16"`` when a
    floating leaf is bfloat16, else ``"fp32"`` (energy accounting)."""
    leaves = [leaf for _, leaf in param_leaves(params)]
    if any(is_quantized(x) for x in leaves):
        return "int8"
    if any(getattr(x, "dtype", None) == torch.bfloat16 for x in leaves):
        return "bf16"
    return "fp32"


def quantized_fraction(params) -> float:
    """Fraction of parameter scalars stored as int8."""
    total = q = 0
    for _, leaf in param_leaves(params):
        n = int(leaf.numel())
        total += n
        if is_quantized(leaf):
            q += n
    return q / max(total, 1)
