"""Fake-quant for quantization-aware training (``repro/quant/fake_quant.py``).

Forward: the exact int8 round trip serving applies (quantize, then
dequantize, with the one symmetric scheme of :mod:`repro_torch.quant.core`).
Backward: straight through, ``x + (r - x).detach()``, so the gradient
reaches the float weights as if the rounding were the identity.

JAX's fake-quant runs under ``jax.jit`` wherever it trains (the step of
``train_micro_basecaller`` is jitted), and there XLA folds the division of
the absmax by the constant 127 into a product with its float32
reciprocal, which moves some scales by one ulp from ``symmetric_scale``'s
true division.  The default scale here is that product, so the QAT
forward equals JAX's training forward bit for bit.  Deployment
(``quantize_params``, never jitted in JAX) keeps the true division.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.quant.core import absmax, dequantize, dynamic_scale, quantize
from repro_torch.quant.params import (DEFAULT_WEIGHT_KEYS, _map,
                                      select_weight_leaf)


def fake_quant(x: torch.Tensor, *, axis: Optional[int] = None,
               scale=None) -> torch.Tensor:
    """int8 round trip with a straight-through gradient.  ``scale`` pins
    the scale; by default it is the tensor's own absmax scale, per
    ``axis`` or per tensor, as jitted JAX forms it: ``max(absmax, eps)``
    times the float32 reciprocal of 127."""
    if scale is None:
        scale = dynamic_scale(absmax(x.detach(), axis))
    rounded = dequantize(quantize(x.detach(), scale, axis=axis), scale,
                         axis=axis).to(x.dtype)
    return x + (rounded - x).detach()


def fake_quant_params(params, *, weight_keys: frozenset = DEFAULT_WEIGHT_KEYS,
                      per_channel: bool = True):
    """Fake-quantize the leaves ``quantize_params`` would store as int8
    (``select_weight_leaf``), and nothing else."""
    def leaf_fn(names, leaf):
        if not select_weight_leaf(names, leaf, weight_keys):
            return leaf
        return fake_quant(leaf, axis=leaf.dim() - 1 if per_channel else None)
    return _map(params, leaf_fn)


def fake_quant_activation(x: torch.Tensor, scale=None) -> torch.Tensor:
    """Per-tensor activation fake-quant (its own scale unless pinned)."""
    return fake_quant(x, axis=None, scale=scale)
