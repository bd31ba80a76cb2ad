"""Lossy array codecs for bandwidth-constrained links — gradients and
field-uplink frames (``repro/distributed/compression.py``), on tensors.

Two links are too narrow for raw float32 and share one codec: the
cross-pod gradient all-reduce (:func:`apply_compression` round-trips a dict
of gradient tensors through the codec with error feedback) and the device
-> aggregator field uplink (:mod:`repro_torch.field.uplink` reuses the
same compress/decompress pairs for signal payloads).

  * ``int8`` — :func:`compress_int8` / :func:`decompress_int8`: per-array
    symmetric quantization x ~ s * q, q in int8, on the port's
    :mod:`repro_torch.quant.core` (the one scale/clip/round).
  * ``topk`` — :func:`compress_topk` / :func:`decompress_topk`: magnitude
    top-k (k as a fraction), sent as (values, indices).  Equal magnitudes
    are taken lowest index first, in the order ``jax.lax.top_k`` promises
    (``torch.topk`` promises none), so the wire bytes equal JAX's.

Inputs may be tensors or numpy arrays (numpy is read as a CPU tensor).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.quant import core as qcore


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"         # none | int8 | topk
    topk_frac: float = 0.01
    error_feedback: bool = True


def _f32(g) -> torch.Tensor:
    return torch.as_tensor(g).to(torch.float32)


def _map(fn, *trees):
    """``fn`` over the tensor leaves of equally nested dicts."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k])]
    return [tree]


def init_residual(params):
    """Zero float32 residuals shaped like ``params`` (a dict of tensors)."""
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def compress_int8(g):
    """-> (int8 q, float32 scale): ``g ~ scale * q``."""
    gf = _f32(g)
    scale = qcore.symmetric_scale(qcore.absmax(gf))
    return qcore.quantize(gf, scale), scale


def decompress_int8(q, scale) -> torch.Tensor:
    q = torch.as_tensor(q)
    return qcore.dequantize(q, torch.as_tensor(scale, device=q.device))


def compress_topk(g, frac: float):
    """-> (values, int32 indices, n): the ``max(int(n * frac), 1)`` entries
    of largest magnitude, largest first, equal magnitudes lowest index
    first."""
    gf = _f32(g).reshape(-1)
    n = gf.shape[0]
    k = max(int(n * frac), 1)
    # a stable descending sort keeps equal magnitudes in index order
    _, order = torch.sort(gf.abs(), descending=True, stable=True)
    idx = order[:k]
    return gf[idx], idx.to(torch.int32), n


def decompress_topk(vals, idx, n: int, shape) -> torch.Tensor:
    vals = _f32(vals)
    out = torch.zeros((n,), dtype=torch.float32, device=vals.device)
    out[torch.as_tensor(idx, device=vals.device).long()] = vals
    return out.reshape(shape)


def apply_compression(grads, residual, cfg: CompressionConfig):
    """Round-trip a dict of gradient tensors through the compressor with
    error feedback; returns (effective grads, new residual)."""
    if cfg.kind == "none":
        return grads, residual

    def one(g, r):
        gf = g.to(torch.float32) + (r if cfg.error_feedback else 0.0)
        if cfg.kind == "int8":
            q, s = compress_int8(gf)
            ghat = decompress_int8(q, s)
        elif cfg.kind == "topk":
            vals, idx, n = compress_topk(gf, cfg.topk_frac)
            ghat = decompress_topk(vals, idx, n, gf.shape)
        else:
            raise ValueError(cfg.kind)
        new_r = (gf - ghat) if cfg.error_feedback else r
        return ghat.to(g.dtype), new_r

    pairs = _map(one, grads, residual)
    return (_map(lambda p, _: p[0], pairs, grads),
            _map(lambda p, _: p[1], pairs, grads))


def wire_bytes(grads, cfg: CompressionConfig) -> int:
    """Bytes that would cross the link per step for ``grads``."""
    total = 0
    for g in _leaves(grads):
        n = int(np.prod(tuple(g.shape)))
        if cfg.kind == "none":
            total += n * 4
        elif cfg.kind == "int8":
            total += n + 4
        elif cfg.kind == "topk":
            k = max(int(n * cfg.topk_frac), 1)
            total += k * 8
    return total
