"""Shared int8 numerics (``repro/quant/core.py``): the one scale, clip and
round of the port.

    q = clip(round(x / s), -127, 127),   s = max(absmax, eps) / 127

Symmetric, zero-point-free, per tensor (a scalar scale) or per channel (one
scale per entry of ``axis``).  The numerics are pinned bit for bit to the
JAX package's:

- ``x / s`` is a true IEEE division.  A CUDA tensor divided by a CPU scalar
  makes PyTorch multiply by the reciprocal instead, which can be an ulp
  off, so every divisor here is a tensor on the dividend's device.
- ``torch.round`` rounds half to even, as ``jnp.round`` does.

:class:`QuantizedTensor` is the quantize-once container: int8 payload, its
scales, the channel ``axis`` and an optional calibrated ``act_scale`` for
the op's input.  It caches the layouts the CUDA kernels read (the weights
packed four input channels to a word, or in ``mma.sync`` fragment order,
and ``act_scale * scale``).
"""
from __future__ import annotations

from typing import Optional

import torch

QMAX = 127          # int8 symmetric range: [-127, 127]
EPS = 1e-8          # absmax floor so all-zero tensors get a valid scale


def _f32(x, device) -> torch.Tensor:
    """``x`` as a float32 tensor on ``device`` (never a CPU scalar)."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def absmax(x: torch.Tensor, axis: Optional[int] = None) -> torch.Tensor:
    """Max |x|: per tensor (0-d) or per channel of ``axis`` (1-D)."""
    xf = x.float().abs()
    if axis is None:
        return xf.amax()
    keep = axis % x.dim()
    dims = tuple(i for i in range(x.dim()) if i != keep)
    return xf.amax(dim=dims) if dims else xf


def symmetric_scale(amax, *, qmax: int = QMAX, eps: float = EPS,
                    device=None) -> torch.Tensor:
    """The canonical scale ``max(absmax, eps) / qmax`` in float32."""
    if device is None:
        device = amax.device if isinstance(amax, torch.Tensor) else "cpu"
    a = _f32(amax, device)
    return torch.maximum(a, _f32(eps, device)) / _f32(qmax, device)


def dynamic_scale(amax: torch.Tensor) -> torch.Tensor:
    """A per-call activation scale as jitted JAX forms it: ``max(absmax,
    eps)`` times the float32 reciprocal of 127.  Under ``jax.jit`` (JAX's
    serving and training steps) XLA folds the division by the constant
    into that product, which is an ulp off :func:`symmetric_scale`'s true
    division for about 5% of absmax values; then every output of the
    projection is an ulp off too."""
    device = amax.device
    return (torch.maximum(_f32(amax, device), _f32(EPS, device))
            * _f32(1.0 / QMAX, device))


def _broadcast_scale(scale, ndim: int, axis: Optional[int], device):
    s = _f32(scale, device)
    if axis is None or s.dim() == 0:
        return s
    if s.dim() == 1:
        shape = [1] * ndim
        shape[axis % ndim] = s.shape[0]
        return s.reshape(shape)
    # a stacked per-channel scale (quantize_tensor's stack_dims): its last
    # dim runs along the payload's last, its leading dims along the
    # payload's leading stack dims
    if axis % ndim != ndim - 1:
        raise ValueError(
            f"stacked scale (ndim={s.dim()}) requires channel-last payload "
            f"axis, got axis={axis} of {ndim}")
    return s.reshape(list(s.shape[:-1]) + [1] * (ndim - s.dim())
                     + [s.shape[-1]])


def quantize(x: torch.Tensor, scale, *, axis: Optional[int] = None,
             qmax: int = QMAX) -> torch.Tensor:
    """``clip(round(x / scale))`` as int8; ``scale`` scalar or per ``axis``."""
    s = _broadcast_scale(scale, x.dim(), axis, x.device)
    q = torch.round(x.float() / s)
    return torch.clamp(q, -qmax, qmax).to(torch.int8)


def dequantize(q: torch.Tensor, scale, *,
               axis: Optional[int] = None) -> torch.Tensor:
    """int8 -> float32: ``q * scale``."""
    return q.float() * _broadcast_scale(scale, q.dim(), axis, q.device)


def pack_words(w: torch.Tensor) -> torch.Tensor:
    """(K, Cin, Cout) int8 -> (K, Cin/4, Cout) int32, each word holding
    input channels 4i .. 4i+3 of one (k, cout), lowest byte first: the
    weight operand of ``__dp4a`` in the int8 CUDA kernels."""
    k, cin, cout = w.shape
    if w.dtype != torch.int8 or cin % 4:
        raise ValueError(f"pack_words: needs int8 with Cin % 4 == 0, got "
                         f"{w.dtype} with Cin={cin}")
    words = w.reshape(k, cin // 4, 4, cout).permute(0, 1, 3, 2).contiguous()
    return words.view(torch.int32).reshape(k, cin // 4, cout)


def pack_fragments(w: torch.Tensor) -> torch.Tensor:
    """(K, Cin, Cout) int8 -> (K, Cin/32, Cout/8, 32, 2) int32: the B
    fragments of ``mma.sync.m16n8k32`` (``csrc/mma.cuh``), one per tap,
    32-channel slice and 8-column n-tile, each lane's two registers in
    place.  Lane 4 g + t holds column 8 j + g; register 0 input channels
    32 s + 4 t .. + 3, register 1 those 16 on, lowest byte first.  The
    weight operand of the fused int8 tick's tensor-core layers."""
    k, cin, cout = w.shape
    if w.dtype != torch.int8 or cin % 32 or cout % 8:
        raise ValueError(f"pack_fragments: needs int8 with Cin % 32 == 0 "
                         f"and Cout % 8 == 0, got {w.dtype} with Cin={cin}, "
                         f"Cout={cout}")
    # (k, slice, register, t, byte, n-tile, g) -> (k, slice, n-tile, g, t,
    # register, byte)
    frags = w.reshape(k, cin // 32, 2, 4, 4, cout // 8, 8).permute(
        0, 1, 5, 6, 3, 2, 4).contiguous()
    return frags.view(torch.int32).reshape(k, cin // 32, cout // 8, 32, 2)


class QuantizedTensor:
    """Quantize-once weight storage: int8 values plus their scales.

    ``q``          int8 payload, the shape of the float weight it replaces
    ``scale``      float32 0-d (per tensor) or (C,) (per channel)
    ``axis``       the channel axis ``scale`` runs along; ``None`` = per tensor
    ``act_scale``  calibrated 0-d scale of the op's input activation, or
                   ``None`` to quantize the activation per call
    """

    def __init__(self, q, scale, axis=None, act_scale=None):
        self.q = q
        self.scale = scale
        self.axis = axis
        self.act_scale = act_scale
        self._cache: dict = {}

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.dim()

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def device(self):
        return self.q.device

    def numel(self) -> int:
        return self.q.numel()

    def dequantize(self) -> torch.Tensor:
        return dequantize(self.q, self.scale, axis=self.axis)

    def __getitem__(self, i: int) -> "QuantizedTensor":
        """Entry ``i`` of a stacked payload (``quantize_tensor``'s
        ``stack_dims``): the payload, a ``(*stack, C)`` scale and a stacked
        act scale are indexed together, so a block peeled off the stack
        sees the plain ``(C,)`` convention (JAX's ``lax.scan`` over the
        QuantizedTensor's children)."""
        scale = self.scale
        if scale.dim() == self.q.dim() - 1 and scale.dim() > 1:
            scale = scale[i]
        act = self.act_scale
        if act is not None and act.dim() >= 1:
            act = act[i]
        return QuantizedTensor(self.q[i], scale, self.axis, act)

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(
            self.q.to(device), self.scale.to(device), self.axis,
            None if self.act_scale is None else self.act_scale.to(device))

    def head_matrix(self) -> "QuantizedTensor":
        """A (1, Cin, Cout) k=1 conv weight as the (Cin, Cout) GEMM
        operand (per-channel scales then run along axis 1)."""
        return QuantizedTensor(self.q[0], self.scale,
                               None if self.axis is None else 1,
                               self.act_scale)

    def packed(self) -> torch.Tensor:
        """The payload with four consecutive input channels packed into one
        int32 word, ``(K, Cin/4, Cout)``: the operand of ``__dp4a`` in the
        int8 kernels.  Cached; needs a (K, Cin, Cout) payload with
        Cin % 4 == 0."""
        if "packed" not in self._cache:
            self._cache["packed"] = pack_words(self.q)
        return self._cache["packed"]

    def fragments(self) -> torch.Tensor:
        """The payload as ``mma.sync`` B fragments (:func:`pack_fragments`):
        the operand of the fused int8 tick's tensor-core layers.  Cached."""
        if "fragments" not in self._cache:
            self._cache["fragments"] = pack_fragments(self.q)
        return self._cache["fragments"]

    def dequant_scale(self) -> torch.Tensor:
        """``act_scale * scale`` in float32, broadcast to (Cout,): the
        combined epilogue scale of a calibrated layer.  Cached."""
        if "dequant" not in self._cache:
            if self.act_scale is None:
                raise ValueError("dequant_scale: no calibrated act_scale")
            cout = self.q.shape[-1]
            s = _f32(self.act_scale, self.q.device) * _f32(self.scale,
                                                           self.q.device)
            self._cache["dequant"] = s.expand(cout).contiguous()
        return self._cache["dequant"]

    def __repr__(self) -> str:
        return (f"QuantizedTensor(shape={tuple(self.q.shape)}, "
                f"axis={self.axis}, act_scale="
                f"{None if self.act_scale is None else float(self.act_scale)})")


def quantize_tensor(w: torch.Tensor, *, axis: Optional[int] = None,
                    act_scale=None, stack_dims: int = 0) -> QuantizedTensor:
    """Quantize a float weight once: absmax -> scale -> int8.

    ``stack_dims > 0`` treats the leading dims as a parameter stack (the
    transformer's leading block dim): per-channel scales are taken per
    stack entry and stored ``(*stack, C)`` with ``axis=-1``, so a block
    peeled off the stack sees the plain ``(C,)`` convention (JAX's
    ``quantize_tensor``)."""
    if stack_dims and axis is not None:
        nd = w.dim()
        if axis % nd != nd - 1:
            raise ValueError(
                f"stack_dims={stack_dims} requires channel-last axis, got "
                f"axis={axis} of {nd}")
        stack_dims = min(stack_dims, nd - 2)
        reduce_axes = tuple(range(stack_dims, nd - 1))
        amax = w.float().abs().amax(dim=reduce_axes)
        scale = symmetric_scale(amax, device=w.device)
        axis = -1
        q = quantize(w, scale, axis=axis)
    else:
        scale = symmetric_scale(absmax(w, axis), device=w.device)
        q = quantize(w, scale, axis=axis)
    if act_scale is not None:
        act_scale = _f32(act_scale, w.device)
        if stack_dims and act_scale.dim() == 0:
            act_scale = act_scale.expand(w.shape[:stack_dims]).contiguous()
    return QuantizedTensor(q, scale, axis, act_scale)


def is_quantized(x) -> bool:
    return isinstance(x, QuantizedTensor)
