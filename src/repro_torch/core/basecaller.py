"""The paper's CNN basecaller (``repro/core/basecaller.py``) on PyTorch.

Six conv layers separated by ReLU, widths 1->64->64->96->192->128->5,
kernels 5/7/7/9/9/1, strides 1/2/1/2/1/1: 460,261 parameters.  Parameters
are a plain dict ``{"convN": {"w": (K, Cin, Cout), "b": (Cout,)}}`` of
tensors, the JAX layout, so :func:`load_numpy_params` carries a JAX
parameter tree across unchanged.  Every conv layer runs through
``kernels.ops.conv1d`` / ``conv1d_stream`` and the k=1 head through
``kernels.ops.mat_mul``; the tensors' device picks kernel or plain version.
A weight stored as a :class:`repro_torch.quant.QuantizedTensor` (from
:func:`quantize`) runs every layer on the int8 MAC path.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.conv1d import stream_carry_len
from repro_torch.quant import core as qcore

NUM_CLASSES = 5  # blank + ACGT


@dataclasses.dataclass(frozen=True)
class BasecallerConfig:
    kernels: tuple[int, ...] = (5, 7, 7, 9, 9, 1)
    channels: tuple[int, ...] = (64, 64, 96, 192, 128, NUM_CLASSES)
    strides: tuple[int, ...] = (1, 2, 1, 2, 1, 1)
    in_channels: int = 1
    dtype: torch.dtype = torch.float32

    @property
    def total_stride(self) -> int:
        out = 1
        for s in self.strides:
            out *= s
        return out

    @property
    def receptive_field(self) -> int:
        rf, stride = 1, 1
        for k, s in zip(self.kernels, self.strides):
            rf += (k - 1) * stride
            stride *= s
        return rf


def init(generator: torch.Generator, cfg: BasecallerConfig = BasecallerConfig(),
         *, device="cuda"):
    """He-initialised parameters drawn from ``generator`` (a CPU
    ``torch.Generator``), then moved to ``device``."""
    dev = resolve_device(device)
    params = {}
    cin = cfg.in_channels
    for i, (k, cout) in enumerate(zip(cfg.kernels, cfg.channels)):
        w = torch.randn((k, cin, cout), generator=generator,
                        dtype=cfg.dtype) * math.sqrt(2.0 / (k * cin))
        params[f"conv{i + 1}"] = {
            "w": w.to(dev), "b": torch.zeros((cout,), dtype=cfg.dtype,
                                             device=dev)}
        cin = cout
    return params


_QT_KEYS = frozenset({"q", "scale", "axis", "act_scale"})


def _tensor(a, dev):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 (JAX's bf16 in numpy), which torch.from_numpy
        # refuses: carry the bits through int16 and view them as bf16
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def load_numpy_params(tree, device="cuda"):
    """A parameter tree of numpy arrays (e.g. ``jax.tree.map(np.asarray,
    params)`` of the JAX package's CNN) as tensors on ``device``.  A
    quantized weight comes as a dict ``{"q", "scale", "axis",
    "act_scale"}`` of numpy arrays (``axis`` an int or None, ``act_scale``
    None when uncalibrated), or as any object with those four attributes
    (a JAX ``QuantizedTensor`` after ``jax.tree.map(np.asarray, ...)``),
    and loads as a :class:`QuantizedTensor`.  Every value carries bit for
    bit, bf16 included."""
    dev = resolve_device(device)
    if isinstance(tree, dict) and set(tree) == _QT_KEYS:
        fields = tree
    elif all(hasattr(tree, k) for k in _QT_KEYS):
        fields = {k: getattr(tree, k) for k in _QT_KEYS}
    else:
        fields = None
    if fields is not None:
        axis, sa = fields["axis"], fields["act_scale"]
        return qcore.QuantizedTensor(
            _tensor(fields["q"], dev), _tensor(fields["scale"], dev),
            None if axis is None else int(axis),
            None if sa is None else _tensor(sa, dev))
    if isinstance(tree, dict):
        return {k: load_numpy_params(v, dev) for k, v in tree.items()}
    return _tensor(tree, dev)


def params_to(params, device):
    """The parameter dict with every tensor (and quantized weight) moved to
    ``device``."""
    dev = resolve_device(device)
    if isinstance(params, dict):
        return {k: params_to(v, dev) for k, v in params.items()}
    return params.to(dev)


def num_params(params) -> int:
    return sum(int(layer[k].numel()) for layer in params.values()
               for k in ("w", "b"))


@dataclasses.dataclass(frozen=True)
class StreamLayerSpec:
    """Static geometry of one streaming conv layer."""
    name: str
    ksize: int
    stride: int
    cin: int
    cout: int
    carry_rows: int          # K - stride input rows carried across chunks
    activation: str          # "relu" for hidden layers, "none" for the head
    is_head: bool            # k=1/s=1: lowered as a GEMM, carries no state


def stream_layer_specs(cfg: BasecallerConfig = BasecallerConfig()
                       ) -> tuple[StreamLayerSpec, ...]:
    """The full per-layer streaming layout of this CNN, in order."""
    n = len(cfg.kernels)
    cins = (cfg.in_channels,) + cfg.channels[:-1]
    return tuple(
        StreamLayerSpec(
            name=f"conv{i + 1}", ksize=k, stride=s, cin=cin, cout=cout,
            carry_rows=stream_carry_len(k, s),
            activation="relu" if i < n - 1 else "none",
            is_head=(k == 1 and s == 1))
        for i, (k, s, cin, cout) in enumerate(
            zip(cfg.kernels, cfg.strides, cins, cfg.channels)))


def init_stream_state(cfg: BasecallerConfig, batch: int, *, device="cuda"):
    """Zero carries for ``batch`` concurrent channel sessions: one
    (batch, K_i - stride_i, Cin_i) tensor per layer, lane-major."""
    dev = resolve_device(device)
    return [torch.zeros((batch, sp.carry_rows, sp.cin), dtype=cfg.dtype,
                        device=dev) for sp in stream_layer_specs(cfg)]


def _conv1x1_as_matmul(x, w, b, activation):
    """A k=1/stride=1 conv is a GEMM: the head runs on the matmul kernel
    (a quantized head on the int8 one)."""
    bsz, t, cin = x.shape
    w2 = w.head_matrix() if qcore.is_quantized(w) else w[0]
    y = ops.mat_mul(x.reshape(bsz * t, cin), w2, b, activation=activation)
    return y.reshape(bsz, t, w.shape[-1])


def _as_frames(signal: torch.Tensor, cfg: BasecallerConfig) -> torch.Tensor:
    x = signal[..., None] if signal.dim() == 2 else signal
    return x.to(cfg.dtype)


def apply_stream_core(params, state, chunk, *, cfg: BasecallerConfig):
    """One streaming step over (B, T) or (B, T, 1) signal: returns
    ``(logits (B, T // total_stride, 5), new_state)``."""
    x = _as_frames(chunk, cfg)
    if x.shape[1] % cfg.total_stride:
        raise ValueError(f"chunk length {x.shape[1]} must be a multiple of "
                         f"total_stride={cfg.total_stride}")
    new_state = []
    for i, sp in enumerate(stream_layer_specs(cfg)):
        p = params[sp.name]
        if sp.is_head:
            x = _conv1x1_as_matmul(x, p["w"], p["b"], sp.activation)
            new_state.append(state[i])
        else:
            x, carry = ops.conv1d_stream(x, p["w"], p["b"], state[i],
                                         stride=sp.stride,
                                         activation=sp.activation)
            new_state.append(carry)
    return x, new_state


def apply_stream(params, state, chunk, cfg: BasecallerConfig = BasecallerConfig()):
    """Basecall one chunk, carrying conv overlap across chunks.  Feeding a
    read chunk by chunk and concatenating the logits equals
    ``apply(..., padding="stream")`` over the whole read."""
    return apply_stream_core(params, state, chunk, cfg=cfg)


def apply(params, signal: torch.Tensor,
          cfg: BasecallerConfig = BasecallerConfig(), *,
          padding: str = "same") -> torch.Tensor:
    """(B, T) or (B, T, 1) signal -> logits (B, T', 5).

    ``"same"`` is the offline whole-read path (centred padding);
    ``"stream"`` pads K - stride rows on the left of each layer, the exact
    whole-read reference for :func:`apply_stream`."""
    if padding == "stream":
        state = init_stream_state(cfg, signal.shape[0],
                                  device=signal.device)
        logits, _ = apply_stream_core(params, state, signal, cfg=cfg)
        return logits
    if padding != "same":
        raise ValueError(padding)
    x = _as_frames(signal, cfg)
    for sp in stream_layer_specs(cfg):
        p = params[sp.name]
        if sp.is_head:
            x = _conv1x1_as_matmul(x, p["w"], p["b"], sp.activation)
        else:
            x = ops.conv1d(x, p["w"], p["b"], stride=sp.stride,
                           padding="same", activation=sp.activation)
    return x


def layer_inputs(params, signal: torch.Tensor,
                 cfg: BasecallerConfig = BasecallerConfig()):
    """Yield ``(scope, activation)`` pairs, each conv layer's *input*, for
    calibration observers (:func:`repro_torch.quant.calibrate`).  Runs the
    float forward pass ("same" padding) on the params' device; call it with
    the float params."""
    x = _as_frames(signal, cfg)
    for sp in stream_layer_specs(cfg):
        p = params[sp.name]
        yield sp.name, x
        x = ops.conv1d(x, p["w"], p["b"], stride=sp.stride, padding="same",
                       activation=sp.activation)


def layer_inputs_stream(params, chunks,
                        cfg: BasecallerConfig = BasecallerConfig()):
    """Calibration feed over a stream of signal chunks (numpy or tensors),
    each moved to the params' device."""
    dev = params[stream_layer_specs(cfg)[0].name]["w"].device
    for chunk in chunks:
        yield from layer_inputs(params, torch.as_tensor(chunk).to(dev), cfg)


def quantize(params, cfg: BasecallerConfig = BasecallerConfig(), *,
             chunks=None, observer: str = "minmax", **observer_kwargs):
    """Calibrate once, quantize once: int8 params for this CNN
    (``repro/core/basecaller.py::quantize``).  ``chunks`` are ``(B, T)``
    signal chunks to calibrate the activation scales from; without them
    the activations quantize per call (weight-only), which breaks the
    chunked == whole-read equivalence of streaming, so streaming callers
    pass ``chunks``."""
    from repro_torch import quant
    calib = None
    if chunks is not None:
        calib = quant.calibrate(layer_inputs_stream(params, chunks, cfg),
                                observer=observer, **observer_kwargs)
    return quant.quantize_params(params, calib)


def output_len(cfg: BasecallerConfig, t: int) -> int:
    for s in cfg.strides:
        t = -(-t // s)
    return t


def stream_state_spec(cfg: BasecallerConfig = BasecallerConfig()):
    """Per-layer ``(carry_rows, in_channels)`` of the streaming state."""
    cins = (cfg.in_channels,) + cfg.channels[:-1]
    return [(stream_carry_len(k, s), cin)
            for k, s, cin in zip(cfg.kernels, cfg.strides, cins)]


def weight_concentration(params) -> float:
    """Fraction of the parameters in the two largest layers (the paper:
    ~80%)."""
    from repro_torch.utils.tree import tree_count
    sizes = sorted((tree_count(layer) for layer in params.values()),
                   reverse=True)
    return sum(sizes[:2]) / sum(sizes)
