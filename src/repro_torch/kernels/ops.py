"""Public kernel entry points — thin fabric wrappers (``repro/kernels/ops.py``).

Each op counts its dispatch under ``fabric.dispatch.<op>.<target>`` (the
target is the tensor's device: ``cuda`` or ``reference``) and calls the
kernel wrapper, which launches the CUDA kernel for a CUDA tensor and runs
the plain PyTorch version for a CPU tensor.  A ``meta`` tensor (target
``meta``, the dry run's tracing device) runs the plain version through
``fabric.meta_kernel``, which computes shapes only.

Quantization: a weight passed as a
:class:`repro_torch.quant.QuantizedTensor` takes the SoC's int8 -> int32
MAC path on every device, as in JAX: the activation is quantized here
(statically with the calibrated ``act_scale``, counted
``fabric.precision.<op>.act_static``, else from this call's absmax), the
int8 kernel accumulates in int32 (counted ``fabric.precision.<op>.int8``),
and :func:`_int8_epilogue` dequantizes.  The per-call ``precision="int8"``
policy on float weights is not ported (the port has no tuning tables).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import conv1d as _conv1d
from repro_torch.kernels import edit_distance as _ed
from repro_torch.kernels import fabric
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.quant import core as qcore


# ----------------------------------------------------------- int8 common --
def _quantized_operands(op: str, a, w):
    """The quantized activation and the combined dequant scale for one
    int8 MAC dispatch: ``(aq, scale)`` with ``scale = sa * sw`` formed in
    float32 once (``repro/kernels/ops.py::_quantized_operands``)."""
    if w.axis is not None and w.axis % w.ndim != w.ndim - 1:
        raise ValueError(
            f"{op}: per-channel scales must run along the output (last) "
            f"weight axis, got axis={w.axis} for shape {tuple(w.shape)}")
    if w.act_scale is None:
        sa = qcore.dynamic_scale(qcore.absmax(a))
        scale = sa * w.scale.to(a.device)
    else:
        fabric.record(f"fabric.precision.{op}.act_static")
        sa = w.act_scale
        scale = w.dequant_scale()
    return qcore.quantize(a, sa), scale


def _int8_epilogue(acc, scale, bias, activation):
    """int32 accumulator -> float32: ``fma(float(acc), scale, bias)`` with
    one rounding, then the activation.  Under jit XLA contracts JAX's
    ``acc.astype(f32) * scale + bias`` into that one fused multiply-add
    (:func:`ref.fma_f32`; the CUDA kernels use ``__fmaf_rn``)."""
    return ref.ACTIVATIONS[activation](ref.fma_f32(acc.float(), scale, bias))


def conv1d_int8(x, w, bias=None, *, stride: int = 1,
                activation: str = "none"):
    """'valid' conv on the int8 MAC path: quantize, int8 conv, epilogue."""
    aq, scale = _quantized_operands("conv1d", x, w)
    fabric.record("fabric.precision.conv1d.int8")
    packed = frags = None
    if aq.is_cuda:
        ksize, cin, cout = w.shape
        if _conv1d.int8_tensor_core_shape(cin, cout, ksize, stride):
            frags = w.fragments()
        elif cin % 4 == 0:
            packed = w.packed()
    acc = _conv1d.conv1d_int8(aq, w.q, stride=stride, w_packed=packed,
                              w_fragments=frags)
    return _int8_epilogue(acc, scale, bias, activation)


def matmul_int8(a, w, bias=None, *, activation: str = "none"):
    """GEMM on the int8 MAC path: quantize, int8 GEMM, epilogue, in
    ``a``'s dtype (JAX's ``out_dtype or a.dtype``: a bf16 LM's
    projections return bf16, rounded once from the float32 epilogue)."""
    aq, scale = _quantized_operands("matmul", a, w)
    fabric.record("fabric.precision.matmul.int8")
    return _int8_epilogue(_mm.matmul_int8(aq, w.q), scale, bias,
                          activation).to(a.dtype)


def int8_reference(x, w, bias=None, *, stride: int = 1,
                   activation: str = "none"):
    """The int8 MAC path with the plain integer conv (3-D ``w``) or GEMM
    (2-D ``w``) on any device: the fused tick's plain twin
    (``repro/kernels/ops.py::_conv1d_reference`` / ``_matmul_reference``)."""
    op = "conv1d" if w.ndim == 3 else "matmul"
    aq, scale = _quantized_operands(op, x, w)
    fabric.record(f"fabric.precision.{op}.int8")
    acc = (ref.conv1d_int8(aq, w.q, stride=stride) if w.ndim == 3
           else ref.matmul_int8(aq, w.q))
    return _int8_epilogue(acc, scale, bias, activation)


def mat_mul(a, b, bias=None, *, activation: str = "none"):
    """activation(a @ b + bias) for arbitrary (M, K) x (K, N); ``b`` may be
    a ``QuantizedTensor`` (the int8 MAC path); bf16 operands take the bf16
    kernel (float32 sums, one rounding to bf16)."""
    fabric.dispatch("matmul", a)
    if qcore.is_quantized(b):
        return matmul_int8(a, b, bias, activation=activation)
    if a.dtype == torch.bfloat16:
        return _mm.matmul_bf16(a, b, bias, activation=activation)
    return _mm.matmul(a, b, bias, activation=activation)


def conv1d(x, w, bias=None, *, stride: int = 1, padding: str = "same",
           activation: str = "none"):
    """Conv1d over (B, T, Cin) with (K, Cin, Cout) weights (a
    ``QuantizedTensor`` takes the int8 MAC path).  ``"same"`` pads
    ``ceil(T / stride)`` outputs' worth, the smaller half on the left
    (``repro/kernels/ops.py``); ``"valid"`` pads nothing."""
    ksize = w.shape[0]
    if padding == "same":
        t = x.shape[1]
        t_out = -(-t // stride)
        pad_total = max((t_out - 1) * stride + ksize - t, 0)
        x = F.pad(x, (0, 0, pad_total // 2, pad_total - pad_total // 2))
    elif padding != "valid":
        raise ValueError(padding)
    fabric.dispatch("conv1d", x)
    if qcore.is_quantized(w):
        return conv1d_int8(x, w, bias, stride=stride, activation=activation)
    return _conv1d.conv1d(x.contiguous(), w, bias, stride=stride,
                          activation=activation)


def conv1d_stream(x, w, bias=None, carry=None, *, stride: int = 1,
                  activation: str = "none"):
    """Stateful chunked conv1d over (B, T, Cin); T % stride == 0.

    ``carry`` is the (B, K - stride, Cin) tail of the preceding chunks
    (None at stream start).  Emits exactly T / stride frames and the new
    carry, so chunk-by-chunk output equals one conv over the whole read
    under "stream" (left-heavy) padding."""
    ksize = w.shape[0]
    if x.shape[1] % stride:
        raise ValueError(f"chunk length {x.shape[1]} not a multiple of "
                         f"stride {stride}")
    c = _conv1d.stream_carry_len(ksize, stride)
    if carry is None:
        carry = torch.zeros((x.shape[0], c, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    elif carry.shape[1] != c:
        raise ValueError(f"carry has {carry.shape[1]} rows, expected "
                         f"K - stride = {c}")
    buf = torch.cat([carry.to(x.dtype), x], dim=1)
    y = conv1d(buf, w, bias, stride=stride, padding="valid",
               activation=activation)
    return y, buf[:, buf.shape[1] - c:, :]


def banded_align(query, target, *, band: int, match: int = 2,
                 mismatch: int = -4, gap: int = -2, local: bool = False):
    """Banded NW/SW alignment scores; (P, m) x (P, n) -> (P,) int32."""
    fabric.dispatch("banded_align", query)
    return _ed.banded_align(query.to(torch.int32).contiguous(),
                            target.to(torch.int32).contiguous(), band=band,
                            match=match, mismatch=mismatch, gap=gap,
                            local=local)


def edit_distance(query, target):
    """Batched Levenshtein distance; (P, m) x (P, n) -> (P,) int32."""
    fabric.dispatch("edit_distance", query)
    return _ed.levenshtein(query.to(torch.int32).contiguous(),
                           target.to(torch.int32).contiguous())


def flash_attention(q, k, v, *, causal: bool = True, scale=None):
    """(B, Hq, Sq, D) x (B, Hkv, Skv, D) -> (B, Hq, Sq, D) softmax
    attention, GQA and last-token-aligned causal mask."""
    fabric.dispatch("flash_attention", q)
    return _fa.flash_attention(q, k, v, causal=causal, scale=scale)


def ssd_scan(x, log_a, b, c, *, chunk=None):
    """Mamba-2 SSD over (BH, T, dh); returns y only (the prefill path).
    ``chunk`` defaults to 256, as JAX's tuning."""
    fabric.dispatch("ssd_scan", x)
    return _ssd.ssd_scan(x, log_a, b, c, chunk=256 if chunk is None
                         else chunk)
