"""'valid' strided conv1d: the CUDA kernels (``csrc/conv1d.cu``) and their
wrappers, fp32 (:func:`conv1d`) and int8 -> int32 (:func:`conv1d_int8`).

Replaces ``repro/kernels/conv1d.py::conv1d`` (the Pallas body
``_conv1d_kernel``, with float or int8 operands).  The source note in ``csrc/conv1d.cu`` says what bounds
the kernel on an H100 and how its tiling answers that.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.quant.core import pack_words

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_SMEM_ARGS = [ctypes.c_int] * 4 + [ctypes.c_void_p]
_INT8_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_INT8_SMEM_ARGS = [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int]


def stream_carry_len(ksize: int, stride: int) -> int:
    """Input rows carried across chunk boundaries for streaming conv1d:
    ``K - stride``, so a 'valid' conv over ``[carry, chunk]`` emits exactly
    ``T / stride`` frames per chunk (``repro/kernels/conv1d.py``)."""
    if ksize < stride:
        raise ValueError(
            f"streaming conv requires K >= stride ({ksize} < {stride})")
    return ksize - stride


def conv1d(x: torch.Tensor, w: torch.Tensor, bias=None, *, stride: int = 1,
           activation: str = "none") -> torch.Tensor:
    """'valid' conv1d.  x (B, T, Cin), w (K, Cin, Cout) -> (B, T_out, Cout).

    A CPU tensor runs the plain version (:func:`ref.conv1d`); a CUDA tensor
    launches the kernel or raises."""
    if x.device.type == "cpu":
        return ref.conv1d(x, w, bias, stride=stride, activation=activation)
    bsz, t, cin = x.shape
    ksize, _, cout = w.shape
    t_out = (t - ksize) // stride + 1
    _build.check_tensor("conv1d x", x, torch.float32)
    _build.check_tensor("conv1d w", w, torch.float32, (ksize, cin, cout),
                        x.device)
    if bias is not None:
        _build.check_tensor("conv1d bias", bias, torch.float32, (cout,),
                            x.device)
    if stride < 1 or t_out < 1:
        raise ValueError(f"conv1d: no output for T={t}, K={ksize}, "
                         f"stride={stride}")
    if bsz > 65_535:
        raise ValueError(f"conv1d: batch {bsz} exceeds the grid's z limit")
    smem = _build.function("conv1d", "conv1d_smem_bytes", _SMEM_ARGS)(
        cin, ksize, stride, cout, w.data_ptr())
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"conv1d: Cin={cin}, K={ksize}, stride={stride} "
                         f"needs {smem} B of shared memory per block")
    out = torch.empty((bsz, t_out, cout), dtype=torch.float32,
                      device=x.device)
    _build.launch(
        "conv1d", "launch_conv1d", _ARGS, x.data_ptr(), w.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), bsz, t,
        cin, ksize, cout, stride, t_out, ref.ACTIVATION_CODES[activation],
        _build.stream_handle(x.device))
    conv1d.launches += 1
    return out


conv1d.launches = 0


def conv1d_int8(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                w_packed=None) -> torch.Tensor:
    """'valid' int8 conv1d.  x (B, T, Cin) int8, w (K, Cin, Cout) int8 ->
    (B, T_out, Cout) int32.  ``w_packed`` is ``pack_words(w)`` where the
    caller keeps it (a ``QuantizedTensor`` caches it); Cin % 4 == 0 packs
    ``w`` here otherwise.

    A CPU tensor runs the plain version (:func:`ref.conv1d_int8`); a CUDA
    tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return ref.conv1d_int8(x, w, stride=stride)
    bsz, t, cin = x.shape
    ksize, _, cout = w.shape
    t_out = (t - ksize) // stride + 1
    _build.check_tensor("conv1d_int8 x", x, torch.int8)
    _build.check_tensor("conv1d_int8 w", w, torch.int8, (ksize, cin, cout),
                        x.device)
    if stride < 1 or t_out < 1:
        raise ValueError(f"conv1d_int8: no output for T={t}, K={ksize}, "
                         f"stride={stride}")
    if bsz > 65_535:
        raise ValueError(f"conv1d_int8: batch {bsz} exceeds the grid's z "
                         "limit")
    packed = cin % 4 == 0
    wk = w
    if packed:
        wk = pack_words(w) if w_packed is None else w_packed
        _build.check_tensor("conv1d_int8 packed w", wk, torch.int32,
                            (ksize, cin // 4, cout), x.device)
        if x.data_ptr() % 4:
            raise ValueError("conv1d_int8: x must be 4-byte aligned")
    smem = _build.function("conv1d", "conv1d_int8_smem_bytes",
                           _INT8_SMEM_ARGS)(cin, ksize, stride, cout,
                                            wk.data_ptr(), int(packed))
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"conv1d_int8: Cin={cin}, K={ksize}, stride={stride}"
                         f" needs {smem} B of shared memory per block")
    out = torch.empty((bsz, t_out, cout), dtype=torch.int32, device=x.device)
    _build.launch(
        "conv1d", "launch_conv1d_int8", _INT8_ARGS, x.data_ptr(),
        wk.data_ptr(), out.data_ptr(), bsz, t, cin, ksize, cout, stride,
        t_out, int(packed), _build.stream_handle(x.device))
    conv1d_int8.launches += 1
    return out


conv1d_int8.launches = 0
