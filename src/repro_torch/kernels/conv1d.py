"""'valid' strided conv1d: the CUDA kernels (``csrc/conv1d.cu``) and their
wrappers, fp32 (:func:`conv1d`) and int8 -> int32 (:func:`conv1d_int8`).

Replaces ``repro/kernels/conv1d.py::conv1d`` (the Pallas body
``_conv1d_kernel``, with float or int8 operands).  Each type has two
kernels, chosen by shape: fp32 a 3xTF32 implicit GEMM on the tensor cores
and an fp32 one on the CUDA cores (:func:`tensor_core_shape`), int8 an
``mma.sync`` s8 implicit GEMM on the tensor cores and a ``__dp4a`` one on
the CUDA cores (:func:`int8_tensor_core_shape`).  The source notes in
``csrc/conv1d.cu`` say what bounds each on an H100 and how its tiling
answers that.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import fabric
from repro_torch.kernels import ref
from repro_torch.quant.core import pack_fragments, pack_words

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_INT8_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_INT8_TC_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

# the tensor-core kernel's geometry (csrc/conv1d.cu TC_*): output frames a
# sub-tile, sub-tiles a block, input channels a slice, ring stages, x row
# pitch in floats
TC_FRAMES, TC_SUBS, TC_CS, TC_STAGES, TC_XP = 64, 2, 8, 2, 12
# the int8 tensor-core kernel's (csrc/conv1d.cu I8_*): input channels a
# slice (one k-step a tap), x row pitch in 4-byte words; its sub-tiles,
# ring and channel tiles are the fp32 kernel's
I8_CS, I8_XP = 32, 12


def _bn(cout: int) -> int:
    """Output channels a tensor-core block takes (``tc_bn``)."""
    return 64 if cout % 64 == 0 else 96 if cout % 96 == 0 else 32


def tc_smem_bytes(ksize: int, stride: int, cout: int) -> int:
    """Shared memory of the tensor-core kernel (``conv1d_tc_smem_bytes``):
    each ring stage holds the sub-tiles' staged x rows, by phase, and the
    K x 8 x BN weights as hi and lo planes (row pitch BN + 8), BN = 64,
    96 or 32 output channels by Cout."""
    bn = _bn(cout)
    prow = TC_FRAMES - 1 + -(-ksize // stride)
    x_floats = TC_SUBS * stride * prow * TC_XP
    w_floats = 2 * ksize * TC_CS * (bn + 8)
    return TC_STAGES * (x_floats + w_floats) * 4


def tensor_core_shape(cin: int, cout: int, ksize: int, stride: int) -> bool:
    """Whether fp32 conv1d of this shape runs the 3xTF32 tensor-core
    kernel: whole k-steps of 8 input channels, output channels in pairs of
    the MMA's 8 columns, and a ring that fits a block's shared memory.  The
    rest (Cin 1, Cout 5, ragged channel counts) runs the CUDA-core kernel.
    The wrapper also needs x and w 16-byte aligned (cp.async)."""
    return (cin % TC_CS == 0 and cout % 8 == 0
            and tc_smem_bytes(ksize, stride, cout) <= _build.SMEM_LIMIT)


def int8_tc_smem_bytes(ksize: int, stride: int, cout: int) -> int:
    """Shared memory of the int8 tensor-core kernel
    (``conv1d_int8_tc_smem_bytes``): each ring stage holds the sub-tiles'
    staged x rows, by phase, 32 channels in a 12-word row, and the slice's
    B fragments, K taps x BN / 8 n-tiles x 256 bytes."""
    prow = TC_FRAMES - 1 + -(-ksize // stride)
    x_bytes = TC_SUBS * stride * prow * I8_XP * 4
    return TC_STAGES * (x_bytes + ksize * _bn(cout) * I8_CS)


def int8_tensor_core_shape(cin: int, cout: int, ksize: int,
                           stride: int) -> bool:
    """Whether int8 conv1d of this shape runs the ``mma.sync`` s8 kernel:
    whole k-steps of 32 input channels, output channels in the MMA's 8
    columns, and a ring that fits a block's shared memory (the paper CNN's
    conv2-conv5).  The rest (conv1's Cin 1, the step codec, Cin 6 or 8)
    runs the ``__dp4a`` kernel.  The wrapper also needs x 16-byte
    aligned (cp.async)."""
    return (cin % I8_CS == 0 and cout % 8 == 0
            and int8_tc_smem_bytes(ksize, stride, cout) <= _build.SMEM_LIMIT)


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
    launches a kernel or raises: the tensor-core kernel where
    :func:`tensor_core_shape` holds and x and w are 16-byte aligned
    (counted also in ``tc_launches``), else the CUDA-core one.  The choice
    is by shape; a failure of either raises and never retries on the
    other.  Where autograd is on and an operand requires grad, the launch
    runs inside :class:`_build.PlainGrad`, whose backward is the plain
    version's gradient."""
    if x.device.type == "cpu":
        return ref.conv1d(x, w, bias, stride=stride, activation=activation)
    if x.device.type == "meta":
        return _build.on_meta("conv1d", lambda x, w, b: ref.conv1d(
            x, w, b, stride=stride, activation=activation), x, w, bias)
    return _build.with_plain_grad(
        lambda x, w, b: _conv1d_cuda(x, w, b, stride, activation),
        lambda x, w, b: ref.conv1d(x, w, b, stride=stride,
                                   activation=activation),
        x, w, bias)


def _conv1d_cuda(x, w, bias, stride, activation):
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
    out = torch.empty((bsz, t_out, cout), dtype=torch.float32,
                      device=x.device)
    tc = (tensor_core_shape(cin, cout, ksize, stride)
          and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    _build.launch(
        "conv1d", "launch_conv1d_tc" if tc else "launch_conv1d", _ARGS,
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), bsz, t, cin, ksize, cout, stride, t_out,
        ref.ACTIVATION_CODES[activation], _build.stream_handle(x.device))
    conv1d.launches += 1
    conv1d.tc_launches += tc
    return out


conv1d.launches = 0
conv1d.tc_launches = 0


def conv1d_int8(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                w_packed=None, w_fragments=None) -> torch.Tensor:
    """'valid' int8 conv1d.  x (B, T, Cin) int8, w (K, Cin, Cout) int8 ->
    (B, T_out, Cout) int32.  ``w_fragments`` is ``pack_fragments(w)`` and
    ``w_packed`` ``pack_words(w)`` where the caller keeps them (a
    ``QuantizedTensor`` caches both); the kernel that runs packs ``w``
    here otherwise.

    A CPU tensor runs the plain version (:func:`ref.conv1d_int8`); a CUDA
    tensor launches a kernel or raises: the tensor-core kernel where
    :func:`int8_tensor_core_shape` holds and x is 16-byte aligned (counted
    also in ``tc_launches``), else the ``__dp4a`` one."""
    if x.device.type == "cpu":
        return ref.conv1d_int8(x, w, stride=stride)
    _build.refuse_grad("conv1d_int8", x, w)
    if x.device.type == "meta":
        return fabric.meta_kernel("conv1d_int8", lambda x, w: ref.conv1d_int8(
            x, w, stride=stride), x, w)
    bsz, t, cin = x.shape
    ksize, _, cout = w.shape
    t_out = (t - ksize) // stride + 1
    _build.check_tensor("conv1d_int8 x", x, torch.int8)
    _build.check_tensor("conv1d_int8 w", w, torch.int8, (ksize, cin, cout),
                        x.device)
    if stride < 1 or t_out < 1:
        raise ValueError(f"conv1d_int8: no output for T={t}, K={ksize}, "
                         f"stride={stride}")
    out = torch.empty((bsz, t_out, cout), dtype=torch.int32, device=x.device)
    stream = _build.stream_handle(x.device)
    if (int8_tensor_core_shape(cin, cout, ksize, stride)
            and x.data_ptr() % 16 == 0):
        wf = pack_fragments(w) if w_fragments is None else w_fragments
        _build.check_tensor("conv1d_int8 fragments", wf, torch.int32,
                            (ksize, cin // I8_CS, cout // 8, 32, 2), x.device)
        _build.launch(
            "conv1d", "launch_conv1d_int8_tc", _INT8_TC_ARGS, x.data_ptr(),
            wf.data_ptr(), out.data_ptr(), bsz, t, cin, ksize, cout, stride,
            t_out, stream)
        conv1d_int8.launches += 1
        conv1d_int8.tc_launches += 1
        return out
    packed = cin % 4 == 0
    wk = w
    if packed:
        wk = pack_words(w) if w_packed is None else w_packed
        _build.check_tensor("conv1d_int8 packed w", wk, torch.int32,
                            (ksize, cin // 4, cout), x.device)
        if x.data_ptr() % 4:
            raise ValueError("conv1d_int8: x must be 4-byte aligned")
    _build.launch(
        "conv1d", "launch_conv1d_int8", _INT8_ARGS, x.data_ptr(),
        wk.data_ptr(), out.data_ptr(), bsz, t, cin, ksize, cout, stride,
        t_out, int(packed), stream)
    conv1d_int8.launches += 1
    return out


conv1d_int8.launches = 0
conv1d_int8.tc_launches = 0
