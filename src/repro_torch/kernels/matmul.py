"""Tiled GEMM: the CUDA kernels (``csrc/matmul.cu``) and their wrappers,
fp32 with a bias + activation epilogue (:func:`matmul`), bf16 with f32
accumulation and the same epilogue (:func:`matmul_bf16`), and int8 -> int32
(:func:`matmul_int8`).

Replaces ``repro/kernels/matmul.py::matmul`` (the Pallas bodies
``_matmul_kernel`` / ``_matmul_nobias_kernel``, with float or int8
operands, bf16 included).  The source note in
``csrc/matmul.cu`` says what bounds the kernel on an H100 and how its
tiling answers that; each of the three GEMMs has two kernels, chosen by
shape (:func:`skinny` for fp32 and int8, :func:`tma_addressable` for
bf16).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_INT8_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BF16_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_WGMMA_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


SKINNY_N = 8    # widest N the streaming kernel takes (one accumulator each)


MAX_BLOCKS = 2 ** 31 - 1    # a grid's x dimension


def skinny(n: int) -> bool:
    """Whether matmul (fp32 or int8) with ``n`` output columns runs the
    skinny-N kernel, which streams A's rows (the basecaller head's N = 5);
    wider N runs the tiled kernel."""
    return n <= SKINNY_N


def _check_blocks(what: str, m: int, n: int, bm: int, bn: int) -> None:
    """A tiled kernel numbers its (M / bm) x (N / bn) tiles along the
    grid's x alone: raise where they do not fit it."""
    if -(-m // bm) * -(-n // bn) > MAX_BLOCKS:
        raise ValueError(f"{what}: {m} x {n} needs more than {MAX_BLOCKS} "
                         "blocks")


def matmul(a: torch.Tensor, b: torch.Tensor, bias=None, *,
           activation: str = "none") -> torch.Tensor:
    """``activation(a @ b + bias)``: a (M, K), b (K, N), bias (N,).

    A CPU tensor runs the plain version (:func:`ref.matmul`); a CUDA tensor
    launches a kernel or raises: the skinny-N kernel where :func:`skinny`
    holds (counted also in ``skinny_launches``), else the tiled one.  Both
    sum each output's K products in ascending order, so they give the same
    bits.  Where autograd is on and an operand requires grad, the launch
    runs inside :class:`_build.PlainGrad`, whose backward is the plain
    version's gradient."""
    if a.device.type == "cpu":
        return ref.matmul(a, b, bias, activation=activation)
    return _build.with_plain_grad(
        lambda a, b, bias: _matmul_cuda(a, b, bias, activation),
        lambda a, b, bias: ref.matmul(a, b, bias, activation=activation),
        a, b, bias)


def _matmul_cuda(a, b, bias, activation):
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"matmul: inner dims differ, {a.shape} x {b.shape}")
    _build.check_tensor("matmul a", a, torch.float32)
    _build.check_tensor("matmul b", b, torch.float32, device=a.device)
    if bias is not None:
        _build.check_tensor("matmul bias", bias, torch.float32, (n,),
                            a.device)
    if m < 1 or n < 1:
        raise ValueError(f"matmul: empty output {m} x {n}")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    thin = skinny(n)
    _build.launch(
        "matmul", "launch_matmul_skinny" if thin else "launch_matmul", _ARGS,
        a.data_ptr(), b.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), m, n, k, ref.ACTIVATION_CODES[activation],
        _build.stream_handle(a.device))
    matmul.launches += 1
    matmul.skinny_launches += thin
    return out


matmul.launches = 0
matmul.skinny_launches = 0


def matmul_int8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with int32 accumulation: a (M, K) int8, b (K, N) int8 ->
    (M, N) int32.

    A CPU tensor runs the plain version (:func:`ref.matmul_int8`); a CUDA
    tensor launches a kernel or raises: the skinny-N kernel where
    :func:`skinny` holds (counted also in ``skinny_launches``), else the
    tiled one.  Integer sums: both give the plain version's bits."""
    if a.device.type == "cpu":
        return ref.matmul_int8(a, b)
    _build.refuse_grad("matmul_int8", a, b)
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"matmul_int8: inner dims differ, {a.shape} x "
                         f"{b.shape}")
    _build.check_tensor("matmul_int8 a", a, torch.int8)
    _build.check_tensor("matmul_int8 b", b, torch.int8, device=a.device)
    if m < 1 or n < 1:
        raise ValueError(f"matmul_int8: empty output {m} x {n}")
    thin = skinny(n)
    if not thin:
        _check_blocks("matmul_int8", m, n, 64, 64)
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    _build.launch(
        "matmul", "launch_matmul_int8_skinny" if thin else
        "launch_matmul_int8", _INT8_ARGS, a.data_ptr(), b.data_ptr(),
        out.data_ptr(), m, n, k, _build.stream_handle(a.device))
    matmul_int8.launches += 1
    matmul_int8.skinny_launches += thin
    return out


matmul_int8.launches = 0
matmul_int8.skinny_launches = 0


def tma_addressable(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether TMA can address the rows of bf16 a (M, K) and b (K, N):
    K and N positive multiples of 8 (16-byte row strides) and 16-byte
    aligned bases.  Such shapes run the wgmma kernel, the rest the
    mma.sync one."""
    k, n = b.shape
    return (k > 0 and k % 8 == 0 and n % 8 == 0 and a.data_ptr() % 16 == 0
            and b.data_ptr() % 16 == 0)


def matmul_bf16(a: torch.Tensor, b: torch.Tensor, bias=None, *,
                activation: str = "none") -> torch.Tensor:
    """``activation(a @ b + bias)`` for bf16 a (M, K), b (K, N), bias (N,):
    float32 sums, bias and activation on them, one rounding to bf16.

    A CPU tensor runs the plain version (:func:`ref.matmul`); a CUDA tensor
    launches a kernel or raises: the TMA + wgmma kernel where
    :func:`tma_addressable` holds (counted also in ``wgmma_launches``),
    else the mma.sync kernel.  The choice is by shape; a failure of either
    raises and never retries on the other.  Where autograd is on and an
    operand requires grad, the launch runs inside
    :class:`_build.PlainGrad`: the backward is the plain version's
    gradient (float32 products, TF32 off), returned in bf16."""
    if a.device.type == "cpu":
        return ref.matmul(a, b, bias, activation=activation)
    return _bf16_on_card(a, b, bias, activation)


def _bf16_on_card(a, b, bias, activation):
    """The launch, inside :class:`_build.PlainGrad` with the plain
    version's gradient where autograd wants one."""
    return _build.with_plain_grad(
        lambda a, b, bias: _matmul_bf16_cuda(a, b, bias, activation),
        lambda a, b, bias: ref.matmul(a, b, bias, activation=activation),
        a, b, bias)


def _matmul_bf16_cuda(a, b, bias, activation):
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"matmul_bf16: inner dims differ, {a.shape} x "
                         f"{b.shape}")
    _build.check_tensor("matmul_bf16 a", a, torch.bfloat16)
    _build.check_tensor("matmul_bf16 b", b, torch.bfloat16, device=a.device)
    if bias is not None:
        _build.check_tensor("matmul_bf16 bias", bias, torch.bfloat16, (n,),
                            a.device)
    if m < 1 or n < 1:
        raise ValueError(f"matmul_bf16: empty output {m} x {n}")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    code = ref.ACTIVATION_CODES[activation]
    bias_ptr = None if bias is None else bias.data_ptr()
    stream = _build.stream_handle(a.device)
    if tma_addressable(a, b):
        _build.launch(
            "matmul", "launch_matmul_bf16_wgmma", _WGMMA_ARGS, a.data_ptr(),
            b.data_ptr(), bias_ptr, out.data_ptr(), m, n, k, code, stream)
        matmul_bf16.wgmma_launches += 1
    else:
        _check_blocks("matmul_bf16", m, n, 128, 128)
        # 16-byte loads where every row of the operand starts 16-byte aligned
        vec_a = int(k % 8 == 0 and a.data_ptr() % 16 == 0)
        vec_b = int(n % 8 == 0 and b.data_ptr() % 16 == 0)
        _build.launch(
            "matmul", "launch_matmul_bf16", _BF16_ARGS, a.data_ptr(),
            b.data_ptr(), bias_ptr, out.data_ptr(), m, n, k, code, vec_a,
            vec_b, stream)
    matmul_bf16.launches += 1
    return out


matmul_bf16.launches = 0
matmul_bf16.wgmma_launches = 0
