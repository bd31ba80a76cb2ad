"""Tiled GEMM: the CUDA kernels (``csrc/matmul.cu``) and their wrappers,
fp32 with a bias + activation epilogue (:func:`matmul`), bf16 with f32
accumulation and the same epilogue (:func:`matmul_bf16`), and int8 -> int32
(:func:`matmul_int8`).

Replaces ``repro/kernels/matmul.py::matmul`` (the Pallas bodies
``_matmul_kernel`` / ``_matmul_nobias_kernel``, with float or int8
operands, bf16 included).  The source note in
``csrc/matmul.cu`` says what bounds the kernel on an H100 and how its
tiling answers that; each GEMM has several kernels, chosen by shape alone
(:func:`skinny` for fp32, :func:`route_int8` and :func:`route_bf16`): a
route that fails raises and never retries on another.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import fabric
from repro_torch.kernels import ref

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_INT8_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BF16_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_WGMMA_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_I8_NARROW_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
_BF16_NARROW_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                     + [ctypes.c_void_p])


SKINNY_N = 8    # widest N the streaming kernel takes (one accumulator each)
NARROW_M = 16   # most rows the narrow-M (decode) kernels take: two n8 tiles

# The narrow-M kernels (csrc/matmul.cu): a block owns NARROW_BN weight
# columns (NR_BN) and one K split; at most NARROW_BLOCKS blocks (4 on each
# of the H100's 132 SMs), each of at least NARROW_MIN_STEPS steps.
NARROW_BN = 128
NARROW_BLOCKS = 528
NARROW_MIN_STEPS = 8
NARROW_SPLITS = 16      # most K splits: one cluster a column tile
NARROW_STEP = {"int8": 32, "bf16": 16}     # K a step: one mma's depth


MAX_BLOCKS = 2 ** 31 - 1    # a grid's x dimension


def skinny(n: int) -> bool:
    """Whether matmul (fp32 or int8) with ``n`` output columns runs the
    skinny-N kernel, which streams A's rows (the basecaller head's N = 5);
    wider N runs the tiled kernel."""
    return n <= SKINNY_N


def int8_tc_shape(k: int, n: int, a_ptr: int, b_ptr: int) -> bool:
    """Whether an int8 GEMM can run on the tensor-core routes: K and N
    positive multiples of 16 (16-byte rows) and both bases 16-byte
    aligned."""
    return (k > 0 and k % 16 == 0 and n > 0 and n % 16 == 0
            and a_ptr % 16 == 0 and b_ptr % 16 == 0)


def route_int8(m: int, n: int, k: int, a_ptr: int, b_ptr: int) -> str:
    """The kernel ``matmul_int8`` launches for a (M, K) x (K, N) product:
    ``"skinny"`` for N <= 8, ``"narrow"`` (M <= 16) or ``"tc"`` where
    :func:`int8_tc_shape` holds, else ``"dp4a"``."""
    if skinny(n):
        return "skinny"
    if not int8_tc_shape(k, n, a_ptr, b_ptr):
        return "dp4a"
    return "narrow" if m <= NARROW_M else "tc"


def tma_addressable(k: int, n: int, a_ptr: int, b_ptr: int) -> bool:
    """Whether TMA can address the rows of bf16 a (M, K) and b (K, N):
    K and N positive multiples of 8 (16-byte row strides) and 16-byte
    aligned bases."""
    return (k > 0 and k % 8 == 0 and n % 8 == 0 and a_ptr % 16 == 0
            and b_ptr % 16 == 0)


def route_bf16(m: int, n: int, k: int, a_ptr: int, b_ptr: int) -> str:
    """The kernel ``matmul_bf16`` launches: where :func:`tma_addressable`
    holds, ``"narrow"`` for M <= 16 and ``"wgmma"`` above; else
    ``"mma.sync"``."""
    if not tma_addressable(k, n, a_ptr, b_ptr):
        return "mma.sync"
    return "narrow" if m <= NARROW_M else "wgmma"


@functools.lru_cache(maxsize=256)
def narrow_split(n: int, k: int, step: int) -> int:
    """How many blocks split K for a narrow-M GEMM of N columns: as many
    as fit ``NARROW_BLOCKS`` blocks with the column tiles, at least
    ``NARROW_MIN_STEPS`` ``step``-deep steps a block, at most
    ``NARROW_SPLITS``.  A function of N and K only (never of M), so a
    row's float sums do not depend on the rows beside it."""
    steps = -(-k // step)
    tiles = -(-n // NARROW_BN)
    return max(1, min(NARROW_BLOCKS // tiles, steps // NARROW_MIN_STEPS,
                      NARROW_SPLITS))


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
    if a.device.type == "meta":
        return _build.on_meta("matmul", lambda a, b, bias: ref.matmul(
            a, b, bias, activation=activation), a, b, bias)
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
    tensor launches the kernel :func:`route_int8` names or raises: skinny
    N (counted also in ``skinny_launches``), the narrow-M and tiled
    tensor-core kernels (``narrow_launches``, ``tc_launches``), or the
    dp4a tile.  Integer sums: every route gives the plain version's
    bits."""
    if a.device.type == "cpu":
        return ref.matmul_int8(a, b)
    _build.refuse_grad("matmul_int8", a, b)
    if a.device.type == "meta":
        return fabric.meta_kernel("matmul_int8", ref.matmul_int8, a, b)
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"matmul_int8: inner dims differ, {a.shape} x "
                         f"{b.shape}")
    dev = a.device
    _build.check_tensor("matmul_int8 a", a, torch.int8)
    _build.check_tensor("matmul_int8 b", b, torch.int8, device=dev)
    if m < 1 or n < 1:
        raise ValueError(f"matmul_int8: empty output {m} x {n}")
    route = route_int8(m, n, k, a.data_ptr(), b.data_ptr())
    if route == "tc":
        _check_blocks("matmul_int8", m, n, 128, 128)
    elif route == "dp4a":
        _check_blocks("matmul_int8", m, n, 64, 64)
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    stream = _build.stream_handle(dev)
    if route == "narrow":
        _build.launch("matmul", "launch_matmul_int8_narrow", _I8_NARROW_ARGS,
                      a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                      narrow_split(n, k, NARROW_STEP["int8"]), stream)
    else:
        fn = {"skinny": "launch_matmul_int8_skinny",
              "tc": "launch_matmul_int8_tc",
              "dp4a": "launch_matmul_int8"}[route]
        _build.launch("matmul", fn, _INT8_ARGS, a.data_ptr(), b.data_ptr(),
                      out.data_ptr(), m, n, k, stream)
    matmul_int8.launches += 1
    matmul_int8.skinny_launches += route == "skinny"
    matmul_int8.narrow_launches += route == "narrow"
    matmul_int8.tc_launches += route == "tc"
    return out


matmul_int8.launches = 0
matmul_int8.skinny_launches = 0
matmul_int8.narrow_launches = 0
matmul_int8.tc_launches = 0


def matmul_bf16(a: torch.Tensor, b: torch.Tensor, bias=None, *,
                activation: str = "none") -> torch.Tensor:
    """``activation(a @ b + bias)`` for bf16 a (M, K), b (K, N), bias (N,):
    float32 sums, bias and activation on them, one rounding to bf16.

    A CPU tensor runs the plain version (:func:`ref.matmul`); a CUDA tensor
    launches the kernel :func:`route_bf16` names or raises: the narrow-M
    kernel (M <= 16, counted also in ``narrow_launches``) or the TMA +
    wgmma kernel (``wgmma_launches``) where :func:`tma_addressable` holds,
    else the mma.sync kernel.  The choice is by shape; a failure of one
    raises and never retries on another.  Where autograd is on and an
    operand requires grad, the launch runs inside
    :class:`_build.PlainGrad`: the backward is the plain version's
    gradient (float32 products, TF32 off), returned in bf16."""
    if a.device.type == "cpu":
        return ref.matmul(a, b, bias, activation=activation)
    if a.device.type == "meta":
        return _build.on_meta("matmul_bf16", lambda a, b, bias: ref.matmul(
            a, b, bias, activation=activation), a, b, bias)
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
    dev = a.device
    _build.check_tensor("matmul_bf16 a", a, torch.bfloat16)
    _build.check_tensor("matmul_bf16 b", b, torch.bfloat16, device=dev)
    if bias is not None:
        _build.check_tensor("matmul_bf16 bias", bias, torch.bfloat16, (n,),
                            dev)
    if m < 1 or n < 1:
        raise ValueError(f"matmul_bf16: empty output {m} x {n}")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    code = ref.ACTIVATION_CODES[activation]
    bias_ptr = None if bias is None else bias.data_ptr()
    stream = _build.stream_handle(dev)
    route = route_bf16(m, n, k, a.data_ptr(), b.data_ptr())
    if route == "narrow":
        _build.launch(
            "matmul", "launch_matmul_bf16_narrow", _BF16_NARROW_ARGS,
            a.data_ptr(), b.data_ptr(), bias_ptr, out.data_ptr(), m, n, k,
            code, narrow_split(n, k, NARROW_STEP["bf16"]), stream)
        matmul_bf16.narrow_launches += 1
    elif route == "wgmma":
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
matmul_bf16.narrow_launches = 0
