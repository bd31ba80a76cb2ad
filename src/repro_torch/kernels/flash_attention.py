"""Blocked online-softmax attention: the CUDA kernels
(``csrc/flash_attention.cu``) and their wrapper.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (the Pallas
body ``_flash_kernel``), which takes any dtype and head dim with f32 sums.
Two kernels, chosen by dtype and head dim (:func:`route`): bf16 q/k/v with
D in ``HEAD_DIMS`` run the TMA + wgmma kernel, every other case (f32, f16,
bf16 at another D) the generic one, f32 on the CUDA cores (counted also in
``generic_launches``).  Both take any length, including a ragged last
query or key tile (the Pallas kernel asserts ``Sq % block_q == 0`` and the
JAX fabric sends other lengths to the plain version; here there is no such
fallback).  The source notes in ``csrc/flash_attention.cu`` say what
bounds each on an H100 and how its design answers that.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float,
         ctypes.c_int, ctypes.c_void_p])
_GENERIC_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
GENERIC_ROWS = 8        # query rows a generic block, a warp each (at most)
_FG_KEYS, _FG_COLS = 32, 64     # csrc FG_KEYS, FG_COLS


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call of this dtype and head dim launches:
    ``"wgmma"`` for bf16 with D in ``HEAD_DIMS``, else ``"generic"``."""
    return "wgmma" if dtype == torch.bfloat16 and d in HEAD_DIMS else "generic"


def generic_smem_bytes(rows: int, d: int) -> int:
    """Shared memory of a generic block of ``rows`` query rows at head dim
    ``d`` (csrc ``fg_smem_bytes``): a K tile (32 keys x 65 floats) and a V
    tile (32 x 64) staged 64 columns at a time, and each row's q, output
    accumulator and 32 probabilities."""
    return 4 * (_FG_KEYS * (_FG_COLS + 1) + _FG_KEYS * _FG_COLS
                + rows * (2 * d + _FG_KEYS))


def generic_rows(d: int) -> int:
    """Query rows a generic block takes at head dim ``d``: up to
    ``GENERIC_ROWS``, fewer where their rows would not fit shared memory;
    0 where not even one fits (D past ~29,000)."""
    rows = GENERIC_ROWS
    while rows and generic_smem_bytes(rows, d) > _build.SMEM_LIMIT:
        rows -= 1
    return rows


def _check(q, k, v, causal):
    """Shapes, dtypes (float32, bf16 or f16, all alike), contiguity and
    the causal rows; returns (b, hq, hkv, sq, skv, d)."""
    _build.refuse_grad("flash_attention", q, k, v)
    b, hq, sq, d = q.shape
    b2, hkv, skv, d2 = k.shape
    if b2 != b or d2 != d or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k {tuple(k.shape)}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: float32, bfloat16 or float16, "
                        f"got {q.dtype}")
    _build.check_tensor("flash_attention q", q, q.dtype)
    _build.check_tensor("flash_attention k", k, q.dtype, device=q.device)
    _build.check_tensor("flash_attention v", v, q.dtype, tuple(k.shape),
                        q.device)
    if min(sq, skv, d) < 1:
        raise ValueError("flash_attention: empty sequence or head dim")
    if causal and sq > skv:
        raise ValueError(f"flash_attention: causal with Sq {sq} > Skv {skv} "
                         "leaves rows with no key")
    return b, hq, hkv, sq, skv, d


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale=None) -> torch.Tensor:
    """Softmax attention, q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) ->
    (B, Hq, Sq, D) in q's type.

    A CPU tensor runs the plain version (:func:`ref.attention`); a CUDA
    tensor (float32, bf16 or f16, all three alike, contiguous) launches the
    kernel :func:`route` picks or raises."""
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, scale=scale)
    b, hq, hkv, sq, skv, d = _check(q, k, v, causal)
    if route(q.dtype, d) == "generic":
        return generic(q, k, v, causal=causal, scale=scale)
    scale = float(d) ** -0.5 if scale is None else float(scale)
    if b * hq > 2 ** 31 - 1:
        raise ValueError(f"flash_attention: {b} x {hq} heads exceed the "
                         "grid's x limit (2^31 - 1)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention {name}: must be 16-byte "
                             "aligned")
    if not scale > 0:
        raise ValueError(f"flash_attention: scale {scale} must be > 0 (the "
                         "kernel takes each row's max on the raw logits)")
    out = torch.empty_like(q)
    _build.launch(
        "flash_attention", "launch_flash_attention", _ARGS, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, sq, skv, d,
        scale, int(causal), _build.stream_handle(q.device))
    flash_attention.launches += 1
    return out


def generic(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, scale=None) -> torch.Tensor:
    """The generic kernel on CUDA tensors, whatever :func:`route` says:
    what :func:`flash_attention` launches off the wgmma route, and how a
    check holds the two kernels against each other on the same bf16
    inputs.  Counted in ``flash_attention.launches`` and
    ``generic_launches``."""
    b, hq, hkv, sq, skv, d = _check(q, k, v, causal)
    scale = float(d) ** -0.5 if scale is None else float(scale)
    rows = generic_rows(d)
    if not rows:
        raise ValueError(f"flash_attention: head dim {d} leaves no room for "
                         "one query row in shared memory")
    out = torch.empty_like(q)
    _build.launch(
        "flash_attention", "launch_flash_attention_generic", _GENERIC_ARGS,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
        sq, skv, d, scale, int(causal), DTYPES[q.dtype], rows,
        _build.stream_handle(q.device))
    flash_attention.launches += 1
    flash_attention.generic_launches += 1
    return out


flash_attention.launches = 0
flash_attention.generic_launches = 0
