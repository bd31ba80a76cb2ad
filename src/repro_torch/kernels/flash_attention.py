"""Blocked online-softmax attention: the CUDA kernel
(``csrc/flash_attention.cu``) and its wrapper.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (the Pallas
body ``_flash_kernel``).  The kernel takes bf16 q/k/v of any length,
including a ragged last query or key tile (the Pallas kernel asserts
``Sq % block_q == 0`` and the JAX fabric sends other lengths to the plain
version; here there is no such fallback).  The source note in
``csrc/flash_attention.cu`` says what bounds it on an H100 and how its
design (TMA rings feeding wgmma, ``csrc/hopper.cuh``) answers that.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float,
         ctypes.c_int, ctypes.c_void_p])
HEAD_DIMS = (16, 32, 64, 128)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale=None) -> torch.Tensor:
    """Softmax attention, q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) ->
    (B, Hq, Sq, D).

    A CPU tensor runs the plain version (:func:`ref.attention`); a CUDA
    tensor launches the kernel (bf16, contiguous, D in ``HEAD_DIMS``) or
    raises."""
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, scale=scale)
    b, hq, sq, d = q.shape
    b2, hkv, skv, d2 = k.shape
    if b2 != b or d2 != d or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k {tuple(k.shape)}")
    _build.check_tensor("flash_attention q", q, torch.bfloat16)
    _build.check_tensor("flash_attention k", k, torch.bfloat16, device=q.device)
    _build.check_tensor("flash_attention v", v, torch.bfloat16,
                        tuple(k.shape), q.device)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if min(sq, skv) < 1:
        raise ValueError("flash_attention: empty sequence")
    if causal and sq > skv:
        raise ValueError(f"flash_attention: causal with Sq {sq} > Skv {skv} "
                         "leaves rows with no key")
    if b * hq > 2 ** 31 - 1:
        raise ValueError(f"flash_attention: {b} x {hq} heads exceed the "
                         "grid's x limit (2^31 - 1)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention {name}: must be 16-byte "
                             "aligned")
    scale = float(d) ** -0.5 if scale is None else float(scale)
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


flash_attention.launches = 0
