"""Blocked online-softmax attention: the CUDA kernels
(``csrc/flash_attention.cu``) and their wrapper.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (the Pallas
body ``_flash_kernel``), which takes any dtype and head dim with f32 sums.
Three routes, chosen by dtype and head dim (:func:`route`):

* ``"wgmma"``: bf16 q/k/v with D in ``HEAD_DIMS``, the TMA + wgmma kernel
  (the bf16 LM prefill; its non-causal launches, the encoder-decoder's
  encoder and cross-attention, counted also in ``noncausal_launches``);
* ``"tf32x3"``: f32, f16, and bf16 at any other D up to 256 (the f32 LMs),
  both products on the tensor cores in 3xTF32 (f32 operands split hi + lo,
  P always split, 16-bit operands exact), the head dim zero-padded to
  ``TF32X3_DIMS``: a wgmma .tf32 kernel for f32 at 64 < D <= 128
  (:func:`tf32x3_wgmma`, counted also in ``tf32x3_wgmma_launches``), an
  mma.sync one for the rest (counted also in ``tf32x3_launches``);
* ``"generic"``: D past 256, the f32 CUDA-core kernel, kept only as the
  route past the tensor-core kernels' reach, up to the ~29,000 one query
  row's f32 state leaves room for (counted also in ``generic_launches``).

All take any length, including a ragged last query or key tile (the
Pallas kernel asserts ``Sq % block_q == 0`` and the JAX fabric sends other
lengths to the plain version; here there is no such fallback).  The
source notes in ``csrc/flash_attention.cu`` say what bounds each on an
H100 and how its design answers that.
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
_TF32X3_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
                + [ctypes.c_int] * 2 + [ctypes.c_void_p])
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
GENERIC_ROWS = 8        # query rows a generic block, a warp each (at most)
_FG_KEYS, _FG_COLS = 32, 64     # csrc FG_KEYS, FG_COLS
# head dims the 3xTF32 kernel is built for (csrc TfShape): D pads to the
# first that holds it
TF32X3_DIMS = (16, 32, 64, 128, 256)


def tf32x3_dim(d: int) -> int:
    """The padded head dim the 3xTF32 kernel runs D at, 0 past 256."""
    return next((p for p in TF32X3_DIMS if d <= p), 0)


def tf32x3_wgmma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether a 3xTF32 call runs the wgmma kernel (csrc
    ``flash_attention_tf32x3_wgmma_kernel``): f32 q/k/v at 64 < D <= 128
    with D % 4 == 0 and every operand 16-byte aligned; the mma.sync kernel
    takes every other 3xTF32 case."""
    d = q.shape[-1]
    return (q.dtype == torch.float32 and 64 < d <= 128 and d % 4 == 0
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call of this dtype and head dim launches:
    ``"wgmma"`` for bf16 with D in ``HEAD_DIMS``, ``"tf32x3"`` for any
    other case up to D 256, ``"generic"`` past it."""
    if dtype == torch.bfloat16 and d in HEAD_DIMS:
        return "wgmma"
    return "tf32x3" if tf32x3_dim(d) else "generic"


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


def _plain(q, k, v, causal, scale, path):
    """The plain version of ``path``'s kernel (:func:`ref.flash`): P
    rounded to bf16 before the PV product on the bf16 ``wgmma`` route,
    which rounds it so, and kept float32 on the others."""
    return ref.flash(q, k, v, causal=causal, scale=scale,
                     p_dtype=torch.bfloat16 if path == "wgmma"
                     else torch.float32)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale=None) -> torch.Tensor:
    """Softmax attention, q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) ->
    (B, Hq, Sq, D) in q's type.

    A CPU tensor runs the plain version of the kernel :func:`route` picks
    (:func:`_plain`); a CUDA tensor (float32, bf16 or f16, all three
    alike, contiguous) launches that kernel or raises.  Where autograd is
    on and an operand requires grad, the launch runs inside
    :class:`_build.PlainGrad`: the backward is the same plain version's
    gradient (float32 logits, GQA's K/V gradients summed over each KV
    head's query group)."""
    path = route(q.dtype, q.shape[-1])
    if q.device.type == "cpu":
        return _plain(q, k, v, causal, scale, path)
    if q.device.type == "meta":
        return _build.on_meta("flash_attention", lambda q, k, v: _plain(
            q, k, v, causal, scale, path), q, k, v)
    return _on_card(path, q, k, v, causal, scale)


def _on_card(path, q, k, v, causal, scale):
    """``path``'s launch, inside :class:`_build.PlainGrad` with its plain
    version's gradient where autograd wants one."""
    return _build.with_plain_grad(
        lambda q, k, v: _launch(path, q, k, v, causal, scale),
        lambda q, k, v: _plain(q, k, v, causal, scale, path), q, k, v)


def _launch(path, q, k, v, causal, scale):
    if path == "wgmma":
        return _wgmma(q, k, v, causal, scale)
    if path == "tf32x3":
        return _tf32x3(q, k, v, causal, scale, tf32x3_wgmma(q, k, v))
    return _generic(q, k, v, causal, scale)


def _wgmma(q, k, v, causal, scale):
    b, hq, hkv, sq, skv, d = _check(q, k, v, causal)
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
    if not causal:
        flash_attention.noncausal_launches += 1
    return out


def tf32x3(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, scale=None) -> torch.Tensor:
    """The 3xTF32 kernels on CUDA tensors (D up to 256), whatever
    :func:`route` says: what :func:`flash_attention` launches on the
    ``"tf32x3"`` route, and how a check holds them against the bf16 wgmma
    kernel on the same bf16 inputs.  f32 at 64 < D <= 128 runs the wgmma
    .tf32 kernel (:func:`tf32x3_wgmma`, counted also in
    ``tf32x3_wgmma_launches``), every other case the mma.sync one (counted
    also in ``tf32x3_launches``).  Both count in
    ``flash_attention.launches``.  A gradient, where one is wanted, is
    the float32-P plain version's."""
    return _on_card("tf32x3", q, k, v, causal, scale)


def _tf32x3(q, k, v, causal, scale, wgmma: bool):
    """The 3xTF32 launch on the kernel ``wgmma`` names (the wgmma one only
    where :func:`tf32x3_wgmma` holds; a check may time the mma.sync one
    there too)."""
    b, hq, hkv, sq, skv, d = _check(q, k, v, causal)
    scale = float(d) ** -0.5 if scale is None else float(scale)
    if not tf32x3_dim(d):
        raise ValueError(f"flash_attention: head dim {d} is past the 3xTF32 "
                         f"kernel's {TF32X3_DIMS[-1]}")
    if b * hq > 2 ** 31 - 1:
        raise ValueError(f"flash_attention: {b} x {hq} heads exceed 2^31 - 1")
    if wgmma and not tf32x3_wgmma(q, k, v):
        raise ValueError("flash_attention: the 3xTF32 wgmma kernel takes f32 "
                         "at 64 < D <= 128, D % 4 == 0, 16-byte aligned")
    out = torch.empty_like(q)
    if wgmma:
        _build.launch(
            "flash_attention", "launch_flash_attention_tf32x3_wgmma",
            _ARGS, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, hq, hkv, sq, skv, d, scale, int(causal),
            _build.stream_handle(q.device))
    else:
        _build.launch(
            "flash_attention", "launch_flash_attention_tf32x3", _TF32X3_ARGS,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            hkv, sq, skv, d, scale, int(causal), DTYPES[q.dtype],
            _build.stream_handle(q.device))
    flash_attention.launches += 1
    flash_attention.tf32x3_launches += int(not wgmma)
    flash_attention.tf32x3_wgmma_launches += int(wgmma)
    return out


def generic(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, scale=None) -> torch.Tensor:
    """The generic CUDA-core kernel on CUDA tensors, whatever :func:`route`
    says: what :func:`flash_attention` launches past D 256, and how a check
    holds it against the tensor-core kernels and times it as row 5g's
    "was" on the same inputs.  Counted in ``flash_attention.launches`` and
    ``generic_launches``.  A gradient, where one is wanted, is the
    float32-P plain version's."""
    return _on_card("generic", q, k, v, causal, scale)


def _generic(q, k, v, causal, scale):
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
flash_attention.tf32x3_launches = 0
flash_attention.tf32x3_wgmma_launches = 0
flash_attention.generic_launches = 0
flash_attention.noncausal_launches = 0
