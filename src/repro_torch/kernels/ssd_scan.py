"""Mamba-2 SSD chunked scan: the CUDA kernels (``csrc/ssd_scan.cu``) and
their wrapper.

Replaces ``repro/kernels/ssd_scan.py::ssd_scan`` (the Pallas body
``_ssd_kernel``) and the padding of ``repro/kernels/ops.py::_ssd_pallas``,
which zero-pads T to a multiple of the chunk and crops the result: the
kernels read positions past T as zeros and do not write them.  The chunk
only tiles the work (the scan's result is the same for every chunk, up to
float32 rounding), so the kernels take ``min(chunk, T)`` rounded up to a
multiple of their 64-row tile.

Every (ds, dh) up to (128, 128) runs the three tensor-core passes
(:func:`route` ``"tensor_cores"``).  They are built for the pairs of
``INSTANCES``: the three of ``DIMS`` and (128, 128).  Any other pair runs at
the smallest of those that holds it (:func:`padded`): the wrapper zero-pads
x to its dh and B and C to its ds, which adds only exact zeros to every
sum, and crops y (counted, with every pair outside ``DIMS``, in
``padded_launches``).  Only a pair past (128, 128) runs the generic kernel,
the recurrence in f32 on the CUDA cores, kept as the route past the
passes' reach (counted also in ``generic_launches``).  The source notes in
``csrc/ssd_scan.cu`` say what bounds each on an H100 and how its design
answers that.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.utils.shapes import pad_to_multiple

_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
         + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
TILE = 64
MAX_CHUNK = 1024
_GENERIC_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                 + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
# (ds, dh) the tensor-core passes were first built for: mamba2-780m's, its
# smoke config's and the card tests' (32, 16)
DIMS = ((128, 64), (32, 16), (16, 16))
# the pairs the passes are built for (csrc launch_dims), smallest first:
# DIMS and row 6g's (128, 128), the widest whose pass-3 block fits
INSTANCES = ((16, 16), (32, 16), (128, 64), (128, 128))
GENERIC_STEPS = 32      # time steps a generic window stages (at most)
_SG_COLS, _SG_GROUPS = 32, 8    # csrc SG_COLS, SG_GROUPS


def out_smem_bytes(ds: int, dh: int, chunk: int) -> int:
    """Shared memory of a pass-3 block of instantiation (ds, dh) (csrc
    ``ssd_out_floats``): cum, the C and B (or S_in) tiles, X and G."""
    return 4 * (chunk + TILE * (ds + 4) + max(TILE * (ds + 4), ds * (dh + 8))
                + TILE * (dh + 8) + TILE * (TILE + 4))


def padded(ds: int, dh: int):
    """The pair of ``INSTANCES`` this (ds, dh) runs at: the smallest that
    holds both widths (its own where it is one); None past (128, 128)."""
    return next(((p, q) for p, q in INSTANCES if ds <= p and dh <= q), None)


def route(ds: int, dh: int) -> str:
    """The kernels a CUDA call with this state and head width launches:
    ``"tensor_cores"`` (the three passes, at :func:`padded`'s pair) up to
    (128, 128), else ``"generic"``."""
    return "tensor_cores" if padded(ds, dh) else "generic"


def generic_smem_bytes(ds: int, steps: int) -> int:
    """Shared memory of a generic block (csrc ``sg_smem_bytes``): the
    (ds, 32) f32 state, and for each of ``steps`` staged time steps x's 32
    columns, b and c (ds each), exp(log_a) and the eight partial sums of
    each column."""
    return 4 * (ds * _SG_COLS + steps * (_SG_COLS + 2 * ds + 1
                                         + _SG_GROUPS * _SG_COLS))


def generic_steps(ds: int) -> int:
    """Time steps a generic window stages at state width ``ds``: up to
    ``GENERIC_STEPS``, fewer where they would not fit shared memory; 0
    where the state alone leaves no room (ds past ~1,700)."""
    steps = GENERIC_STEPS
    while steps and generic_smem_bytes(ds, steps) > _build.SMEM_LIMIT:
        steps -= 1
    return steps


def kernel_chunk(chunk: int, t: int) -> int:
    """The chunk the kernels run: ``min(chunk, t)`` (as JAX) rounded up to
    a multiple of the 64-row tile."""
    ck = max(min(chunk, t), 1)
    return -(-ck // TILE) * TILE


def _check_bc(what: str, t: torch.Tensor, x: torch.Tensor, ds: int) -> int:
    """B or C: x's dtype and device, shape (BH, T, ds) with each head's
    (T, ds) block contiguous; returns the head stride (0 when one row of
    B/C serves every head)."""
    bh, tn, _ = x.shape
    if tuple(t.shape) != (bh, tn, ds):
        raise ValueError(f"ssd_scan {what}: shape {tuple(t.shape)}, expected "
                         f"{(bh, tn, ds)}")
    if t.device != x.device:
        raise ValueError(f"ssd_scan {what}: on {t.device}, expected "
                         f"{x.device}")
    if t.dtype != x.dtype:
        raise TypeError(f"ssd_scan {what}: expected {x.dtype}, got {t.dtype}")
    if (tn > 1 and t.stride(1) != ds) or t.stride(2) != 1:
        raise ValueError(f"ssd_scan {what}: each head's (T, ds) block must be "
                         "contiguous")
    return t.stride(0) if bh > 1 else 0


def ssd_scan(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, *, chunk: int = 256) -> torch.Tensor:
    """y of the SSD scan: x (BH, T, dh), log_a (BH, T) <= 0, b/c (BH, T, ds)
    -> y (BH, T, dh) in x's type.

    A CPU tensor runs the plain version (the recurrence,
    :func:`ref.ssd_scan`); a CUDA tensor launches the kernels (x, b, c in
    float32 or bf16, log_a float32) or raises: the three tensor-core
    passes up to (ds, dh) = (128, 128), zero-padded to :func:`padded`'s
    pair, the generic kernel past that (:func:`route`).  Where autograd is
    on and an operand requires grad, the launch runs inside
    :class:`_build.PlainGrad`: the backward is the recurrence's gradient
    (float32, returned in each operand's dtype)."""
    if x.device.type == "cpu":
        return _plain(x, log_a, b, c)
    if x.device.type == "meta":
        # the chunked form the kernels compute, forward and gradient: the
        # recurrence's T steps a layer would make a 32k trace take minutes
        def chunked(x, log_a, b, c):
            return _chunked(x, log_a, b, c, kernel_chunk(chunk, x.shape[1]))
        return _build.on_meta("ssd_scan", chunked, x, log_a, b, c)
    return _on_card(x, log_a, b, c, chunk)


def _plain(x, log_a, b, c):
    return ref.ssd_scan(x, log_a, b, c)[0]


def _chunked(x, log_a, b, c, chunk):
    """y of :func:`ref.ssd_chunked` at ``chunk``, T zero-padded up to a
    multiple of it (a zero row adds nothing to the state ahead of it)."""
    t = x.shape[1]
    x, log_a, b, c = (pad_to_multiple(v, chunk, 1) for v in (x, log_a, b, c))
    return ref.ssd_chunked(x, log_a, b, c, chunk)[0][:, :t]


def _on_card(x, log_a, b, c, chunk):
    """The launch, inside :class:`_build.PlainGrad` with the plain
    version's gradient where autograd wants one."""
    return _build.with_plain_grad(
        lambda x, log_a, b, c: _launch(x, log_a, b, c, chunk), _plain,
        x, log_a, b, c)


def _launch(x, log_a, b, c, chunk):
    bstride, cstride = _check(x, log_a, b, c)
    bh, tn, dh = x.shape
    ds = b.shape[-1]
    if route(ds, dh) == "generic":
        return _generic(x, log_a, b, c, bstride, cstride)
    ck = kernel_chunk(chunk, tn)
    if ck > MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {ck} over {MAX_CHUNK}")
    n = -(-tn // ck)
    dsp, dhp = padded(ds, dh)
    if bh * max(n * ck // TILE, -(-dsp * dhp // 256)) > 2 ** 31 - 1:
        raise ValueError(f"ssd_scan: BH = {bh} x T = {tn} needs more than "
                         "2^31 - 1 blocks")
    if (dsp, dhp) != (ds, dh):
        x = torch.nn.functional.pad(x, (0, dhp - dh))
        b, c = (_pad_bc(t, s, dsp) for t, s in ((b, bstride), (c, cstride)))
    states = torch.empty((bh, n, dsp, dhp), dtype=torch.float32,
                         device=x.device)
    totals = torch.empty((bh, n), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    _build.launch(
        "ssd_scan", "launch_ssd_scan", _ARGS, x.data_ptr(), log_a.data_ptr(),
        b.data_ptr(), c.data_ptr(), states.data_ptr(), totals.data_ptr(),
        y.data_ptr(), bh, tn, dsp, dhp, ck, b.stride(0) if bstride else 0,
        c.stride(0) if cstride else 0, int(x.dtype == torch.bfloat16),
        _build.stream_handle(x.device))
    ssd_scan.launches += 1
    if (ds, dh) not in DIMS:
        ssd_scan.padded_launches += 1
    return y if dhp == dh else y[..., :dh].contiguous()


def _pad_bc(t, stride, dsp):
    """B or C zero-padded to ``dsp`` columns: once, and broadcast again,
    where one row serves every head (head stride 0)."""
    pad = (0, dsp - t.shape[-1])
    if stride:
        return torch.nn.functional.pad(t, pad)
    return torch.nn.functional.pad(t[:1], pad).expand(*t.shape[:2], dsp)


def _check(x, log_a, b, c):
    """Types, shapes and layouts; returns B's and C's head strides."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ssd_scan x: float32 or bfloat16, got {x.dtype}")
    _build.check_tensor("ssd_scan x", x, x.dtype)
    bh, tn, dh = x.shape
    ds = b.shape[-1]
    _build.check_tensor("ssd_scan log_a", log_a, torch.float32, (bh, tn),
                        x.device)
    bstride = _check_bc("b", b, x, ds)
    cstride = _check_bc("c", c, x, ds)
    if bh < 1 or tn < 1 or ds < 1 or dh < 1:
        raise ValueError(f"ssd_scan: empty input {tuple(x.shape)}, ds {ds}")
    return bstride, cstride


def generic(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """The generic kernel on CUDA tensors, whatever :func:`route` says:
    what :func:`ssd_scan` launches past (128, 128), and how a check holds
    and times it against the tensor-core passes on the same inputs.
    Counted in ``ssd_scan.launches`` and ``generic_launches``.  A
    gradient, where one is wanted, is the plain version's."""
    return _build.with_plain_grad(_launch_generic, _plain, x, log_a, b, c)


def _launch_generic(x, log_a, b, c):
    return _generic(x, log_a, b, c, *_check(x, log_a, b, c))


def _generic(x, log_a, b, c, bstride, cstride):
    bh, tn, dh = x.shape
    ds = b.shape[-1]
    steps = generic_steps(ds)
    if not steps:
        raise ValueError(f"ssd_scan: state width {ds} leaves no room in "
                         "shared memory")
    if bh * -(-dh // _SG_COLS) > 2 ** 31 - 1:
        raise ValueError(f"ssd_scan: BH = {bh} x dh = {dh} needs more than "
                         "2^31 - 1 blocks")
    y = torch.empty_like(x)
    _build.launch(
        "ssd_scan", "launch_ssd_scan_generic", _GENERIC_ARGS, x.data_ptr(),
        log_a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(), bh, tn,
        ds, dh, steps, bstride, cstride, int(x.dtype == torch.bfloat16),
        _build.stream_handle(x.device))
    ssd_scan.launches += 1
    ssd_scan.generic_launches += 1
    return y


ssd_scan.launches = 0
ssd_scan.padded_launches = 0
ssd_scan.generic_launches = 0
