"""The fused flowcell tick: conv stack -> head -> CTC collapse -> counters
in one launch (``csrc/fused_stream.cu``), and its plain twin.

Replaces ``repro/kernels/fused_stream.py::_fused_pallas`` (Pallas body
``_fused_kernel``), float and int8 layers alike.  :func:`_fused_reference`
composes the unfused plain pieces exactly as
``repro/kernels/fused_stream.py::_fused_reference`` does, with the lane
reset folded in up front.  A layer whose weight is a ``QuantizedTensor``
with a calibrated ``act_scale`` runs the int8 MAC path inside the kernel
(counted ``fabric.precision.fused_stream.int8``); uncalibrated weights and
scales off the last axis raise on the card (JAX counts them as the
fallbacks ``int8_dynamic_act`` and ``int8_axis``).  The source note in
``csrc/fused_stream.cu`` says what bounds the kernel on an H100 and how its
one-CTA-per-lane, shared-memory-resident design answers that.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import ctc
from repro_torch.kernels import _build
from repro_torch.kernels import fabric
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.quant import core as qcore

MAX_LAYERS = 8
THREADS = 512
_ARGS = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
         + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _specs(cfg):
    from repro_torch.core import basecaller as bc
    return bc.stream_layer_specs(cfg)


def fused_stream_step(params, lane_state, rows, frame_pads, reset=None, *,
                      cfg):
    """One fused flowcell tick over all lanes.

    ``lane_state`` is the runtime's lane-major dict (``conv`` carries,
    ``prev_class``, ``bases``, ``ticks``); ``rows`` (lanes, chunk) raw
    signal; ``frame_pads`` (lanes, n_frames) 1.0 where a frame is padding;
    ``reset`` (lanes,) nonzero where the lane starts a new read this tick.
    Returns ``(tokens, lens, new_lane_state)``, the contract of the unfused
    step after the host-side lane reset."""
    lanes, chunk = rows.shape
    if chunk % cfg.total_stride:
        raise ValueError(f"chunk length {chunk} must be a multiple of "
                         f"total_stride={cfg.total_stride}")
    if reset is None:
        reset = torch.zeros((lanes,), dtype=torch.float32, device=rows.device)
    args = (rows, frame_pads, reset, lane_state["prev_class"],
            lane_state["bases"], lane_state["ticks"],
            tuple(lane_state["conv"]), params)
    if fabric.dispatch("fused_stream", rows) == "reference":
        return _fused_reference(*args, cfg=cfg)
    return fused_stream_cuda(*args, cfg=cfg)


def _fused_reference(rows, pads, reset, prev, bases, ticks, conv, params, *,
                     cfg):
    """Composition of the unfused plain pieces, reset folded in."""
    specs = _specs(cfg)
    rmask = reset > 0
    x = rows.to(cfg.dtype)[..., None]
    if any(qcore.is_quantized(params[sp.name]["w"]) for sp in specs):
        fabric.record("fabric.precision.fused_stream.int8")
    new_conv = []
    for i, sp in enumerate(specs):
        p = params[sp.name]
        w = p["w"]
        if sp.is_head:
            bsz, t, cin = x.shape
            x2 = x.reshape(bsz * t, cin)
            if qcore.is_quantized(w):
                y = ops.int8_reference(x2, w.head_matrix(), p["b"],
                                       activation=sp.activation)
            else:
                y = ref.matmul(x2, w[0], p["b"], activation=sp.activation)
            x = y.reshape(bsz, t, sp.cout)
            new_conv.append(conv[i])
        else:
            carry = conv[i]
            if sp.carry_rows:
                carry = torch.where(rmask[:, None, None], 0.0, carry)
            buf = torch.cat([carry.to(x.dtype), x], dim=1)
            if qcore.is_quantized(w):
                x = ops.int8_reference(buf, w, p["b"], stride=sp.stride,
                                       activation=sp.activation)
            else:
                x = ref.conv1d(buf, w, p["b"], stride=sp.stride,
                               activation=sp.activation)
            new_conv.append(buf[:, buf.shape[1] - sp.carry_rows:, :])
    prev0 = torch.where(rmask, ctc.BLANK, prev)
    tokens, lens, new_prev = ctc.greedy_decode_stream(x, prev0, pads)
    new_lane = {
        "conv": new_conv,
        "prev_class": new_prev,
        "bases": torch.where(rmask, 0, bases) + lens,
        "ticks": torch.where(rmask, 0, ticks) + 1,
    }
    return tokens, lens, new_lane


def smem_plan(cfg, chunk: int) -> tuple[int, int, int]:
    """Sizes (floats) of the kernel's two ping-pong buffers and its total
    fp32 shared memory in bytes.  Layer i's input [carry | chunk rows]
    lives in buffer i % 2; the logits land in buffer n % 2."""
    specs = _specs(cfg)
    sizes = [0, 0]
    t = chunk
    for i, sp in enumerate(specs):
        sizes[i % 2] = max(sizes[i % 2], (sp.carry_rows + t) * sp.cin)
        t //= sp.stride
    n = len(specs)
    sizes[n % 2] = max(sizes[n % 2], t * specs[-1].cout)
    n_frames = chunk // cfg.total_stride
    return sizes[0], sizes[1], (sizes[0] + sizes[1] + n_frames) * 4


def int8_buffer_bytes(cfg, chunk: int, quantized) -> int:
    """Bytes of the int8 kernel's quantized-input buffer: the largest
    [carry | input] of a layer flagged in ``quantized``, 16-byte rounded
    (0 when no layer is quantized)."""
    out, t = 0, chunk
    for sp, q in zip(_specs(cfg), quantized):
        if q:
            out = max(out, -(-(sp.carry_rows + t) * sp.cin // 16) * 16)
        t //= sp.stride
    return out


def _int8_layer_check(name: str, w) -> None:
    """A quantized layer the kernel can take, or the JAX fallback reason."""
    if w.act_scale is None:
        raise ValueError(
            f"fused_stream: {name} has no calibrated act_scale "
            "(int8_dynamic_act: the dynamic absmax is a reduction across "
            "lanes, which a per-lane kernel cannot take; calibrate the "
            "params or run unfused)")
    if w.axis is not None and w.axis % w.ndim != w.ndim - 1:
        raise ValueError(f"fused_stream: {name} scales run along axis "
                         f"{w.axis}, not the output axis (int8_axis)")


def fused_stream_cuda(rows, pads, reset, prev, bases, ticks, conv, params,
                      *, cfg):
    """Launch the fused tick on the card.  Raises for a shape the kernel
    cannot take (more than 8 layers, or buffers over 227 KB) and for int8
    weights without a calibrated input scale."""
    specs = _specs(cfg)
    lanes, chunk = rows.shape
    n_frames = chunk // cfg.total_stride
    dev = rows.device
    if cfg.dtype != torch.float32:
        raise TypeError("fused_stream: float32 basecaller only")
    if len(specs) > MAX_LAYERS:
        raise ValueError(f"fused_stream: {len(specs)} layers > {MAX_LAYERS}")
    quantized = [qcore.is_quantized(params[sp.name]["w"]) for sp in specs]
    for sp, q in zip(specs, quantized):
        if q:
            _int8_layer_check(sp.name, params[sp.name]["w"])
    buf0, buf1, smem = smem_plan(cfg, chunk)
    qbytes = int8_buffer_bytes(cfg, chunk, quantized)
    smem += qbytes
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"fused_stream: chunk {chunk} needs {smem} B of "
                         f"shared memory per lane, over {_build.SMEM_LIMIT}")
    f32, i32 = torch.float32, torch.int32
    _build.check_tensor("fused rows", rows, f32)
    _build.check_tensor("fused pads", pads, f32, (lanes, n_frames), dev)
    _build.check_tensor("fused reset", reset, f32, (lanes,), dev)
    for name, t in (("prev", prev), ("bases", bases), ("ticks", ticks)):
        _build.check_tensor(f"fused {name}", t, i32, (lanes,), dev)
    meta = (ctypes.c_int * (6 * len(specs)))()
    ptrs = (ctypes.c_void_p * (6 * len(specs)))()
    new_conv = []
    for i, sp in enumerate(specs):
        p = params[sp.name]
        w = p["w"]
        wshape = (sp.ksize, sp.cin, sp.cout)
        if quantized[i]:
            _build.check_tensor(f"fused {sp.name}.q", w.q, torch.int8, wshape,
                                dev)
            wk = w.packed() if sp.cin % 4 == 0 else w.q
            scale = w.dequant_scale()
            _build.check_tensor(f"fused {sp.name}.scale", scale, f32,
                                (sp.cout,), dev)
            _build.check_tensor(f"fused {sp.name}.act_scale", w.act_scale,
                                f32, (), dev)
            ptrs[6 * i + 4] = scale.data_ptr()
            ptrs[6 * i + 5] = w.act_scale.data_ptr()
        else:
            _build.check_tensor(f"fused {sp.name}.w", w, f32, wshape, dev)
            wk = w
        _build.check_tensor(f"fused {sp.name}.b", p["b"], f32, (sp.cout,),
                            dev)
        meta[6 * i: 6 * i + 6] = [sp.ksize, sp.stride, sp.cin, sp.cout,
                                  ref.ACTIVATION_CODES[sp.activation],
                                  int(quantized[i])]
        ptrs[6 * i] = wk.data_ptr()
        ptrs[6 * i + 1] = p["b"].data_ptr()
        if sp.carry_rows:
            _build.check_tensor(f"fused carry {i}", conv[i], f32,
                                (lanes, sp.carry_rows, sp.cin), dev)
            out = torch.empty_like(conv[i])
            ptrs[6 * i + 2] = conv[i].data_ptr()
            ptrs[6 * i + 3] = out.data_ptr()
            new_conv.append(out)
        else:
            new_conv.append(conv[i])
    tokens = torch.empty((lanes, n_frames), dtype=i32, device=dev)
    lens, new_prev, new_bases, new_ticks = (
        torch.empty((lanes,), dtype=i32, device=dev) for _ in range(4))
    _build.launch(
        "fused_stream", "launch_fused_stream", _ARGS, meta, ptrs, len(specs),
        rows.data_ptr(), pads.data_ptr(), reset.data_ptr(), prev.data_ptr(),
        bases.data_ptr(), ticks.data_ptr(), tokens.data_ptr(),
        lens.data_ptr(), new_prev.data_ptr(), new_bases.data_ptr(),
        new_ticks.data_ptr(), lanes, chunk, n_frames, buf0, buf1, qbytes,
        THREADS, _build.stream_handle(dev))
    if any(quantized):
        fabric.record("fabric.precision.fused_stream.int8")
        fused_stream_cuda.launches_int8 += 1
    else:
        fused_stream_cuda.launches += 1
    new_lane = {"conv": new_conv, "prev_class": new_prev, "bases": new_bases,
                "ticks": new_ticks}
    return tokens, lens, new_lane


# launches of the fp32 kernel and of its int8 instantiation
# (fused_stream_kernel<false> / <true> in csrc/fused_stream.cu)
fused_stream_cuda.launches = 0
fused_stream_cuda.launches_int8 = 0
