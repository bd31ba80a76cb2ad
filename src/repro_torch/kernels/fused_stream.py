"""The fused flowcell tick: conv stack -> head -> CTC collapse -> counters
in one launch (``csrc/fused_stream.cu``), and its plain twin.

Replaces ``repro/kernels/fused_stream.py::_fused_pallas`` (Pallas body
``_fused_kernel``).  :func:`_fused_reference` composes the unfused plain
pieces exactly as ``repro/kernels/fused_stream.py::_fused_reference`` does,
with the lane reset folded in up front.  The source note in
``csrc/fused_stream.cu`` says what bounds the kernel on an H100 and how its
one-CTA-per-lane, shared-memory-resident design answers that.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import ctc
from repro_torch.kernels import _build
from repro_torch.kernels import fabric
from repro_torch.kernels import ref

MAX_LAYERS = 8
THREADS = 512
_ARGS = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
         + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


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
    rmask = reset > 0
    x = rows.to(cfg.dtype)[..., None]
    new_conv = []
    for i, sp in enumerate(_specs(cfg)):
        p = params[sp.name]
        if sp.is_head:
            bsz, t, cin = x.shape
            y = ref.matmul(x.reshape(bsz * t, cin), p["w"][0], p["b"],
                           activation=sp.activation)
            x = y.reshape(bsz, t, sp.cout)
            new_conv.append(conv[i])
        else:
            carry = conv[i]
            if sp.carry_rows:
                carry = torch.where(rmask[:, None, None], 0.0, carry)
            buf = torch.cat([carry.to(x.dtype), x], dim=1)
            x = ref.conv1d(buf, p["w"], p["b"], stride=sp.stride,
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
    shared memory in bytes.  Layer i's input [carry | chunk rows] lives in
    buffer i % 2; the logits land in buffer n % 2."""
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


def fused_stream_cuda(rows, pads, reset, prev, bases, ticks, conv, params,
                      *, cfg):
    """Launch the fused tick on the card.  Raises for a shape the kernel
    cannot take (more than 8 layers, or buffers over 227 KB)."""
    specs = _specs(cfg)
    lanes, chunk = rows.shape
    n_frames = chunk // cfg.total_stride
    dev = rows.device
    if cfg.dtype != torch.float32:
        raise TypeError("fused_stream: float32 basecaller only")
    if len(specs) > MAX_LAYERS:
        raise ValueError(f"fused_stream: {len(specs)} layers > {MAX_LAYERS}")
    buf0, buf1, smem = smem_plan(cfg, chunk)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"fused_stream: chunk {chunk} needs {smem} B of "
                         f"shared memory per lane, over {_build.SMEM_LIMIT}")
    f32, i32 = torch.float32, torch.int32
    _build.check_tensor("fused rows", rows, f32)
    _build.check_tensor("fused pads", pads, f32, (lanes, n_frames), dev)
    _build.check_tensor("fused reset", reset, f32, (lanes,), dev)
    for name, t in (("prev", prev), ("bases", bases), ("ticks", ticks)):
        _build.check_tensor(f"fused {name}", t, i32, (lanes,), dev)
    meta = (ctypes.c_int * (5 * len(specs)))()
    ptrs = (ctypes.c_void_p * (4 * len(specs)))()
    new_conv = []
    for i, sp in enumerate(specs):
        p = params[sp.name]
        _build.check_tensor(f"fused {sp.name}.w", p["w"], f32,
                            (sp.ksize, sp.cin, sp.cout), dev)
        _build.check_tensor(f"fused {sp.name}.b", p["b"], f32, (sp.cout,),
                            dev)
        meta[5 * i: 5 * i + 5] = [sp.ksize, sp.stride, sp.cin, sp.cout,
                                  ref.ACTIVATION_CODES[sp.activation]]
        ptrs[4 * i] = p["w"].data_ptr()
        ptrs[4 * i + 1] = p["b"].data_ptr()
        if sp.carry_rows:
            _build.check_tensor(f"fused carry {i}", conv[i], f32,
                                (lanes, sp.carry_rows, sp.cin), dev)
            out = torch.empty_like(conv[i])
            ptrs[4 * i + 2] = conv[i].data_ptr()
            ptrs[4 * i + 3] = out.data_ptr()
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
        new_ticks.data_ptr(), lanes, chunk, n_frames, buf0, buf1, THREADS,
        _build.stream_handle(dev))
    fused_stream_cuda.launches += 1
    new_lane = {"conv": new_conv, "prev_class": new_prev, "bases": new_bases,
                "ticks": new_ticks}
    return tokens, lens, new_lane


fused_stream_cuda.launches = 0
