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
import dataclasses
import functools

import torch

from repro_torch.core import ctc
from repro_torch.kernels import _build
from repro_torch.kernels import conv1d
from repro_torch.kernels import fabric
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.quant import core as qcore

MAX_LAYERS = 8
# frames of a warp's tile on the tensor cores (csrc/fused_stream.cu
# FS_FRAME_TILE; the launcher refuses a plan padded for fewer)
FRAME_TILE = 32
# input channels of an int8 layer's k-step on the tensor cores
# (mma.sync.m16n8k32), and the 32-word lines its swizzled scratch fills
INT8_SLICE = 32
LINE = 32
META = 10           # ints a layer in the kernel's meta array
_ARGS = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
         + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


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
    target = fabric.dispatch("fused_stream", rows)
    if target == "reference":
        return _fused_reference(*args, cfg=cfg)
    if target == "meta":
        return fabric.meta_kernel("fused_stream", lambda *a: _fused_reference(
            *a, cfg=cfg), *args)
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


def on_tensor_cores(sp, quantized: bool = False) -> bool:
    """Whether layer ``sp`` runs on the tensor cores inside the fused
    kernel, never the k=1 head.  fp32 (3xTF32): the shapes
    :func:`conv1d.tensor_core_shape` takes, whose fmaf order the head
    keeps.  int8 (``mma.sync`` s8 -> s32, exact): whole 32-channel k-steps
    and Cout in the MMA's 8 columns.  Both are the paper CNN's
    conv2-conv5."""
    if sp.is_head:
        return False
    if quantized:
        return sp.cin % INT8_SLICE == 0 and sp.cout % 8 == 0
    return conv1d.tensor_core_shape(sp.cin, sp.cout, sp.ksize, sp.stride)


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One layer's place in the kernel's shared memory (offsets in floats):
    its [carry | input] rows, its output (the next layer's input, or the
    logits) and its scratch (an int8 layer's quantized input)."""
    tc: bool
    in_off: int
    out_off: int
    scratch_off: int


@dataclasses.dataclass(frozen=True)
class SmemPlan:
    layers: tuple[LayerPlan, ...]
    cls_off: int        # floats to the class buffer
    bytes: int          # the block's dynamic shared memory


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _padded_rows(sp, t: int) -> int:
    """[carry | input] rows of a tensor-core layer over ``t`` input rows,
    padded to whole ``FRAME_TILE``-frame tiles of its output."""
    tiles = -(-(t // sp.stride) // FRAME_TILE)
    return max(sp.carry_rows + t, (tiles * FRAME_TILE - 1) * sp.stride
               + sp.ksize)


def smem_plan(cfg, chunk: int, quantized=None) -> SmemPlan:
    """Where the fused kernel keeps each layer in shared memory.

    Layer i's input sits at the low end and its output at the high end when
    i is even, the other way round when i is odd (the output of layer i is
    the input of layer i + 1, in place); the gap between them is the
    layer's scratch, an int8 layer's quantized input.  An fp32 tensor-core
    layer's input rows are padded to whole ``FRAME_TILE``-frame tiles; an
    int8 one's quantized rows are, in whole ``LINE``-word lines.  In an
    int8 launch only the int8 layers may take the tensor cores.  The size
    is the largest layer's input + output + scratch, then the class
    buffer.  Raises ``ValueError`` past the block's shared memory.  The
    kernel's launcher checks the plan against its own tile (and the
    swizzle of a tensor-core layer's rows is the kernel's alone)."""
    specs = _specs(cfg)
    quantized = list(quantized or [False] * len(specs))
    int8 = any(quantized)
    tc = [on_tensor_cores(sp, q) and q == int8
          for sp, q in zip(specs, quantized)]
    ins, scratch, t = [], [], chunk
    for sp, q, on_tc in zip(specs, quantized, tc):
        rows = sp.carry_rows + t
        padded = _padded_rows(sp, t) if on_tc else rows
        ins.append((rows if q else padded) * sp.cin)
        if q and on_tc:
            scratch.append(-(-padded * sp.cin // (4 * LINE)) * LINE)
        else:
            scratch.append(_round4(-(-rows * sp.cin // 4)) if q else 0)
        t //= sp.stride
    outs = ins[1:] + [t * specs[-1].cout]
    total = max(_round4(i) + _round4(o) + s
                for i, o, s in zip(ins, outs, scratch))
    layers = []
    for i, sp in enumerate(specs):
        lo_in = i % 2 == 0
        low = _round4(ins[i] if lo_in else outs[i])
        high = total - _round4(outs[i] if lo_in else ins[i])
        layers.append(LayerPlan(
            tc=tc[i], in_off=0 if lo_in else high,
            out_off=high if lo_in else 0, scratch_off=low))
    n_frames = chunk // cfg.total_stride
    nbytes = (total + n_frames) * 4
    if nbytes > _build.SMEM_LIMIT:
        raise ValueError(f"fused_stream: chunk {chunk} needs {nbytes} B of "
                         f"shared memory per lane, over {_build.SMEM_LIMIT}")
    return SmemPlan(tuple(layers), total, nbytes)


@functools.lru_cache(maxsize=None)
def _launch_meta(cfg, chunk: int, quantized: tuple):
    """The plan and the kernel's per-layer meta array for one shape (built
    once: the launch is on the tick's host path)."""
    specs = _specs(cfg)
    plan = smem_plan(cfg, chunk, quantized)
    meta = (ctypes.c_int * (META * len(specs)))()
    for i, (sp, lp) in enumerate(zip(specs, plan.layers)):
        meta[META * i: META * i + META] = [
            sp.ksize, sp.stride, sp.cin, sp.cout,
            ref.ACTIVATION_CODES[sp.activation], int(quantized[i]),
            int(lp.tc), lp.in_off, lp.out_off, lp.scratch_off]
    return plan, meta


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
    if torch.is_grad_enabled():     # every tick: list operands only here
        _build.refuse_grad("fused_stream", rows, pads, reset, *conv, *(
            t for sp in specs for t in (params[sp.name]["w"],
                                        params[sp.name]["b"])))
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
    plan, meta = _launch_meta(cfg, chunk, tuple(quantized))
    f32, i32 = torch.float32, torch.int32
    _build.check_tensor("fused rows", rows, f32)
    _build.check_tensor("fused pads", pads, f32, (lanes, n_frames), dev)
    _build.check_tensor("fused reset", reset, f32, (lanes,), dev)
    for name, t in (("prev", prev), ("bases", bases), ("ticks", ticks)):
        _build.check_tensor(f"fused {name}", t, i32, (lanes,), dev)
    ptrs = (ctypes.c_void_p * (6 * len(specs)))()
    new_conv = []
    for i, sp in enumerate(specs):
        p = params[sp.name]
        w = p["w"]
        wshape = (sp.ksize, sp.cin, sp.cout)
        if quantized[i]:
            _build.check_tensor(f"fused {sp.name}.q", w.q, torch.int8, wshape,
                                dev)
            if plan.layers[i].tc:
                wk = w.fragments()
            else:
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
        new_ticks.data_ptr(), lanes, chunk, n_frames, plan.cls_off,
        plan.bytes, _build.stream_handle(dev))
    tc = sum(lp.tc for lp in plan.layers)
    if any(quantized):
        fabric.record("fabric.precision.fused_stream.int8")
        fused_stream_cuda.launches_int8 += 1
        fused_stream_cuda.tc_launches_int8 += tc > 0
        fused_stream_cuda.tc_layers_int8 += tc
    else:
        fused_stream_cuda.launches += 1
        fused_stream_cuda.tc_launches += tc > 0
        fused_stream_cuda.tc_layers += tc
    new_lane = {"conv": new_conv, "prev_class": new_prev, "bases": new_bases,
                "ticks": new_ticks}
    return tokens, lens, new_lane


# launches of the fp32 kernel and of its int8 instantiation
# (fused_stream_kernel<false> / <true> in csrc/fused_stream.cu); of each,
# those that ran conv layers on the tensor cores, and those layers
fused_stream_cuda.launches = 0
fused_stream_cuda.launches_int8 = 0
fused_stream_cuda.tc_launches = 0
fused_stream_cuda.tc_layers = 0
fused_stream_cuda.tc_launches_int8 = 0
fused_stream_cuda.tc_layers_int8 = 0
