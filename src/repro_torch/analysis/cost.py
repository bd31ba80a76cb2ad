"""Weighted cost of one traced cell (``repro/analysis/hlo.py``).

JAX's dry run parses the compiled, partitioned HLO, weighting every
computation by its trip count.  The port has no HLO: :func:`count` runs the
cell once on ``meta`` tensors, which compute shapes only, under
``torch.utils.flop_counter.FlopCounterMode`` and a ``TorchDispatchMode``
that sees every aten op.  The model's Python loops run every layer and
micro-batch, so nothing needs a trip count.  The cost models are
``hlo.py``'s, per rank (the trace is one rank's, with this rank's slices of
the params and of the batch):

  FLOPs       every dot (mm, addmm, bmm, baddbmm) and convolution, as
              FlopCounterMode counts them: ``2 * out * contraction``;
              elementwise ops are ignored, as in ``hlo.py``.
  HBM bytes   operand + result bytes of every op that moves data: views
              (every result on an operand's storage) are free; a gather (index, embedding, index_select) moves
              twice its result plus its indices and a scatter
              (``index_put_``) twice its values plus its indices (``hlo.py``'s
              dynamic-slice / dynamic-update-slice rule: the buffer is
              aliased, not swept).  A kernel (``fabric.meta_kernel``) is one
              unit: its inputs and outputs, none of its plain version's
              intermediates, which the kernel keeps on chip.  Like
              ``hlo.py``'s fusion-boundary traffic this is an upper bound:
              eager PyTorch fuses nothing outside the kernels.
  wire bytes  the collectives ``distributed.tp.recording`` recorded, by
              ``hlo.py``'s ring model (per rank, ``g`` the group size):
                all-gather        (g-1)/g * result
                reduce-scatter    (g-1)   * result
                all-reduce        2(g-1)/g * result
                all-to-all        (g-1)/g * result
                collective-permute  result

It also follows this rank's device memory: every storage an op (or a
kernel) creates is live from then until Python frees it (a finalizer on
the storage), beside the arguments' storages, which live throughout; the
largest sum is ``peak_bytes``.  ``argument_bytes`` counts the arguments
some op reads, as ``jax.jit`` prunes the unused ones (whisper's encoder
step leaves the decoder's params unread).
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import fabric
from repro_torch.utils.tree import tree_map

_aten = torch.ops.aten
# reads of a few rows of a big operand: twice the result plus the indices
_GATHERS = {_aten.index.Tensor, _aten.index_select.default,
            _aten.embedding.default, _aten.gather.default}
# in-place writes of a few rows: twice the values plus the indices
_SCATTERS = {_aten.index_put_.default, _aten.index_put.default,
             _aten._index_put_impl_.default}
# allocation without a write
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default,
         _aten.empty_like.default, _aten.new_empty.default,
         _aten.new_empty_strided.default}


def _ring_wire(op: str, result_bytes: float, g: int) -> float:
    """Bytes one rank puts on the wire for one collective (``hlo.py``)."""
    if op == "all-gather":
        return result_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return result_bytes * (g - 1)
    if op == "all-reduce":
        return 2 * result_bytes * (g - 1) / g
    if op == "all-to-all":
        return result_bytes * (g - 1) / g
    return result_bytes


@dataclasses.dataclass
class WeightedCost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    wire_bytes: dict = dataclasses.field(default_factory=dict)
    collective_ops: dict = dataclasses.field(default_factory=dict)
    hbm_by_kind: dict = dataclasses.field(default_factory=dict)
    flops_by_kind: dict = dataclasses.field(default_factory=dict)
    # the port's own: FLOPs inside each kernel (``fabric.meta_kernel``), and
    # the rank's device memory over the trace: the arguments the step
    # reads (jit's pruning: an argument no op reads is not one), those it
    # leaves unread, and the peak of live bytes with all of them resident
    flops_by_kernel: dict = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    unused_argument_bytes: int = 0
    peak_bytes: int = 0
    output: Any = None

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())


def tensors(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples (a
    ``QuantizedTensor`` leaf gives its payload and scales)."""
    from repro_torch.quant import core as qcore
    if isinstance(tree, torch.Tensor):
        return [tree]
    if qcore.is_quantized(tree):
        return tensors([tree.q, tree.scale, tree.act_scale])
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors(v)]
    return []


def nbytes(tree) -> int:
    """The bytes of a tree's tensors as they are (a view its own)."""
    return sum(t.numel() * t.element_size() for t in tensors(tree))


def storage_bytes(tree, exclude=()) -> int:
    """The bytes of the distinct storages under a tree's tensors, leaving
    out the storages in ``exclude`` (keys of :func:`storage_key`)."""
    seen = {}
    for t in tensors(tree):
        st = t.untyped_storage()
        key = storage_key(t)
        if key not in exclude:
            seen[key] = st.nbytes()
    return sum(seen.values())


def storage_key(t: torch.Tensor) -> int:
    """A storage's identity while it lives."""
    return t.untyped_storage()._cdata


class _Memory:
    """Live bytes of the storages created since the trace began."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self._keys: set = set()

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._keys:
            return
        n = st.nbytes()
        self._keys.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._keys.discard(key)
        self.live -= n


class _Tracer(TorchDispatchMode):
    def __init__(self, cost: WeightedCost, memory: _Memory,
                 flops: FlopCounterMode, arguments: set):
        super().__init__()
        self.cost = cost
        self.memory = memory
        self.flops = flops
        self.arguments = arguments      # storage keys of the arguments
        self.used: set = set()          # those an op read
        self.in_kernel = 0

    def _read(self, ins) -> None:
        for t in ins:
            key = storage_key(t)
            if key in self.arguments:
                self.used.add(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.in_kernel:
            return out
        ins = [t for t in tensors(list(args) + list(kwargs.values()))
               if t.device.type == "meta"]
        outs = [t for t in tensors(out) if t.device.type == "meta"]
        # a view (or a ``to`` that changes nothing) moves no data: every
        # output on an input's storage, and no input written
        in_keys = {storage_key(t) for t in ins}
        if (outs and not func._schema.is_mutable
                and all(storage_key(t) in in_keys for t in outs)):
            return out
        for t in outs:
            self.memory.add(t)
        self._read(ins)
        traffic = self._traffic(func, ins, outs)
        if traffic:
            self.cost.hbm_bytes += traffic
            self.cost.hbm_by_kind[str(func.overloadpacket.__name__)] += \
                traffic
        return out

    @staticmethod
    def _traffic(func, ins, outs) -> float:
        if func in _FREE:
            return 0.0
        if func in _GATHERS:
            idx = sum(nbytes(t) for t in ins[1:] if not t.is_floating_point())
            return 2.0 * nbytes(outs) + idx
        if func in _SCATTERS:
            values = nbytes(ins[-1]) if ins else 0
            idx = sum(nbytes(t) for t in ins[1:-1])
            return 2.0 * values + idx
        return float(nbytes(ins) + nbytes(outs))

    def kernel(self, op, plain, inputs):
        """``fabric.meta_kernel``'s hook: the kernel as one unit."""
        before = self.flops.get_total_flops()
        self.in_kernel += 1
        try:
            out = plain(*inputs)
        finally:
            self.in_kernel -= 1
        if self.in_kernel:
            return out
        self.cost.flops_by_kernel[op] += self.flops.get_total_flops() - before
        out = self._own_outputs(out, inputs)
        outs = tensors(out)
        for t in outs:
            self.memory.add(t)
        self._read([t for t in tensors(inputs) if t.device.type == "meta"])
        traffic = nbytes(inputs) + nbytes(outs)
        self.cost.hbm_bytes += traffic
        self.cost.hbm_by_kind[f"kernel.{op}"] += traffic
        return out

    def _own_outputs(self, out, inputs):
        """The kernel writes each output into a buffer of its own size: an
        output of the plain version that views a larger intermediate is
        copied (untraced), so the intermediate is freed as on the card."""
        in_keys = {storage_key(t) for t in tensors(inputs)}

        def own(t):
            if (isinstance(t, torch.Tensor) and storage_key(t) not in in_keys
                    and nbytes(t) < t.untyped_storage().nbytes()):
                return t.clone()
            return t
        self.in_kernel += 1
        try:
            return tree_map(own, out)
        finally:
            self.in_kernel -= 1


def _flop_kind(op) -> str:
    return "convolution" if "conv" in str(op) else "dot"


def count(fn, *args) -> WeightedCost:
    """Run ``fn(*args)`` once on meta tensors (every tensor of ``args``
    must be ``meta``) and return its :class:`WeightedCost`; ``output``
    holds what ``fn`` returned.  Collectives count only inside
    ``tp.recording``, whose record this reads."""
    from repro_torch.distributed import tp
    for t in tensors(args):
        if t.device.type != "meta":
            raise ValueError(f"analysis.cost.count: a {t.device.type} "
                             "argument; the trace runs on meta tensors")
    cost = WeightedCost(wire_bytes=defaultdict(float),
                        collective_ops=defaultdict(float),
                        hbm_by_kind=defaultdict(float),
                        flops_by_kind=defaultdict(float),
                        flops_by_kernel=defaultdict(float))
    memory = _Memory()
    sizes = {}
    for t in tensors(args):
        memory.add(t)
        sizes[storage_key(t)] = t.untyped_storage().nbytes()
    record = tp._RECORD
    first = len(record) if record is not None else 0
    flops = FlopCounterMode(display=False)
    tracer = _Tracer(cost, memory, flops, set(sizes))
    with flops, tracer, fabric.meta_hook(tracer.kernel):
        cost.output = fn(*args)
    cost.peak_bytes = memory.peak
    cost.argument_bytes = sum(sizes[k] for k in tracer.used)
    cost.unused_argument_bytes = sum(sizes.values()) - cost.argument_bytes
    for op, n in flops.get_flop_counts().get("Global", {}).items():
        cost.flops += n
        cost.flops_by_kind[_flop_kind(op)] += n
    for op, result_bytes, g in (record or [])[first:]:
        if g > 1:
            cost.wire_bytes[op] += _ring_wire(op, result_bytes, g)
            cost.collective_ops[op] += 1
    cost.wire_bytes = dict(cost.wire_bytes)
    cost.collective_ops = dict(cost.collective_ops)
    cost.hbm_by_kind = dict(cost.hbm_by_kind)
    cost.flops_by_kind = dict(cost.flops_by_kind)
    cost.flops_by_kernel = dict(cost.flops_by_kernel)
    return cost
