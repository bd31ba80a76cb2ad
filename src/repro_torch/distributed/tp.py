"""Tensor parallelism over the mesh's ``model`` axis
(``repro/distributed/tp.py``), one process a rank.

JAX runs the Megatron layout inside one ``shard_map`` body per device;
PyTorch's idiom is one process per rank in a ``torch.distributed`` process
group, which :mod:`repro_torch.distributed.launch` starts.  The layout is
JAX's: column-parallel ``wi``/``wi_gate``/``wq``/``wk``/``wv`` (sliced on
the output dim, no collective), row-parallel ``wo``/``out_proj`` (sliced on
the input dim, one all-reduce after), a vocab-parallel embedding, and the
Mamba-2 ``in_proj``/head vectors sliced by heads.  Three pieces:

* **runtime context**: :func:`axis_ctx` binds a process group as the
  model axis (the world's, or a mesh's model group); inside it
  :func:`psum` is ``all_reduce(SUM)``, :func:`pmax` ``all_reduce(MAX)``,
  :func:`all_gather_last` an ``all_gather`` then a ``cat`` on the last
  dim in rank order, and :func:`index` the rank in the group.  Outside any
  context every helper is the identity, so one device runs the same layer
  code.  The collectives take the tensors where they are: gloo takes CUDA
  tensors for all three (``chip_smoke.py``'s phase ``lm_tp`` checks it on
  an H100, torch 2.11), so nothing is staged through host memory.

* **gradients**: each collective is a ``torch.autograd.Function``.  A
  rank's gradient of a replicated tensor is its share, and the ranks'
  shares sum to the whole; a rank-local tensor's gradient is whole.  So
  the loss is seeded ``1 / n`` on each of the ``n`` ranks, a psum's
  backward is a psum, ``all_gather_last``'s a psum then this rank's
  columns, ``pmax`` takes none (it only shifts a softmax), and after the
  backward :func:`reduce_mesh_grads` sums every replicated leaf's
  gradient over the group.  One rule serves
  every place a replicated tensor meets rank-local work: the column-
  parallel inputs, the qk-norm scales, Mamba-2's one-group B/C columns,
  the gated RMSNorm's sum of squares.

* **the data axis**: :func:`data_ctx` binds a mesh's data group around a
  data rank's forward (``trainer.mesh_loss_and_grads``), for the two
  places where JAX's step computes over the global batch, both in the
  MoE layer: :func:`data_mean` averages the router's statistics over the
  data ranks, and :func:`from_previous_data_rank` hands the dispatch's
  last-row overflow on to the next rank (its gradient back).

* **ZeRO-3 and expert parallelism** (``sharding.mesh_plan``): inside
  :func:`mesh_ctx` a rank holds its blocks of the params, and
  :func:`gathered` all-gathers a leaf where the layer code reads it
  (:func:`gather_data`'s autograd: the gradient reduce-scattered back,
  summed over the ranks that used it); the experts stay a rank's own,
  and the MoE layer exchanges tokens by all-to-all (:func:`exchange_data`,
  its own adjoint) or all-gathers them and reduce-scatters the sums
  (:func:`scatter_data`).  After the backward :func:`reduce_mesh_grads`
  sums what an axis holds whole over it, and :func:`mesh_grad_norm_sq`
  sums each split leaf's squares over the groups that split it.  Gloo
  runs all of them on CUDA tensors (``all_gather_into_tensor``,
  ``reduce_scatter_tensor``, ``all_to_all_single``; checked on an H100,
  torch 2.11; its list ``all_to_all`` it lacks, and nothing calls it).

* **slicing plan**: :func:`build_plan` gives each parameter leaf a
  :class:`Segments` rule (or ``None``, replicated) through the same
  logical-to-mesh rules ``sharding.logical_spec`` reads.

* **placement**: :func:`partition_params` keeps this rank's slice of a
  full tree (counted ``tp.load.replicated_slice``), by a :class:`Plan` or
  a ``sharding.MeshPlan`` (:func:`mesh_local`, and :func:`assemble` /
  :func:`mesh_unshard` back);
  :func:`load_sharded_params` reads only this rank's ``shard_<k>.npz`` of a
  ``sharded`` checkpoint (counted ``tp.load.pre_partitioned``) and checks
  that each sliced leaf holds exactly its local width.

* **recorded collectives**: inside :func:`recording` (the dry run's trace
  of one rank on ``meta`` tensors, ``analysis.cost``) no collective calls
  ``torch.distributed``: each appends ``(op, result bytes, group size)``
  to the record and returns a meta tensor of the shape it would return,
  and the groups are :class:`RecordedGroup` s of a mesh played as its rank
  0.  A CPU or CUDA tensor there raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import fabric
from repro_torch.quant import core as qcore

# ================================================= recorded collectives ==
@dataclasses.dataclass(frozen=True)
class RecordedGroup:
    """A process group the dry run plays (:func:`recording`): ``size``
    ranks over the mesh axes ``axes``, this one at position ``rank``.  Its
    collectives are recorded, never run (``all-reduce``, ``all-gather``,
  ``reduce-scatter``, ``all-to-all``)."""
    axes: tuple[str, ...]
    size: int
    rank: int = 0


_RECORD: Optional[list] = None


@contextlib.contextmanager
def recording(mesh):
    """Record, in place of running, every collective of this block: yields
    ``(bound, record)``, where ``bound`` is ``mesh`` (a layout, the
    ``launch.mesh.Mesh`` of ``make_mesh`` outside a process group) played
    as its rank 0, each axis's group and the world's a
    :class:`RecordedGroup`, and ``record`` the list of ``(op, bytes,
    group size)`` the collectives append: ``op`` is ``all-reduce``,
    ``all-gather``, ``reduce-scatter`` or ``all-to-all``, ``bytes`` the
    result's bytes on this rank.  Only meta
    tensors may meet a collective here."""
    global _RECORD
    from repro_torch.launch.mesh import Mesh
    if _RECORD is not None:
        raise RuntimeError("tp.recording: already recording")
    bound = Mesh(axis_names=mesh.axis_names, sizes=mesh.sizes,
                 coords=(0,) * len(mesh.sizes),
                 groups=tuple(RecordedGroup((a,), n) for a, n in
                              zip(mesh.axis_names, mesh.sizes)),
                 world=RecordedGroup(tuple(mesh.axis_names), mesh.size))
    record: list = []
    _RECORD = record
    try:
        yield bound, record
    finally:
        _RECORD = None


def _recorded(op: str, x: torch.Tensor, grp, result_bytes: int) -> None:
    if _RECORD is None or not isinstance(grp, RecordedGroup):
        raise RuntimeError(
            f"tp: a {op} over {grp!r} outside tp.recording, or a process "
            "group inside it")
    if x.device.type != "meta":
        raise RuntimeError(
            f"tp.recording: a {op} of a {x.device.type} tensor; the dry "
            "run records collectives of meta tensors only")
    _RECORD.append((op, int(result_bytes), grp.size))


def _records(grp) -> bool:
    """Whether a collective over ``grp`` is recorded (inside
    :func:`recording`, or over a recorded group, which raises outside)."""
    return _RECORD is not None or isinstance(grp, RecordedGroup)


def _group_size(grp) -> int:
    if isinstance(grp, RecordedGroup):
        return grp.size
    return dist.get_world_size(grp)


def _group_rank(grp) -> int:
    if isinstance(grp, RecordedGroup):
        return grp.rank
    return dist.get_rank(grp)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


# ===================================================== runtime context ====
_TP_AXIS: Optional[str] = None
_TP_EXTENT: int = 1
_TP_GROUP = None


@contextlib.contextmanager
def axis_ctx(name: str, n: int, group=None):
    """Scope a tensor-parallel axis: ``with tp.axis_ctx("model", 2): ...``.

    ``n > 1`` binds ``group`` (a ``torch.distributed`` process group: the
    model group of a (data, model) mesh, ``mesh.group("model")``), or the
    world group where none is given; it must hold exactly ``n`` ranks.
    ``n <= 1`` is the identity context."""
    global _TP_AXIS, _TP_EXTENT, _TP_GROUP
    prev = (_TP_AXIS, _TP_EXTENT, _TP_GROUP)
    n = int(n)
    if n > 1:
        if not (dist.is_initialized() or isinstance(group, RecordedGroup)):
            raise RuntimeError(
                f"tp.axis_ctx({name!r}, {n}): tensor parallelism runs one "
                "process per rank; start them with "
                "repro_torch.distributed.launch.run")
        size = _group_size(group)
        if size != n:
            raise ValueError(f"tp.axis_ctx({name!r}, {n}): the process "
                             f"group holds {size} ranks")
        _TP_AXIS, _TP_EXTENT, _TP_GROUP = name, n, group
    else:
        _TP_AXIS, _TP_EXTENT, _TP_GROUP = None, 1, None
    try:
        yield
    finally:
        _TP_AXIS, _TP_EXTENT, _TP_GROUP = prev


def axis() -> Optional[str]:
    """The active TP axis name, or None outside a TP region."""
    return _TP_AXIS


def extent() -> int:
    """Number of model shards (1 outside a TP region)."""
    return _TP_EXTENT


def index() -> int:
    """This rank's position along the TP axis (0 outside a TP region)."""
    return 0 if _TP_AXIS is None else _group_rank(_TP_GROUP)


def _reduced(x: torch.Tensor, op, grp) -> torch.Tensor:
    recorded = _records(grp)
    if recorded:
        _recorded("all-reduce", x, grp, _nbytes(x))
    # the collective writes in place: into a contiguous copy
    out = x.detach().clone(memory_format=torch.contiguous_format)
    if not recorded:
        dist.all_reduce(out, op=op, group=grp)
    return out


class _Psum(torch.autograd.Function):
    """All-reduce SUM whose backward all-reduces the gradient too."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return _reduced(x, dist.ReduceOp.SUM, grp)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, dist.ReduceOp.SUM, ctx.grp), None


class _GatherLast(torch.autograd.Function):
    """All-gather on the last dim; backward sums the gradient over the
    ranks and keeps this rank's columns."""

    @staticmethod
    def forward(ctx, x, grp, n):
        recorded = _records(grp)
        if recorded:
            _recorded("all-gather", x, grp, n * _nbytes(x))
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        if not recorded:
            dist.all_gather(parts, x, group=grp)
        ctx.grp, ctx.width = grp, x.shape[-1]
        ctx.rank = _group_rank(grp)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        g = _reduced(g, dist.ReduceOp.SUM, ctx.grp)
        lo = ctx.rank * ctx.width
        return g[..., lo: lo + ctx.width].contiguous(), None, None


def psum(x: torch.Tensor, grp=None) -> torch.Tensor:
    """Sum over the TP axis (or over ``grp``); identity outside a region.
    Its gradient is the psum of the ranks' gradients (the module
    docstring gives the convention)."""
    if grp is None:
        if _TP_AXIS is None:
            return x
        grp = _TP_GROUP
    return _Psum.apply(x, grp)


def pmax(x: torch.Tensor, grp=None) -> torch.Tensor:
    """Max over the TP axis (or over ``grp``), with no gradient: it only
    ever shifts a softmax, whose value it leaves as it is."""
    if grp is None:
        if _TP_AXIS is None:
            return x
        grp = _TP_GROUP
    return _reduced(x, dist.ReduceOp.MAX, grp)


def all_gather_last(x: torch.Tensor) -> torch.Tensor:
    """Concatenate the ranks' shards along the last dim, in rank order."""
    if _TP_AXIS is None:
        return x
    return _GatherLast.apply(x, _TP_GROUP, _TP_EXTENT)


# ====================================================== the data axis =====
# Bound by ``trainer.mesh_loss_and_grads`` around a data rank's forward:
# the few places where JAX's GSPMD step computes over the *global* batch
# (the MoE router's load-balance statistics and the dispatch's overflow
# into the next batch row) reduce or hand on across the data ranks.
_DATA_EXTENT: int = 1
_DATA_GROUP = None
_DATA_BATCH: bool = True


@contextlib.contextmanager
def data_ctx(n: int, group, *, batch: bool = True):
    """Scope the data axis of a mesh: ``n`` data ranks in ``group``, the
    mesh's data group (``None`` only at ``n <= 1``, the identity).
    ``batch``: the ranks hold disjoint blocks of the global batch (the
    train step; a cell whose batch the data axis divides); False: each
    holds all of it (a batch of one row), so the router's statistics and
    the overflow stay the rank's own, while the experts are still spread
    over the ranks."""
    global _DATA_EXTENT, _DATA_GROUP, _DATA_BATCH
    prev = (_DATA_EXTENT, _DATA_GROUP, _DATA_BATCH)
    n = int(n)
    if n > 1 and group is None:
        # psum(x, None) would reduce over the model group, not the data's
        raise ValueError(f"tp.data_ctx({n}): give the mesh's data group")
    if n > 1 and _group_size(group) != n:
        raise ValueError(f"tp.data_ctx({n}): the process group holds "
                         f"{_group_size(group)} ranks")
    _DATA_EXTENT, _DATA_GROUP = (n, group) if n > 1 else (1, None)
    _DATA_BATCH = bool(batch)
    try:
        yield
    finally:
        _DATA_EXTENT, _DATA_GROUP, _DATA_BATCH = prev


def data_extent() -> int:
    """Number of data ranks (1 outside a data region)."""
    return _DATA_EXTENT


def data_index() -> int:
    """This rank's position along the data axis (0 outside a region)."""
    return 0 if _DATA_EXTENT == 1 else _group_rank(_DATA_GROUP)


def data_splits_batch() -> bool:
    """Whether the data ranks hold disjoint blocks of one global batch
    (false outside a data region)."""
    return _DATA_EXTENT > 1 and _DATA_BATCH


def data_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the data ranks of equal-sized shards' ``x`` (a psum
    over ``n``, its backward a psum); identity outside a data region or
    where every rank holds the whole batch."""
    if not data_splits_batch():
        return x
    return psum(x, _DATA_GROUP) / _DATA_EXTENT


class _FromPrevious(torch.autograd.Function):
    """Each rank gets the previous rank's tensor (rank 0 zeros); the
    gradient goes back the other way (the last rank's is dropped)."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return _neighbour(x.detach(), grp, -1)

    @staticmethod
    def backward(ctx, g):
        return _neighbour(g, ctx.grp, +1), None


def _neighbour(x: torch.Tensor, grp, step: int) -> torch.Tensor:
    n, i = _group_size(grp), _group_rank(grp)
    recorded = _records(grp)
    if recorded:
        _recorded("all-gather", x, grp, n * _nbytes(x))
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    if not recorded:
        dist.all_gather(parts, x, group=grp)
    j = i + step
    return parts[j] if 0 <= j < n else torch.zeros_like(x)


def from_previous_data_rank(x: torch.Tensor) -> torch.Tensor:
    """Inside a data region, the previous data rank's ``x`` (zeros on data
    rank 0), with its gradient sent back to that rank."""
    return _FromPrevious.apply(x, _DATA_GROUP)


# ===================================================== ZeRO-3 and experts ==
def _gather_dim(x: torch.Tensor, grp, dim: int) -> torch.Tensor:
    """The group's ``x`` concatenated on ``dim`` in rank order."""
    n = _group_size(grp)
    recorded = _records(grp)
    if recorded:
        _recorded("all-gather", x, grp, n * _nbytes(x))
    x = x.detach().movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    if not recorded:
        dist.all_gather_into_tensor(out, x, group=grp)
    return out if dim == 0 else out.movedim(0, dim).contiguous()


def _scatter_dim(x: torch.Tensor, grp, dim: int) -> torch.Tensor:
    """This rank's block on ``dim`` of the group's sum of ``x``."""
    n = _group_size(grp)
    x = x.detach().movedim(dim, 0).contiguous()
    if x.shape[0] % n:
        raise ValueError(f"tp: a reduce-scatter of {x.shape[0]} rows over "
                         f"{n} ranks")
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    if _records(grp):
        _recorded("reduce-scatter", x, grp, _nbytes(out))
    else:
        dist.reduce_scatter_tensor(out, x, group=grp)
    return out if dim == 0 else out.movedim(0, dim).contiguous()


class _GatherDim(torch.autograd.Function):
    """All-gather on ``dim``; backward reduce-scatters the gradient (each
    rank's use of the gathered tensor summed, this rank's block kept)."""

    @staticmethod
    def forward(ctx, x, grp, dim):
        ctx.grp, ctx.dim = grp, dim
        return _gather_dim(x, grp, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_dim(g, ctx.grp, ctx.dim), None, None


class _ScatterDim(torch.autograd.Function):
    """Reduce-scatter on ``dim``; backward all-gathers the gradient."""

    @staticmethod
    def forward(ctx, x, grp, dim):
        ctx.grp, ctx.dim = grp, dim
        return _scatter_dim(x, grp, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.grp, ctx.dim), None, None


def _exchange(x: torch.Tensor, grp) -> torch.Tensor:
    """All-to-all on dim 0: block ``j`` of ``x`` goes to rank ``j``, and
    block ``i`` of the result came from rank ``i``."""
    recorded = _records(grp)
    if recorded:
        _recorded("all-to-all", x, grp, _nbytes(x))
    x = x.detach().contiguous()
    out = torch.empty_like(x)
    if not recorded:
        dist.all_to_all_single(out, x, group=grp)
    return out


class _AllToAll(torch.autograd.Function):
    """:func:`_exchange`, which is its own adjoint: the gradient goes back
    the way it came."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return _exchange(x, grp)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.grp), None


def gather(x: torch.Tensor, grp, dim: int) -> torch.Tensor:
    """The ranks of ``grp``'s ``x`` concatenated on ``dim`` in rank order,
    the gradient reduce-scattered back (context-parallel attention's keys,
    values and output over the sequence)."""
    return _GatherDim.apply(x, grp, dim)


def gather_data(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The data ranks' ``x`` concatenated on ``dim`` (its gradient
    reduce-scattered back); identity outside a data region."""
    if _DATA_EXTENT == 1:
        return x
    return _GatherDim.apply(x, _DATA_GROUP, dim)


def scatter_data(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This data rank's block on ``dim`` of the data ranks' sum of ``x``
    (its gradient all-gathered back); identity outside a data region."""
    if _DATA_EXTENT == 1:
        return x
    return _ScatterDim.apply(x, _DATA_GROUP, dim)


def exchange_data(x: torch.Tensor) -> torch.Tensor:
    """All-to-all over the data ranks on dim 0 (expert parallelism's
    dispatch and return); identity outside a data region."""
    if _DATA_EXTENT == 1:
        return x
    return _AllToAll.apply(x, _DATA_GROUP)


# a sharding.MeshPlan bound by mesh_ctx: what gathered() gathers
_MESH_PLAN = None


@contextlib.contextmanager
def mesh_ctx(mesh, plan, *, batch: bool = True):
    """Bind a bound (or recorded) ``(data, model)`` mesh around a rank's
    forward: its model group as the TP axis (:func:`axis_ctx`), its data
    group as the data axis (:func:`data_ctx`, ``batch`` as there) and
    ``plan`` (a ``sharding.MeshPlan`` of the params this rank holds, or
    None: every leaf whole) for :func:`gathered`."""
    global _MESH_PLAN
    d, m = mesh.shape.get("data", 1), mesh.shape.get("model", 1)
    if plan is not None and (plan.data, plan.model) != (d, m):
        raise ValueError(f"tp.mesh_ctx: a plan of {plan.data}x{plan.model} "
                         f"on a {d}x{m} mesh")
    prev = _MESH_PLAN
    with axis_ctx("model", m, group=mesh.group("model") if m > 1 else None), \
            data_ctx(d, mesh.group("data") if d > 1 else None, batch=batch):
        _MESH_PLAN = plan
        try:
            yield
        finally:
            _MESH_PLAN = prev


def gathered(tree, prefix: str, *, stacked: bool = False):
    """``tree``, the params under the checkpoint key ``prefix`` (one block
    of a stacked tree where ``stacked``: its leading dim gone), as the
    layer code takes them inside :func:`mesh_ctx`: a leaf the bound plan
    splits over data is all-gathered over data (ZeRO-3; not the experts,
    which stay a rank's own), and a ``gather_model`` leaf all-gathered
    over model and cut by its rule.  Each gather's backward
    reduce-scatters the gradient.  The identity outside :func:`mesh_ctx`
    or where no leaf needs a gather.  Call it inside the region that
    ``torch.utils.checkpoint`` recomputes, so that the backward gathers
    again and a block's whole weights do not outlive the block."""
    plan = _MESH_PLAN
    if plan is None:
        return tree
    off = 1 if stacked else 0

    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, f"{key}/{k}") for k, v in node.items()}
        pl = plan.flat.get(key)
        if pl is None:
            raise KeyError(f"tp.gathered: {key} is not in the mesh plan")
        need_data = pl.data_dim is not None and not pl.experts
        if not (need_data or pl.gather_model):
            return node
        if qcore.is_quantized(node):
            raise ValueError(f"tp.gathered: {key} is int8; int8 leaves "
                             "stay on the model axis (serving only)")
        x = node
        if need_data:
            x = _GatherDim.apply(x, _DATA_GROUP, pl.data_dim - off)
        if pl.gather_model:
            x = _GatherDim.apply(x, _TP_GROUP, pl.model_dim - off)
            if pl.rule is not None:
                rule = dataclasses.replace(
                    pl.rule, dim=pl.rule.dim - off if pl.rule.dim >= 0
                    else pl.rule.dim)
                x = rule.slice(x, index(), _TP_EXTENT)
        return x
    return walk(tree, prefix)


# ======================================================== slicing rules ===
def _concat(parts, dim: int):
    if isinstance(parts[0], np.ndarray):
        return np.concatenate(parts, axis=dim)
    return torch.cat(parts, dim=dim)


def _own(a):
    """A contiguous copy that owns its memory (the full array can go)."""
    if isinstance(a, np.ndarray):
        return np.ascontiguousarray(a)
    return a.contiguous().clone()


@dataclasses.dataclass(frozen=True)
class Segments:
    """Slicing rule for one parameter dim made of packed segments.

    ``parts`` is ``((width, sharded), ...)`` covering ``dim`` end to end.
    A plain column or row shard is one ``(width, True)`` part; the Mamba-2
    ``in_proj`` output dim is ``[z x B C dt]`` with z/x/dt sharded by heads
    and the one-group B/C replicated on every shard.  ``slice`` and
    ``unslice`` are exact inverses (numpy arrays or tensors), so the
    converter and the reassembling reader share one layout."""
    dim: int
    parts: tuple[tuple[int, bool], ...]

    @classmethod
    def plain(cls, dim: int, width: int) -> "Segments":
        return cls(dim=dim, parts=((width, True),))

    def local_width(self, n: int) -> int:
        return sum(w // n if sh else w for w, sh in self.parts)

    def _index(self, arr_ndim: int, lo: int, hi: int):
        d = self.dim % arr_ndim
        return (slice(None),) * d + (slice(lo, hi),)

    def validate(self, shape, n: int, name: str = "?") -> None:
        d = self.dim % len(shape)
        total = sum(w for w, _ in self.parts)
        if shape[d] != total:
            raise ValueError(
                f"{name}: dim {d} has {shape[d]} features, slicing rule "
                f"covers {total}")
        for w, sh in self.parts:
            if sh and w % n:
                raise ValueError(
                    f"{name}: segment of width {w} not divisible by "
                    f"tp={n}")

    def slice(self, arr, i: int, n: int):
        """Shard ``i`` of ``n`` (a view where it is one segment)."""
        segs, off = [], 0
        for w, sh in self.parts:
            if sh:
                lw = w // n
                lo = off + i * lw
                segs.append(arr[self._index(arr.ndim, lo, lo + lw)])
            else:
                segs.append(arr[self._index(arr.ndim, off, off + w)])
            off += w
        if len(segs) == 1:
            return segs[0]
        return _concat(segs, self.dim % arr.ndim)

    def unslice(self, shards):
        """The full array from the shards' locals, bit for bit."""
        n = len(shards)
        d = self.dim % shards[0].ndim
        segs, off = [], 0
        for w, sh in self.parts:
            if sh:
                lw = w // n
                segs.extend(s[self._index(s.ndim, off, off + lw)]
                            for s in shards)
                off += lw
            else:
                segs.append(shards[0][self._index(shards[0].ndim,
                                                  off, off + w)])
                off += w
        if len(segs) == 1:
            return segs[0]
        return _concat(segs, d)

    def to_json(self):
        return {"dim": self.dim, "parts": [[w, bool(sh)]
                                           for w, sh in self.parts]}

    @classmethod
    def from_json(cls, obj) -> Optional["Segments"]:
        if obj is None or obj == "replicated":
            return None
        return cls(dim=int(obj["dim"]),
                   parts=tuple((int(w), bool(sh)) for w, sh in obj["parts"]))


def rule_to_json(rule: Optional[Segments]):
    return "replicated" if rule is None else rule.to_json()


def scale_rule(rule: Optional[Segments], payload_ndim: int
               ) -> Optional[Segments]:
    """Slicing rule for a QuantizedTensor's per-channel ``scale``.

    Scales run along the payload's last axis: column-parallel weights
    (sliced on the last dim) slice their scales the same way; row-parallel
    ones (sliced on an input dim) replicate them.  ``dim=-1`` covers the
    plain ``(C,)`` scale and the stacked ``(*stack, C)`` one."""
    if rule is None or rule.dim % payload_ndim != payload_ndim - 1:
        return None
    return Segments(dim=-1, parts=rule.parts)


# ========================================================== plan builder ==
def _flatten_with_keys(tree, is_leaf=None, prefix=()):
    """``(key, names, leaf)`` in JAX's flatten order: dict keys sorted,
    lists and tuples by index (a tuple is a leaf where ``is_leaf`` says)."""
    if is_leaf is not None and is_leaf(tree):
        return [("/".join(prefix), list(prefix), tree)]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_keys(tree[k], is_leaf,
                                             prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten_with_keys(v, is_leaf, prefix + (str(i),))]
    return [("/".join(prefix), list(prefix), tree)]


def _unflatten_like(tree, leaves_by_key: dict, prefix=()):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, leaves_by_key, prefix + (str(k),))
                for k, v in tree.items()}
    return leaves_by_key["/".join(prefix)]


def _maps_to(rules: dict, logical: Optional[str], tp_axis: str) -> bool:
    if not logical:
        return False
    mapped = rules.get(logical)
    if mapped is None:
        return False
    mapped = (mapped,) if isinstance(mapped, str) else tuple(mapped)
    return tp_axis in mapped


# segment layouts of the Mamba-2 packed projections (see models/mamba2.py):
#   in_proj out dim  = [z (di) | x (di) | B (ds) | C (ds) | dt (nh)]
#   conv_w/conv_b    = [x (di) | B (ds) | C (ds)]
# z/x/dt shard with the heads; the one-group B/C stay on every shard.
def _mamba_segments(key: str, cfg) -> Optional[list[tuple[int, bool]]]:
    di, ds, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    if key == "in_proj":
        return [(di, True), (di, True), (ds, False), (ds, False), (nh, True)]
    if key in ("conv_w", "conv_b"):
        return [(di, True), (ds, False), (ds, False)]
    return None


@dataclasses.dataclass(frozen=True)
class Plan:
    """Per-leaf slicing rules for one (model config, tp degree) pair."""
    tp: int
    axis: str
    rules: Any                            # tree: Segments | None per leaf
    flat: dict[str, Optional[Segments]]   # checkpoint key -> rule

    def flat_json(self) -> dict:
        return {k: rule_to_json(r) for k, r in self.flat.items()}


def default_tp_rules() -> dict[str, Any]:
    """The logical-to-mesh mapping when no mesh is at hand (the offline
    converter); ``sharding.default_rules``' model-axis entries."""
    return {"vocab": "model", "heads": "model", "kv_heads": "model",
            "mlp": "model", "ssm_inner": "model", "ssm_heads": "model"}


def build_plan(axes_tree, shapes_tree, *, cfg, tp: int, axis: str = "model",
               rules: Optional[dict] = None, experts: bool = False) -> Plan:
    """Give every parameter leaf a slicing rule (or None, replicated).

    ``axes_tree``/``shapes_tree`` come from ``model.abstract_params(cfg)``
    (meta tensors: shapes only); ``rules`` is the logical-to-mesh mapping
    (``sharding.default_rules(mesh)`` at serve time,
    :func:`default_tp_rules` offline).  A model-mapped dim that ``tp`` does
    not divide is an error naming the parameter, except the vocab, which
    falls back to a replicated embedding.  JAX's serving plan keeps the
    MoE layer whole; ``experts=True`` (the mesh plan's,
    ``sharding.mesh_plan``) slices its ``mlp`` over the model axis too.

    Under an ``act_seq`` rule that maps to ``axis`` (JAX's context
    parallelism, where the heads do not divide the model axis) attention
    computes with whole heads on every rank (``attention.attention_block``
    splits the query sequence instead): its ``heads``/``kv_heads`` leaves
    get no rule, and the head counts need not divide ``tp``."""
    tp = int(tp)
    if tp < 1:
        raise ValueError(f"tp={tp}")
    rules = default_tp_rules() if rules is None else rules
    context_parallel = _maps_to(rules, "act_seq", axis)

    # config-level divisibility first: clearer than the per-leaf check
    # (kv_dim may divide while kv_heads do not, and the decode reshape
    # would then mix heads across shards)
    problems = []
    has_attn = any(s.mixer == "attn" for s in cfg.block_pattern)
    has_mamba = any(s.mixer == "mamba" for s in cfg.block_pattern)
    if tp > 1 and has_attn and not context_parallel:
        if cfg.num_heads % tp:
            problems.append(f"num_heads={cfg.num_heads}")
        if cfg.num_kv_heads % tp:
            problems.append(f"num_kv_heads={cfg.num_kv_heads}")
    if tp > 1 and cfg.d_ff % tp and any(s.ff for s in cfg.block_pattern):
        problems.append(f"d_ff={cfg.d_ff}")
    if tp > 1 and has_mamba and cfg.ssm_heads % tp:
        problems.append(f"ssm_heads={cfg.ssm_heads}")
    if problems:
        raise ValueError(
            f"model '{cfg.name}' cannot shard over tp={tp}: "
            + ", ".join(problems) + " not divisible")

    shape_items = _flatten_with_keys(shapes_tree)
    axes_by_key = {k: leaf for k, _, leaf in _flatten_with_keys(
        axes_tree, is_leaf=lambda x: isinstance(x, tuple))}

    if context_parallel:
        # whole heads: the attention leaves' head dims take no rule
        rules = {**rules, "heads": None, "kv_heads": None}
    flat: dict[str, Optional[Segments]] = {}
    for key, names, like in shape_items:
        rule = _leaf_rule(names, tuple(like.shape), axes_by_key.get(key),
                          cfg, tp, axis, rules, experts)
        if rule is not None:
            rule.validate(tuple(like.shape), tp, name=key)
        flat[key] = rule
    return Plan(tp=tp, axis=axis, rules=_unflatten_like(shapes_tree, flat),
                flat=flat)


def _leaf_rule(names, shape, axes, cfg, tp, tp_axis, rules, experts=False
               ) -> Optional[Segments]:
    if tp == 1:
        return None
    # JAX's serving plan keeps the MoE layer whole on every model rank
    # (moe() computes with full weights); the mesh plan slices its mlp
    if "moe" in names and not experts:
        return None
    key = names[-1] if names else ""
    if "mamba" in names:
        segs = _mamba_segments(key, cfg)
        if segs is not None:
            return Segments(dim=len(shape) - 1, parts=tuple(segs))
    if axes is None:
        return None
    for i, logical in enumerate(axes):
        if not _maps_to(rules, logical, tp_axis):
            continue
        if shape[i] % tp:
            if logical == "vocab":
                return None  # replicated-embedding fallback (odd vocabs)
            raise ValueError(
                f"{'/'.join(names)}: dim {i} ({logical}={shape[i]}) not "
                f"divisible by tp={tp}")
        return Segments.plain(i, shape[i])
    return None


# ============================================================ placement ===
def _map_with_rules(plan: Plan, params, fn):
    def walk(rules, leaf):
        if isinstance(rules, dict):
            return {k: walk(rules[k], leaf[k]) for k in rules}
        return fn(rules, leaf)
    return walk(plan.rules, params)


def _keep(rule: Optional[Segments], full, rank: int, tp: int, device):
    if rule is None:
        return full.to(device)
    fabric.record("tp.load.replicated_slice")
    return _own(rule.slice(full, rank, tp)).to(device)


def mesh_coords(rank: int, plan) -> tuple[int, int]:
    """``(data, model)`` coordinates of mesh rank ``rank`` (row-major, as
    ``launch.mesh`` lays ranks out)."""
    return divmod(int(rank), plan.model)


def _mesh_block(x, dim: Optional[int], i: int, n: int):
    if dim is None:
        return x
    size = x.shape[dim] // n
    if isinstance(x, np.ndarray):
        return x[(slice(None),) * dim + (slice(i * size, (i + 1) * size),)]
    return x.narrow(dim, i * size, size)


def mesh_local(pl, full, di: int, mi: int, data: int, model: int):
    """Rank ``(di, mi)``'s block of a whole leaf placed by ``pl`` (a
    ``sharding.Placement``; a view where it is one block)."""
    return _mesh_block(_mesh_block(full, pl.data_dim, di, data),
                       pl.model_dim, mi, model)


def mesh_unshard(parts: list, data_dim, model_dim, data: int, model: int):
    """The whole leaf from the mesh ranks' blocks in rank order (the
    inverse of :func:`mesh_local`, bit for bit)."""
    rows = []
    for di in range(data):
        row = parts[di * model:(di + 1) * model]
        rows.append(row[0] if model_dim is None else _concat(row, model_dim))
    return rows[0] if data_dim is None else _concat(rows, data_dim)


def assemble(plan, parts: list) -> dict:
    """The whole flat tree (params keys, or a train state's) from the
    ranks' flat dicts of their blocks, in rank order, by ``plan`` (a
    ``sharding.MeshPlan``)."""
    out = {}
    for key in parts[0]:
        pl = plan.placement(key)
        arrs = [p[key] for p in parts]
        out[key] = (arrs[0] if pl is None or pl.whole else mesh_unshard(
            arrs, pl.data_dim, pl.model_dim, plan.data, plan.model))
    return out


def _partition_mesh(params, plan, rank: int, device):
    di, mi = mesh_coords(rank, plan)

    def one(key, leaf):
        pl = plan.flat[key]
        dev = leaf.device if device is None else device
        if qcore.is_quantized(leaf):
            raise ValueError(f"{key}: int8 leaves stay on the model axis "
                             "(tp.build_plan's serving plan)")
        if pl.whole:
            return leaf.to(dev)
        fabric.record("tp.load.replicated_slice")
        return _own(mesh_local(pl, leaf, di, mi, plan.data,
                               plan.model)).to(dev)
    flat = {k: one(k, v) for k, _, v in _flatten_with_keys(params)}
    return _unflatten_like(params, flat)


def partition_params(params, plan, *, rank: int, device=None):
    """This rank's slice of a full params tree (the migration path, and
    the fresh-init one): every sharded leaf is cut to its local block,
    copied so the full weight can be freed, and counted
    ``tp.load.replicated_slice``; replicated leaves pass through.
    QuantizedTensor leaves slice payload and per-channel scales along the
    same axis.  ``rank`` is this process's position in the group (a
    ``sharding.MeshPlan``: its rank on the (data, model) mesh, row-major);
    ``device`` defaults to each leaf's own."""
    from repro_torch.distributed.sharding import MeshPlan
    if isinstance(plan, MeshPlan):
        return _partition_mesh(params, plan, int(rank), device)
    rank = int(rank)
    tp = plan.tp

    def one(rule, leaf):
        dev = leaf.device if device is None else device
        if qcore.is_quantized(leaf):
            return qcore.QuantizedTensor(
                _keep(rule, leaf.q, rank, tp, dev),
                _keep(scale_rule(rule, leaf.q.dim()), leaf.scale, rank, tp,
                      dev),
                leaf.axis,
                None if leaf.act_scale is None else leaf.act_scale.to(dev))
        return _keep(rule, leaf, rank, tp, dev)

    return _map_with_rules(plan, params, one)


def load_sharded_params(ckpt_dir: str, plan: Plan, *,
                        step: Optional[int] = None, rank: int,
                        device="cpu"):
    """Pre-partitioned load from a ``format: "sharded"`` checkpoint: this
    rank reads only its own ``shard_<k>.npz``, whose leaves the converter
    already cut (payload and per-channel scales), and puts them on
    ``device``: no full weight is ever read or built.  The manifest's
    ``shard_info`` must match ``plan``: a checkpoint converted for another
    tp degree or layout raises, it is never re-sliced."""
    from repro_torch.train import checkpoint as ck
    rank = int(rank)
    tp = plan.tp
    manifest, _ = ck._read_manifest(ckpt_dir, step)
    if manifest.get("format") != "sharded":
        raise ValueError(f"checkpoint under {ckpt_dir} has format "
                         f"{manifest.get('format')!r}, expected 'sharded'")
    if int(manifest["num_shards"]) != tp:
        raise ValueError(
            f"checkpoint has {manifest['num_shards']} shards, mesh wants "
            f"tp={tp} — re-run the converter for this mesh")
    manifest, shard = ck.read_shard(ckpt_dir, rank, step=manifest["step"])
    shard_info = manifest["shard_info"]

    def put(key: str, want: Optional[Segments]):
        got = Segments.from_json(shard_info.get(key, "replicated"))
        if rule_to_json(got) != rule_to_json(want):
            raise ValueError(
                f"{key}: checkpoint sliced as {rule_to_json(got)}, plan "
                f"wants {rule_to_json(want)} — re-shard the checkpoint")
        arr = shard[key]
        if got is None:
            fabric.record("tp.load.replicated")
            return arr.to(device)
        width = arr.shape[got.dim % arr.dim()]
        if width != got.local_width(tp):
            raise ValueError(f"{key}: shard {rank} holds {width} of "
                             f"{sum(w for w, _ in got.parts)} features, "
                             f"expected {got.local_width(tp)}")
        fabric.record("tp.load.pre_partitioned")
        return arr.to(device)

    keys = set(manifest["keys"])
    tree: dict = {}
    for stem, want in plan.flat.items():
        if stem in keys:
            leaf = put(stem, want)
        elif stem + "/0" in keys:  # QuantizedTensor children (q, scale[, act])
            qs = manifest["shapes"][stem + "/0"]
            leaf = qcore.QuantizedTensor(
                put(stem + "/0", want),
                put(stem + "/1", scale_rule(want, len(qs))),
                # -1, not ndim - 1: channel-last also for a stacked payload
                -1 if len(manifest["shapes"][stem + "/1"]) else None,
                put(stem + "/2", None) if stem + "/2" in keys else None)
        else:
            raise KeyError(f"checkpoint is missing parameter '{stem}'")
        node = tree
        parts = stem.split("/")
        for name in parts[:-1]:
            node = node.setdefault(name, {})
        node[parts[-1]] = leaf
    return tree


def shard_state(flat: dict, plan: Plan, *, prefix: str = ""
                ) -> tuple[list[dict], dict]:
    """Slice a flat ``{checkpoint_key: array}`` state (numpy arrays or
    tensors) into per-shard flat dicts and the manifest's ``shard_info``:
    the converter's core.

    Keys resolve against ``plan.flat`` directly, or with ``prefix/``
    stripped.  QuantizedTensor children (``<stem>/0`` payload, ``/1``
    scales, ``/2`` act scale) slice by the stem's rule: the payload as the
    float weight would, per-channel scales along the same axis, the act
    scale replicated.  Unknown keys (optimizer state, step counters)
    replicate."""
    def stem_rule(key: str):
        cand = [key]
        if prefix and key.startswith(prefix + "/"):
            cand.append(key[len(prefix) + 1:])
        for k in cand:
            if k in plan.flat:
                return plan.flat[k], "leaf"
            base, _, child = k.rpartition("/")
            if child in ("0", "1", "2") and base in plan.flat:
                return plan.flat[base], child
        return None, "unknown"

    shards: list[dict] = [dict() for _ in range(plan.tp)]
    info: dict = {}
    for key, arr in flat.items():
        rule, kind = stem_rule(key)
        if kind == "1":
            # per-channel scale: sliced along its last dim iff the
            # payload's rule shards the payload's last dim
            payload = flat.get(key[:-1] + "0")
            pnd = payload.ndim if payload is not None else arr.ndim + 1
            rule = scale_rule(rule, pnd)
        elif kind in ("2", "unknown"):
            rule = None  # act scale / optimizer state / counters
        if rule is not None and (arr.ndim == 0 or arr.shape[
                rule.dim % arr.ndim] != sum(w for w, _ in rule.parts)):
            rule = None  # per-tensor scale / mismatched aux leaf
        info[key] = rule_to_json(rule)
        for m in range(plan.tp):
            shards[m][key] = (arr if rule is None
                              else _own(rule.slice(arr, m, plan.tp)))
    return shards, info


# ============================================================ gradients ===
def all_reduce_flat(tensors: list, grp, *, op=None) -> None:
    """All-reduce ``tensors`` in place as one flat buffer per dtype (one
    collective each, not one a tensor)."""
    op = dist.ReduceOp.SUM if op is None else op
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        buf = torch.cat([t.reshape(-1) for t in ts])
        if _records(grp):
            _recorded("all-reduce", buf, grp, _nbytes(buf))
        else:
            dist.all_reduce(buf, op=op, group=grp)
        off = 0
        for t in ts:
            t.copy_(buf[off: off + t.numel()].view(t.shape))
            off += t.numel()


def _pspec(rule: Optional[Segments], axis_name: str, ndim: int) -> tuple:
    if rule is None:
        return ()
    return (None,) * (rule.dim % ndim) + (axis_name,)


def param_pspecs(plan: Plan, params):
    """Each leaf's mesh axes in JAX's ``PartitionSpec`` order, as a tuple
    (``()`` replicated, ``(None, "model")`` split on dim 1); a
    QuantizedTensor's payload, scale and act scale each have theirs."""
    def one(rule, leaf):
        if qcore.is_quantized(leaf):
            return qcore.QuantizedTensor(
                _pspec(rule, plan.axis, leaf.q.dim()),
                _pspec(scale_rule(rule, leaf.q.dim()), plan.axis,
                       leaf.scale.dim()),
                leaf.axis, None if leaf.act_scale is None else ())
        return _pspec(rule, plan.axis, leaf.dim())
    return _map_with_rules(plan, params, one)


def reduce_mesh_grads(grads, plan, mesh, extra=()) -> None:
    """After a mesh rank's backward, in place: each leaf the model ranks
    all hold whole (``model_dim`` None) summed over the model group (the
    ranks' shares, see the module docstring); each leaf the data ranks all
    hold whole, and the tensors of ``extra`` (the loss), summed over the
    data group; then everything divided by the data extent (the mean of
    the ranks' means).  A leaf split over an axis came back summed over
    it from its gather's reduce-scatter (ZeRO-3), or from the experts'
    all-to-all.  ``plan`` None: every leaf whole."""
    d, m = mesh.shape.get("data", 1), mesh.shape.get("model", 1)
    items = [(None if plan is None else plan.flat[k], g)
             for k, _, g in _flatten_with_keys(grads)]
    if m > 1:
        all_reduce_flat([g for pl, g in items
                         if pl is None or pl.model_dim is None],
                        mesh.group("model"))
    if d > 1:
        all_reduce_flat([g for pl, g in items
                         if pl is None or pl.data_dim is None]
                        + list(extra), mesh.group("data"))
        for g in [g for _, g in items] + list(extra):
            g.div_(d)


def mesh_grad_norm_sq(grads, plan, mesh) -> torch.Tensor:
    """The squared global norm (float32) of a mesh rank's gradients: each
    split leaf's squares summed over the groups that split it, each whole
    one counted once, so that every rank clips by one device's scale."""
    d, m = mesh.shape.get("data", 1), mesh.shape.get("model", 1)
    sums = {}
    dev = None
    for k, _, g in _flatten_with_keys(grads):
        pl = None if plan is None else plan.flat[k]
        split = (pl is not None and pl.data_dim is not None,
                 pl is not None and pl.model_dim is not None)
        sq = torch.sum(torch.square(g.float()))
        sums[split] = sums.get(split, 0) + sq
        dev = g.device

    def get(key):
        v = sums.get(key)
        return (torch.zeros((), dtype=torch.float32, device=dev) if v is None
                else v.reshape(()))
    # [both, data only] over data, then (both + model only) over model;
    # an axis that splits no leaf takes no collective
    by_data = torch.stack([get((True, True)), get((True, False))])
    if d > 1 and ((True, True) in sums or (True, False) in sums):
        all_reduce_flat([by_data], mesh.group("data"))
    by_model = by_data[0] + get((False, True))
    if m > 1 and ((True, True) in sums or (False, True) in sums):
        all_reduce_flat([by_model], mesh.group("model"))
    return by_model + by_data[1] + get((False, False))


def state_shard_info(plan, flat: dict) -> dict:
    """A train state's ``shard_info`` by a ``sharding.MeshPlan``: each
    flat key's placement (``Placement.to_json``; the moments as their
    params), the step counter and unknown keys replicated."""
    return {key: ("replicated" if plan.placement(key) is None
                  else plan.placement(key).to_json(plan.data, plan.model))
            for key in flat}
