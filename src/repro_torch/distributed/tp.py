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
  backward :func:`reduce_replicated_grads` sums every replicated leaf's
  and replicated segment's gradient over the group.  One rule serves
  every place a replicated tensor meets rank-local work: the column-
  parallel inputs, the qk-norm scales, Mamba-2's one-group B/C columns,
  the gated RMSNorm's sum of squares.

* **the data axis**: :func:`data_ctx` binds a mesh's data group around a
  data rank's forward (``trainer.mesh_loss_and_grads``), for the two
  places where JAX's step computes over the global batch, both in the
  MoE layer: :func:`data_mean` averages the router's statistics over the
  data ranks, and :func:`from_previous_data_rank` hands the dispatch's
  last-row overflow on to the next rank (its gradient back).

* **slicing plan**: :func:`build_plan` gives each parameter leaf a
  :class:`Segments` rule (or ``None``, replicated) through the same
  logical-to-mesh rules ``sharding.logical_spec`` reads.

* **placement**: :func:`partition_params` keeps this rank's slice of a
  full tree (counted ``tp.load.replicated_slice``);
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
    collectives are recorded, never run."""
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
    group size)`` the collectives append: ``op`` is ``all-reduce`` or
    ``all-gather``, ``bytes`` the result's bytes on this rank.  Only meta
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
    Its gradient is the psum of the ranks' gradients (see
    :func:`reduce_replicated_grads` for the convention)."""
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


@contextlib.contextmanager
def data_ctx(n: int, group):
    """Scope the data axis of a mesh: ``n`` data ranks in ``group``, the
    mesh's data group (``None`` only at ``n <= 1``, the identity)."""
    global _DATA_EXTENT, _DATA_GROUP
    prev = (_DATA_EXTENT, _DATA_GROUP)
    n = int(n)
    if n > 1 and group is None:
        # psum(x, None) would reduce over the model group, not the data's
        raise ValueError(f"tp.data_ctx({n}): give the mesh's data group")
    if n > 1 and _group_size(group) != n:
        raise ValueError(f"tp.data_ctx({n}): the process group holds "
                         f"{_group_size(group)} ranks")
    _DATA_EXTENT, _DATA_GROUP = (n, group) if n > 1 else (1, None)
    try:
        yield
    finally:
        _DATA_EXTENT, _DATA_GROUP = prev


def data_extent() -> int:
    """Number of data ranks (1 outside a data region)."""
    return _DATA_EXTENT


def data_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the data ranks of equal-sized shards' ``x`` (a psum
    over ``n``, its backward a psum); identity outside a data region."""
    if _DATA_EXTENT == 1:
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
               rules: Optional[dict] = None) -> Plan:
    """Give every parameter leaf a slicing rule (or None, replicated).

    ``axes_tree``/``shapes_tree`` come from ``model.abstract_params(cfg)``
    (meta tensors: shapes only); ``rules`` is the logical-to-mesh mapping
    (``sharding.default_rules(mesh)`` at serve time,
    :func:`default_tp_rules` offline).  A model-mapped dim that ``tp`` does
    not divide is an error naming the parameter, except the vocab, which
    falls back to a replicated embedding."""
    tp = int(tp)
    if tp < 1:
        raise ValueError(f"tp={tp}")
    rules = default_tp_rules() if rules is None else rules

    # config-level divisibility first: clearer than the per-leaf check
    # (kv_dim may divide while kv_heads do not, and the decode reshape
    # would then mix heads across shards)
    problems = []
    has_attn = any(s.mixer == "attn" for s in cfg.block_pattern)
    has_mamba = any(s.mixer == "mamba" for s in cfg.block_pattern)
    if tp > 1 and has_attn:
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

    flat: dict[str, Optional[Segments]] = {}
    for key, names, like in shape_items:
        rule = _leaf_rule(names, tuple(like.shape), axes_by_key.get(key),
                          cfg, tp, axis, rules)
        if rule is not None:
            rule.validate(tuple(like.shape), tp, name=key)
        flat[key] = rule
    return Plan(tp=tp, axis=axis, rules=_unflatten_like(shapes_tree, flat),
                flat=flat)


def _leaf_rule(names, shape, axes, cfg, tp, tp_axis, rules
               ) -> Optional[Segments]:
    if tp == 1:
        return None
    # MoE experts stay replicated under TP: expert parallelism covers them
    # on the data axis, and moe() computes with full weights
    if "moe" in names:
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


def partition_params(params, plan: Plan, *, rank: int, device=None):
    """This rank's slice of a full params tree (the migration path, and
    the fresh-init one): every sharded leaf is cut to its local block,
    copied so the full weight can be freed, and counted
    ``tp.load.replicated_slice``; replicated leaves pass through.
    QuantizedTensor leaves slice payload and per-channel scales along the
    same axis.  ``rank`` is this process's position in the group;
    ``device`` defaults to each leaf's own."""
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
def _local_parts(rule: Segments, n: int):
    """``(lo, hi, sharded)`` of each segment in a rank's local layout."""
    out, off = [], 0
    for w, sh in rule.parts:
        lw = w // n if sh else w
        out.append((off, off + lw, sh))
        off += lw
    return out


def _replicated_views(plan: Plan, tree) -> tuple[list, list]:
    """(replicated, sharded) views of a local tree's leaves: a replicated
    leaf whole, a sharded leaf's replicated and sharded segments as
    narrowed views of its dim."""
    rep, shd = [], []

    def one(rule, leaf):
        if rule is None:
            rep.append(leaf)
            return leaf
        d = rule.dim % leaf.dim()
        for lo, hi, sh in _local_parts(rule, plan.tp):
            (shd if sh else rep).append(leaf.narrow(d, lo, hi - lo))
        return leaf

    _map_with_rules(plan, tree, one)
    return rep, shd


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


def reduce_replicated_grads(grads, plan: Plan, grp=None) -> None:
    """Sum, over the model group, the gradient of every replicated leaf
    and replicated segment of ``grads`` (this rank's local tree), in place.
    Each rank holds its share of those (see the module docstring); the
    sharded segments' gradients are already whole."""
    rep, _ = _replicated_views(plan, grads)
    all_reduce_flat(rep, grp)


def grad_norm_sq(grads, plan: Plan, grp=None) -> torch.Tensor:
    """The squared global norm of a tensor-parallel tree (float32): the
    sharded segments' squares summed over the model group, the replicated
    ones counted once."""
    rep, shd = _replicated_views(plan, grads)

    dev = (rep + shd)[0].device

    def sq(ts):
        out = torch.zeros((), dtype=torch.float32, device=dev)
        for t in ts:
            out = out + torch.sum(torch.square(t.float()))
        return out
    shard_sq = sq(shd)
    if _records(grp):
        _recorded("all-reduce", shard_sq, grp, _nbytes(shard_sq))
    else:
        dist.all_reduce(shard_sq, group=grp)
    return shard_sq + sq(rep)


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


def state_shard_info(plan: Plan, flat: dict,
                     prefixes=("params", "opt/m", "opt/v")) -> dict:
    """A train state's ``shard_info``: each flat key's rule, its param's
    under any of ``prefixes`` (the moments shard as their params), the
    step counter and unknown keys replicated."""
    info = {}
    for key, arr in flat.items():
        rule = None
        for pre in prefixes:
            if key.startswith(pre + "/") and key[len(pre) + 1:] in plan.flat:
                rule = plan.flat[key[len(pre) + 1:]]
                break
        info[key] = rule_to_json(rule)
    return info
