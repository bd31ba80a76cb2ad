"""Logical-axis sharding rules (``repro/distributed/sharding.py``), the
part tensor parallelism reads.

Models tag every parameter with *logical* axis names (``ParamBuilder``);
this module maps them to mesh axes:

    "batch"  -> ("pod", "data")       # data parallel (pods included)
    "vocab"  -> "model"               # tensor-parallel vocab/embedding
    "heads"  -> "model"               # flattened q/kv projection outputs
    "mlp"    -> "model"               # FFN width
    "expert" -> "data"                # expert parallelism
    "embed"  -> ("pod", "data")|None  # FSDP (ZeRO-3) for large archs

``tp.build_plan`` reads the same table, so the explicit Megatron layout
and the logical specs cannot drift.  PyTorch has no GSPMD compiler to hand
a constraint to, so :func:`shard` is the identity and :func:`logical_spec`
returns the spec as a plain tuple (one entry per dim: a mesh axis, a tuple
of them, or None); :func:`spec_tree` maps it over a tree.  The ranks of a
(data, model) mesh do what GSPMD's shardings would
(``train.trainer.jit_train_step``), so JAX's ``param_shardings`` and
``shard_map_compat``, which build JAX objects, have no counterpart.

:func:`mesh_plan` places a params tree on a (data, model) mesh by those
specs (JAX's ``spec_tree`` of the train state): each leaf's
:class:`Placement` records the dim it splits over data and how (gathered
at use, ZeRO-3; or whole experts a data rank, expert parallelism), the
dim it splits over model, and the slice the layer code computes with on
the model axis (``tp.build_plan``'s rule, the experts' ``mlp`` included).
Where the stored split and that slice differ (Mamba-2's packed
``in_proj``, whose B/C columns every model rank needs) the leaf is
gathered over model at use and then sliced.  ``tp`` realises the plan:
``partition_params``, ``gathered``, ``mesh_ctx``.

A lane mesh (:func:`lane_mesh`, :class:`LaneMesh`) is JAX's 1-D device
mesh for the flowcell: devices of one process, each running a contiguous
block of the lanes (``realtime/runtime.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Optional

import torch


@dataclasses.dataclass
class ShardingContext:
    mesh: Any                 # launch.mesh.Mesh (a ``shape`` dict by name)
    rules: dict[str, Any]     # logical name -> mesh axis | tuple | None

    def axis_size(self, mesh_axes) -> int:
        if mesh_axes is None:
            return 1
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        return int(math.prod(self.mesh.shape[a] for a in mesh_axes))


_CTX: Optional[ShardingContext] = None


def data_axes(mesh) -> tuple[str, ...]:
    """All batch-parallel axes present in the mesh ('pod' first)."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def default_rules(mesh, *, fsdp: bool = False, expert_axis: bool = True,
                  overrides: dict[str, Any] | None = None) -> dict[str, Any]:
    d = data_axes(mesh)
    rules: dict[str, Any] = {
        "batch": d,
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "expert": "data" if expert_axis else None,
        "embed": d if fsdp else None,
        "ssm_inner": "model",
        "ssm_heads": "model",
        "ssm_state": None,
        "seq": None,
        "act_embed": None,
        "act_mlp": "model",
        "act_heads": "model",
        "act_seq": None,
        "act_heads_q": None,
        "moe_cap": "data",
        "kv_seq": None,
    }
    if overrides:
        rules.update(overrides)
    return rules


@contextlib.contextmanager
def use_sharding(mesh, rules: dict[str, Any]):
    global _CTX
    prev = _CTX
    _CTX = ShardingContext(mesh=mesh, rules=rules)
    try:
        yield _CTX
    finally:
        _CTX = prev


def active() -> Optional[ShardingContext]:
    return _CTX


def extent(logical_name: str) -> int:
    """Mesh extent a logical axis maps to (1 when inactive or unmapped)."""
    ctx = _CTX
    if ctx is None:
        return 1
    return ctx.axis_size(ctx.rules.get(logical_name))


def logical_spec(axes: tuple, shape: tuple | None = None) -> tuple:
    """Logical axis names as a spec under the active rules (JAX's
    ``PartitionSpec`` entries as a tuple, trailing Nones dropped): a dim a
    mesh extent does not divide stays unsharded, and a mesh axis is used
    once, by the first dim that asks for it."""
    ctx = _CTX
    if ctx is None:
        return ()
    used: set[str] = set()
    entries = []
    for i, name in enumerate(axes):
        mesh_axes = ctx.rules.get(name) if name else None
        if mesh_axes is None:
            entries.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        mesh_axes = tuple(a for a in mesh_axes
                          if a in ctx.mesh.shape and a not in used)
        if not mesh_axes:
            entries.append(None)
            continue
        axes_extent = int(math.prod(ctx.mesh.shape[a] for a in mesh_axes))
        if shape is not None and shape[i] % axes_extent != 0:
            entries.append(None)
            continue
        used.update(mesh_axes)
        entries.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def shard(x, *axes):
    """JAX's ``with_sharding_constraint`` by logical names: the identity
    (no GSPMD compiler to constrain)."""
    return x


def spec_tree(axes_tree, shape_tree):
    """:func:`logical_spec` of every leaf: ``axes_tree`` holds a tuple of
    logical names a leaf, ``shape_tree`` the leaves (or anything with a
    ``shape``)."""
    if isinstance(axes_tree, dict):
        return {k: spec_tree(a, shape_tree[k]) for k, a in axes_tree.items()}
    return logical_spec(axes_tree, tuple(shape_tree.shape))


# ============================================================ mesh plan ===
@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one leaf lives on a (data, model) mesh, by JAX's spec of it.
    ``data_dim`` splits evenly over the data ranks: whole experts a rank
    where ``experts`` (the layer exchanges tokens), else gathered over
    data at use (ZeRO-3).  ``model_dim``
    splits evenly over the model ranks; ``rule`` is the ``tp.Segments``
    the layer code computes with on the model axis (None: whole), and
    ``gather_model`` says that the stored split is not that slice, so the
    leaf is gathered over model at use and then cut by ``rule``."""
    data_dim: Optional[int] = None
    experts: bool = False
    model_dim: Optional[int] = None
    rule: Any = None
    gather_model: bool = False

    @property
    def whole(self) -> bool:
        return self.data_dim is None and self.model_dim is None

    def to_json(self, data: int, model: int):
        if self.whole:
            return "replicated"
        return {"mesh": [data, model], "data_dim": self.data_dim,
                "model_dim": self.model_dim}


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Every leaf's :class:`Placement` on a ``data`` x ``model`` mesh, by
    checkpoint key (``tp._flatten_with_keys`` of the params)."""
    data: int
    model: int
    flat: dict

    @property
    def sharded(self) -> bool:
        """Whether any rank holds less than a whole leaf."""
        return any(not p.whole for p in self.flat.values())

    def placement(self, key: str) -> Optional[Placement]:
        """A params key's placement, or a train state's (``params/...``,
        ``opt/m/...``, ``opt/v/...``: the moments as their params); None
        for the step counter and unknown keys (whole)."""
        if key in self.flat:
            return self.flat[key]
        for pre in ("params/", "opt/m/", "opt/v/"):
            if key.startswith(pre) and key[len(pre):] in self.flat:
                return self.flat[key[len(pre):]]
        return None


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_plan(axes_tree, shapes_tree, *, cfg, mesh, rules) -> MeshPlan:
    """The :class:`MeshPlan` of a params tree (``model.abstract_params``)
    on ``mesh`` (a layout or a bound mesh: only its ``shape`` is read)
    under ``rules`` (``launch.steps.make_rules``, or
    :func:`default_rules` with the arch's ``fsdp`` and overrides).  A
    spec the port cannot realise raises ``ValueError`` naming the leaf;
    the model axis's divisibility errors are ``tp.build_plan``'s."""
    from repro_torch.distributed import tp
    d, m = mesh.shape.get("data", 1), mesh.shape.get("model", 1)
    if set(mesh.shape) - {"data", "model"}:
        raise ValueError(f"mesh {mesh.shape}: the port's meshes are "
                         "(data, model)")
    compute = tp.build_plan(axes_tree, shapes_tree, cfg=cfg, tp=m,
                            rules=rules, experts=True)
    axes_by_key = {k: a for k, _, a in tp._flatten_with_keys(
        axes_tree, is_leaf=lambda x: isinstance(x, tuple))}
    flat = {}
    with use_sharding(mesh, rules):
        for key, _, like in tp._flatten_with_keys(shapes_tree):
            shape = tuple(like.shape)
            axes = axes_by_key[key]
            spec = logical_spec(axes, shape)
            data_dim = model_dim = None
            for i, entry in enumerate(spec):
                ax = _entry_axes(entry)
                if "model" in ax and len(ax) > 1:
                    raise ValueError(f"{key}: dim {i} over {ax}: the port "
                                     "splits a dim over one mesh axis")
                # an axis of extent 1 splits nothing (JAX's spec names it)
                if "model" in ax and m > 1:
                    model_dim = i
                elif ax and "model" not in ax and d > 1:
                    data_dim = i
            rule = compute.flat[key]
            plain = (rule is not None and model_dim is not None
                     and rule == tp.Segments.plain(model_dim,
                                                   shape[model_dim]))
            if rule is not None and model_dim is None:
                raise ValueError(
                    f"{key}: the layer code slices dim {rule.dim} over "
                    f"model, which the spec {spec} leaves whole")
            flat[key] = Placement(
                data_dim=data_dim,
                experts=data_dim is not None and axes[data_dim] == "expert",
                model_dim=model_dim, rule=rule,
                gather_model=model_dim is not None and not plain)
    return MeshPlan(data=d, model=m, flat=flat)


LANE_AXIS = "data"  # flowcell channel lanes are batch-parallel work


@dataclasses.dataclass(frozen=True)
class LaneMesh:
    """A 1-D mesh of devices of one process over the lane axis.  A device
    may appear twice (``LaneMesh(("cuda:0", "cuda:0"))``): two shards on
    one card, as JAX's virtual host devices put two on one CPU."""
    devices: tuple

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a lane mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    axis_names = (LANE_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict[str, int]:
        return {LANE_AXIS: self.size}


def lane_mesh(n_devices: Optional[int] = None,
              device_type: str = "cuda") -> LaneMesh:
    """The first ``n_devices`` devices of ``device_type`` (every visible
    one by default) as a lane mesh; the CPU is one device."""
    count = torch.cuda.device_count() if device_type == "cuda" else 1
    n = count if n_devices is None else int(n_devices)
    if not 0 < n <= count:
        raise ValueError(f"n_devices={n} not in 1..{count} "
                         f"({device_type} devices here)")
    if device_type == "cuda":
        return LaneMesh(tuple(f"cuda:{i}" for i in range(n)))
    return LaneMesh((device_type,))
