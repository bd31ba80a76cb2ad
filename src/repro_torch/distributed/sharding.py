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
