"""Meshes (``repro/launch/mesh.py``): named axes over the ranks of a
process group.

JAX's mesh is devices; the port's is the ranks of ``torch.distributed``,
one process a rank, which ``distributed.launch.run`` starts.  Ranks lie
on the mesh in row-major order, the last axis innermost: on a
``(data, model)`` mesh of ``(d, m)`` the ranks ``r`` with the same ``r //
m`` share a model group, and a data group strides by ``m``.

:func:`make_mesh` inside an initialised process group checks that the
group holds exactly the mesh's ranks, gives this rank its coordinates and
makes one process group an axis (every rank makes every group, in the
same order, as ``dist.new_group`` asks).  Outside one it describes a
layout only (``tp.build_plan`` and ``sharding.default_rules`` read just its
``shape``); whatever runs collectives on it asks for :func:`bind`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    coords: Optional[tuple[int, ...]] = None   # this rank's, bound only
    groups: Optional[tuple[Any, ...]] = None   # one process group an axis
    world: Any = None                          # all axes' (None: WORLD)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def bound(self) -> bool:
        return self.groups is not None

    def group(self, axes):
        """The process group over ``axes`` (a name or a tuple of names):
        one axis's group, or the world's when they cover every axis."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if not self.bound:
            raise RuntimeError(
                f"mesh {self.shape} is a layout only: collectives over it "
                "run in the ranks of a process group (start them with "
                "repro_torch.distributed.launch.run, then make_mesh)")
        if len(axes) == 1:
            return self.groups[self.axis_names.index(axes[0])]
        if sorted(axes) == sorted(self.axis_names):
            if self.world is not None:
                return self.world
            import torch.distributed as dist
            return dist.group.WORLD
        raise ValueError(f"no process group over {axes} of the mesh "
                         f"{self.shape}: one axis, or all of them")

    def index(self, axes) -> int:
        """This rank's position along ``axes``, row-major in their order
        (JAX's ``axis_index`` over a tuple)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if self.coords is None:
            raise RuntimeError(f"mesh {self.shape} is a layout only")
        idx = 0
        for a in axes:
            i = self.axis_names.index(a)
            idx = idx * self.sizes[i] + self.coords[i]
        return idx


def _coords(rank: int, sizes: tuple[int, ...]) -> tuple[int, ...]:
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """``make_mesh((2, 2), ("data", "model"))``: bound to this rank's
    process group when one is initialised (it must hold ``prod(shape)``
    ranks), a layout otherwise."""
    import torch.distributed as dist

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axes {axes}")
    if any(s < 1 for s in shape) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} over axes {axes}")
    if not dist.is_initialized():
        return Mesh(axis_names=axes, sizes=shape)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != math.prod(shape):
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                         f"{math.prod(shape)} ranks; the process group "
                         f"holds {world}")
    coords = _coords(rank, shape)
    groups = []
    for i in range(len(shape)):
        mine = None
        # every rank makes every group of this axis, in rank order
        for r in range(world):
            c = _coords(r, shape)
            if c[i] != 0:
                continue
            ranks = [r + k * math.prod(shape[i + 1:])
                     for k in range(shape[i])]
            g = dist.new_group(ranks)
            if rank in ranks:
                mine = g
        groups.append(mine)
    return Mesh(axis_names=axes, sizes=shape, coords=coords,
                groups=tuple(groups))


def bind(mesh: Mesh) -> Mesh:
    """``mesh`` bound to this rank's process group (made anew where it is
    a layout; every rank of the group must call this together)."""
    if mesh.bound:
        return mesh
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {mesh.shape} runs one process a rank in a group of "
            f"{mesh.size} (no process group here): start them with "
            "repro_torch.distributed.launch.run")
    return make_mesh(mesh.sizes, mesh.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """JAX's production mesh is 256 (or 512) TPU v5e chips, (data=16,
    model=16); an H100 machine has no such mesh: :func:`make_mesh` takes
    the ranks there are."""
    raise NotImplementedError(
        f"make_production_mesh(multi_pod={multi_pod}): the production mesh "
        "is 256 TPU chips, which an H100 machine does not have; "
        "make_mesh((d, m), ('data', 'model')) takes d * m ranks")
