"""Meshes (``repro/launch/mesh.py``): named axes and their sizes.

A :class:`Mesh` holds no devices: under ``torch.distributed`` a mesh axis
is the ranks of a process group, which ``distributed.launch.run`` starts.
``tp.build_plan`` and ``sharding.default_rules`` read only its ``shape``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """Arbitrary mesh (tests, smoke runs): ``make_mesh((1, 2), ("data",
    "model"))``."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axes {axes}")
    if any(s < 1 for s in shape) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} over axes {axes}")
    return Mesh(axis_names=axes, sizes=shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """JAX's production mesh is 256 (or 512) TPU v5e chips, (data=16,
    model=16); no such mesh exists on an H100 machine, and GSPMD over a
    mesh waits for ROADMAP.md Queue 1 item 5c."""
    raise NotImplementedError(
        f"make_production_mesh(multi_pod={multi_pod}): the production mesh "
        "is 256 TPU chips, which an H100 machine does not have; GSPMD "
        "training over a mesh is ROADMAP.md Queue 1 item 5c")
