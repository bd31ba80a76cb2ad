"""ParamBuilder: initialise parameters and record their logical axes
(``repro/models/param.py``).

Every parameter is made by ``ParamBuilder.param(path, shape, axes)`` with
the JAX package's names, shapes, dtypes and fan-in scales: "normal" draws
float32 ``N(0, 1) * scale`` (``scale`` defaults to ``1 / sqrt(fan_in)``,
fan_in = ``shape[0]`` for a matrix) and casts to the parameter's dtype;
"zeros" and "ones" are exact.  The draws come from a ``torch.Generator``
on the parameter's device, so the values differ from ``jax.random``'s;
JAX's own values carry across with :func:`load_numpy_params`.
"""
from __future__ import annotations

import math

import torch

# the weight carry: JAX's tree of numpy arrays (``jax.tree.map(np.asarray,
# params)`` of ``repro.models.transformer.init``) as the port's tree of
# tensors, the same names, nesting, stacked leading dim and dtypes, every
# value bit for bit (bf16 included); and the tree moved between devices
from repro_torch.core.basecaller import load_numpy_params  # noqa: F401
from repro_torch.core.basecaller import params_to  # noqa: F401
from repro_torch.device import resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``, ``"float32"``) as a torch
    dtype; a torch dtype passes through."""
    if isinstance(name, torch.dtype):
        return name
    if name not in DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; expected one of "
                         f"{sorted(DTYPES)}")
    return DTYPES[name]


# a leaf past this many entries draws its float32 normals a run of rows
# (along its last dim) at a time: a full-width expert stack (llama4's
# 5.4e9 entries a leaf) would otherwise need its whole float32 draw
# beside the params
DRAW_ENTRIES = 1 << 28


def _normal(shape, scale, dtype, gen, device) -> torch.Tensor:
    """float32 ``N(0, 1) * scale`` cast to ``dtype``, drawn a run of rows
    (at most :data:`DRAW_ENTRIES` entries) at a time: a leaf under the
    limit is one draw."""
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1, shape[-1])
    rows = max(1, DRAW_ENTRIES // shape[-1])
    for i in range(0, flat.shape[0], rows):
        part = flat[i:i + rows]
        part.copy_(torch.randn(part.shape, generator=gen,
                               dtype=torch.float32, device=device) * scale)
    return out


class ParamBuilder:
    def __init__(self, gen, dtype=torch.bfloat16, device="cuda"):
        # "meta" (with gen None) builds shapes and axes only, allocating
        # nothing: transformer.abstract_params
        self.device = (torch.device("meta") if device == "meta"
                       else resolve_device(device))
        if self.device.type == "meta":
            gen = None
        elif gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, parameters on "
                             f"{self.device}")
        self._gen = gen
        self.dtype = torch_dtype(dtype)
        self.params: dict = {}
        self.axes: dict = {}

    def scope(self, name: str) -> "ScopedBuilder":
        return ScopedBuilder(self, [name])

    def param(self, path: list[str], shape: tuple[int, ...],
              axes: tuple[str | None, ...], *, init: str = "normal",
              scale: float | None = None, dtype=None):
        if len(shape) != len(axes):
            raise ValueError(f"{path}: shape {shape} vs axes {axes}")
        dtype = torch_dtype(dtype or self.dtype)
        if init not in ("normal", "zeros", "ones"):
            raise ValueError(init)
        if self.device.type == "meta":
            val = torch.empty(shape, dtype=dtype, device=self.device)
        elif init == "normal":
            if scale is None:
                fan_in = shape[0] if len(shape) >= 2 else shape[-1]
                scale = 1.0 / math.sqrt(max(fan_in, 1))
            val = _normal(shape, scale, dtype, self._gen, self.device)
        elif init == "zeros":
            val = torch.zeros(shape, dtype=dtype, device=self.device)
        else:
            val = torch.ones(shape, dtype=dtype, device=self.device)
        node, anode = self.params, self.axes
        for k in path[:-1]:
            node = node.setdefault(k, {})
            anode = anode.setdefault(k, {})
        if path[-1] in node:
            raise ValueError(f"duplicate param {path}")
        node[path[-1]] = val
        anode[path[-1]] = axes
        return val


class ScopedBuilder:
    def __init__(self, root: ParamBuilder, prefix: list[str]):
        self._root = root
        self._prefix = prefix

    def scope(self, name: str) -> "ScopedBuilder":
        return ScopedBuilder(self._root, self._prefix + [name])

    def param(self, name: str, shape, axes, **kw):
        return self._root.param(self._prefix + [name], shape, axes, **kw)


def stacked(axes: tuple[str | None, ...]) -> tuple[str | None, ...]:
    """Prepend the layer-stack axis (replicated: the block loop's dim)."""
    return (None,) + tuple(axes)
