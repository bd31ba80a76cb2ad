"""ArchSpec: everything the launcher needs to know about one architecture
(``repro/configs/common.py``).

The trainer knobs carry JAX's values: ``grad_accum`` by shape name,
``optimizer_state_dtype`` and ``grad_accum_dtype``, and ``schedule``, the
LR schedule JAX's launcher picks by the arch's name; ``launch/train.py``
reads the last three.  ``fsdp`` and ``rules_overrides`` go into the
mesh's sharding rules (``launch/train.py --mesh``, the dry run's cells),
and ``sharding.mesh_plan`` places each leaf by them as JAX's
``spec_tree`` does: ``fsdp`` splits the ``embed`` dims over the data
ranks (ZeRO-3, gathered at use), ``"expert": "data"`` spreads the experts
over them (expert parallelism), and grok-1's ``{"expert": None, "embed":
("data",)}`` keeps its experts whole a rank with ``d_model`` split.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    config: Callable[[], ModelConfig]
    smoke_config: Callable[[], ModelConfig]
    # sharding (carried; one card shards nothing)
    fsdp: bool = False                      # ZeRO-3: params, moments over data
    rules_overrides: dict[str, Any] = dataclasses.field(default_factory=dict)
    # trainer memory knobs per shape name (defaults applied otherwise)
    grad_accum: dict[str, int] = dataclasses.field(default_factory=dict)
    optimizer_state_dtype: str = "float32"  # bf16 for the giants
    grad_accum_dtype: str = "float32"
    schedule: str = "cosine"                # optimizer.schedule_lr's name

    def accum_for(self, shape_name: str) -> int:
        return self.grad_accum.get(shape_name, 1)
