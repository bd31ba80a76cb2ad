"""ArchSpec: one architecture's published config and its smoke-size
cut (``repro/configs/common.py``, without the trainer and sharding knobs,
which wait for a training slice)."""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    config: Callable[[], ModelConfig]
    smoke_config: Callable[[], ModelConfig]
