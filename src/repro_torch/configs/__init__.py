"""Architecture registry (``repro/configs``): the archs whose model code
is ported, the dense and SSM families.

The JAX package's other five (internvl2-76b, llama4-maverick-400b-a17b,
grok-1-314b, whisper-medium, jamba-v0.1-52b) wait on their families'
modules: MoE, encoder-decoder, hybrid and VLM frontends (ROADMAP.md,
Queue 1 item 6).  ``basecaller_soc`` (the paper's CNN) stays outside
``ARCHS``, as in JAX.
"""
from __future__ import annotations

from repro_torch.configs import (
    mamba2_780m,
    minicpm_2b,
    nemotron_4_15b,
    qwen3_4b,
    starcoder2_3b,
)
from repro_torch.configs.common import ArchSpec
from repro_torch.configs.shapes import SHAPES, ShapeCell, applicable

# the JAX package's archs that wait on their families' modules, by family
WAITING_ARCHS: dict[str, str] = {
    "internvl2-76b": "vlm",
    "llama4-maverick-400b-a17b": "moe",
    "grok-1-314b": "moe",
    "whisper-medium": "encdec",
    "jamba-v0.1-52b": "hybrid",
}

ARCHS: dict[str, ArchSpec] = {
    "qwen3-4b": qwen3_4b.SPEC,
    "nemotron-4-15b": nemotron_4_15b.SPEC,
    "starcoder2-3b": starcoder2_3b.SPEC,
    "minicpm-2b": minicpm_2b.SPEC,
    "mamba2-780m": mamba2_780m.SPEC,
}

__all__ = ["ARCHS", "SHAPES", "ShapeCell", "ArchSpec", "WAITING_ARCHS",
           "applicable"]
