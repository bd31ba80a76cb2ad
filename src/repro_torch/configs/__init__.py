"""Architecture registry (``repro/configs``): ``--arch <id>`` resolution
for every launcher, the JAX package's ten LM archs.

``basecaller_soc`` (the paper's CNN) stays outside ``ARCHS``, as in JAX.
"""
from __future__ import annotations

from repro_torch.configs import (
    grok1_314b,
    internvl2_76b,
    jamba_v01_52b,
    llama4_maverick_400b,
    mamba2_780m,
    minicpm_2b,
    nemotron_4_15b,
    qwen3_4b,
    starcoder2_3b,
    whisper_medium,
)
from repro_torch.configs.common import ArchSpec
from repro_torch.configs.shapes import SHAPES, ShapeCell, applicable

ARCHS: dict[str, ArchSpec] = {
    "qwen3-4b": qwen3_4b.SPEC,
    "nemotron-4-15b": nemotron_4_15b.SPEC,
    "starcoder2-3b": starcoder2_3b.SPEC,
    "minicpm-2b": minicpm_2b.SPEC,
    "internvl2-76b": internvl2_76b.SPEC,
    "llama4-maverick-400b-a17b": llama4_maverick_400b.SPEC,
    "grok-1-314b": grok1_314b.SPEC,
    "mamba2-780m": mamba2_780m.SPEC,
    "whisper-medium": whisper_medium.SPEC,
    "jamba-v0.1-52b": jamba_v01_52b.SPEC,
}

__all__ = ["ARCHS", "SHAPES", "ShapeCell", "ArchSpec", "applicable"]
