"""Architecture registry (``repro/configs``): the archs whose prefill path
is ported.

The JAX package's other eight (nemotron-4-15b, starcoder2-3b, minicpm-2b,
internvl2-76b, llama4-maverick-400b-a17b, grok-1-314b, whisper-medium,
jamba-v0.1-52b) wait on their families' modules: MoE, encoder-decoder and
VLM frontends (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from repro_torch.configs import mamba2_780m, qwen3_4b
from repro_torch.configs.common import ArchSpec
from repro_torch.configs.shapes import SHAPES, ShapeCell

ARCHS: dict[str, ArchSpec] = {
    "qwen3-4b": qwen3_4b.SPEC,
    "mamba2-780m": mamba2_780m.SPEC,
}

__all__ = ["ARCHS", "SHAPES", "ShapeCell", "ArchSpec"]
