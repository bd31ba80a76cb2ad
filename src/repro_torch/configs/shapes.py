"""The assigned input-shape cells.

  train_4k     seq 4096,   global batch 256   (training)
  prefill_32k  seq 32768,  global batch 32    (inference prefill)
  decode_32k   seq 32768,  global batch 128   (decode: 1 token, 32k KV cache)
  long_500k    seq 524288, global batch 1     (long-context decode)

``long_500k`` needs attention state that does not grow with the context:
it runs for the SSM (mamba2) and hybrid (jamba) archs and is recorded N/A
for the full-attention archs (:func:`applicable`).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeCell) -> tuple[bool, str]:
    """(runs?, reason-if-not)."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("full quadratic attention at 524k context; "
                       "sub-quadratic families only (DESIGN.md Sec 4)")
    return True, ""
