"""Small helpers shared by training, checkpointing, kernels and model code
(``repro/utils``)."""
from repro_torch.utils.shapes import ceil_div, next_multiple, pad_to_multiple
from repro_torch.utils.tree import (
    tree_bytes,
    tree_cast,
    tree_count,
    tree_global_norm,
    tree_zeros_like,
)

__all__ = [
    "tree_bytes",
    "tree_count",
    "tree_global_norm",
    "tree_cast",
    "tree_zeros_like",
    "pad_to_multiple",
    "ceil_div",
    "next_multiple",
]
