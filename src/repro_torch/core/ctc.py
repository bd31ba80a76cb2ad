"""CTC greedy decoding, the decode half of ``repro/core/ctc.py``.

Alphabet convention: class 0 is the CTC blank; bases A,C,G,T are 1..4.
Tokens, lengths and classes are int32, as in the JAX package
(``torch.argmax`` and ``cumsum`` return int64, so they are cast).
``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does: the
step decoder relies on an all-zero ReLU tie resolving to BLANK.
"""
from __future__ import annotations

import torch

BLANK = 0


def collapse(best: torch.Tensor, prev: torch.Tensor):
    """Compact kept classes (non-blank, != the preceding frame's class)
    left, zero-fill the tail: a scatter-max left-compaction.  ``best`` /
    ``prev`` (B, T) int32, ``prev[:, t]`` the class of the frame before
    ``best[:, t]``; returns ``(tokens (B, T), lens (B,))``."""
    b, t = best.shape
    keep = (best != BLANK) & (best != prev)
    lens = keep.sum(dim=1, dtype=torch.int32)
    pos = torch.cumsum(keep, dim=1, dtype=torch.int32) - 1
    scatter_idx = torch.where(keep, pos, t - 1).long()
    out = torch.zeros((b, t), dtype=best.dtype, device=best.device)
    out.scatter_reduce_(1, scatter_idx, torch.where(keep, best, 0),
                        reduce="amax", include_self=True)
    mask = torch.arange(t, device=best.device)[None, :] < lens[:, None]
    return torch.where(mask, out, 0), lens


def argmax_classes(logits: torch.Tensor) -> torch.Tensor:
    """Per-frame best class (first maximum), int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def greedy_decode(logits: torch.Tensor, paddings=None):
    """Collapse best-per-frame classes of (B, T, C) logits.  Returns (B, T)
    int32 tokens with 0 padding and (B,) int32 lengths."""
    t = logits.shape[1]
    best = argmax_classes(logits)
    if paddings is not None:
        best = torch.where(paddings > 0, BLANK, best)
    prev = torch.nn.functional.pad(best, (1, 0), value=BLANK)[:, :t]
    return collapse(best, prev)


def greedy_decode_stream(logits: torch.Tensor, prev_class: torch.Tensor,
                         paddings=None):
    """Incremental greedy decode over one streaming chunk of logits.

    ``prev_class`` (B,) is the class of the previous chunk's final frame
    (BLANK at read start); ``paddings`` (B, T') forces padding frames to
    BLANK.  Returns ``(tokens (B, T'), lens (B,), new_prev_class (B,))``."""
    t = logits.shape[1]
    best = argmax_classes(logits)
    if paddings is not None:
        best = torch.where(paddings > 0, BLANK, best)
    prev = torch.cat([prev_class.to(torch.int32)[:, None], best[:, :t - 1]],
                     dim=1)
    tokens, lens = collapse(best, prev)
    return tokens, lens, best[:, -1]
