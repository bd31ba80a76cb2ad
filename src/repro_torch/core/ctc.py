"""CTC loss and decoders (``repro/core/ctc.py``).

* :func:`ctc_loss`: the log-space forward (alpha) recursion, differentiable
  by autograd, padding-aware: JAX's recursion step for step.  It is not
  ``torch.nn.functional.ctc_loss``, whose padding, infeasibility and
  ``zero_infinity`` conventions differ: here a padded frame carries alpha
  unchanged, and a label the frames cannot cover costs 1e6.
* :func:`greedy_decode` / :func:`greedy_decode_stream`: best-per-frame
  collapse; :func:`viterbi_decode` the same with the best path's score.
* :func:`beam_decode_np`: prefix beam search in numpy, host-side.

Alphabet convention: class 0 is the CTC blank; bases A,C,G,T are 1..4.
Tokens, lengths and classes are int32, as in the JAX package
(``torch.argmax`` and ``cumsum`` return int64, so they are cast).
``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does: the
step decoder relies on an all-zero ReLU tie resolving to BLANK.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BLANK = 0
_NEG = -1e30


def _extend_labels(labels: torch.Tensor) -> torch.Tensor:
    """(B, L) -> (B, 2L + 1) interleaved with blanks."""
    b, n = labels.shape
    ext = torch.full((b, 2 * n + 1), BLANK, dtype=torch.int64,
                     device=labels.device)
    ext[:, 1::2] = labels.to(torch.int64)
    return ext


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor,
             labels: torch.Tensor, label_paddings: torch.Tensor
             ) -> torch.Tensor:
    """Negative log P(labels | logits) per batch element, float32.

    logits (B, T, C) unnormalised; logit_paddings (B, T) 1.0 where padded;
    labels (B, L) int (entries under label_paddings ignored);
    label_paddings (B, L) 1.0 where padded.  Returns (B,)."""
    b, t, _ = logits.shape
    n = labels.shape[1]
    dev = logits.device
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    logit_paddings = torch.as_tensor(logit_paddings, device=dev).float()
    label_paddings = torch.as_tensor(label_paddings, device=dev).float()
    ext = _extend_labels(torch.as_tensor(labels, device=dev))   # (B, S)
    s = 2 * n + 1
    # a skip (s - 2 -> s) is allowed where ext[s] != ext[s-2] and not blank
    ext_shift2 = F.pad(ext, (2, 0), value=-1)[:, :s]
    allow_skip = (ext != ext_shift2) & (ext != BLANK)
    label_lens = (1.0 - label_paddings).sum(dim=1).to(torch.int64)
    logit_lens = (1.0 - logit_paddings).sum(dim=1).to(torch.int64)
    s_last = 2 * label_lens    # the final blank; the final label is s_last - 1

    neg = torch.full((b, 1), _NEG, device=dev)
    emit0 = logprobs[:, 0].gather(1, ext)
    cols = [emit0[:, :1]]
    if n > 0:
        cols.append(torch.where(label_lens[:, None] > 0, emit0[:, 1:2], neg))
    alpha = torch.cat(cols + [neg.expand(b, s - len(cols))], dim=1)
    for i in range(1, t):
        emit = logprobs[:, i].gather(1, ext)
        a1 = torch.cat([neg, alpha[:, :s - 1]], dim=1)
        a2 = torch.cat([neg, neg, alpha[:, :s - 2]], dim=1)[:, :s]
        a2 = torch.where(allow_skip, a2, neg)
        new = torch.logaddexp(torch.logaddexp(alpha, a1),
                              torch.logaddexp(a2, neg)) + emit
        # a padded frame carries alpha through unchanged
        alpha = torch.where(logit_paddings[:, i, None] > 0, alpha, new)

    idx = torch.stack([s_last, torch.clamp_min(s_last - 1, 0)], dim=1)
    tails = alpha.gather(1, idx)
    # an empty label: the all-blank path, alpha[:, 0]
    total = torch.where(label_lens[:, None] > 0, tails,
                        torch.cat([alpha[:, :1], neg], dim=1))
    ll = torch.logsumexp(total, dim=1)
    # the frames must cover the labels, else the loss is a large constant
    feasible = logit_lens >= label_lens
    return torch.where(feasible, -ll, torch.full_like(ll, 1e6))


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


def viterbi_decode(logits: torch.Tensor, labels_like=None):
    """Best-path decode, the greedy collapse (frames are conditionally
    independent, so the per-frame argmax is the MAP path), with the best
    path's log score: ``(tokens, lens, path_score (B,))``."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    path_score = logprobs.amax(dim=-1).sum(dim=-1)
    tokens, lens = greedy_decode(logits)
    return tokens, lens, path_score


def beam_decode_np(logits, beam: int = 8) -> np.ndarray:
    """Prefix beam search on the host, one read: logits (T, C) -> int32
    tokens.  The log-softmax is float32, then the search runs in numpy
    float64, as JAX's."""
    lp = torch.log_softmax(torch.as_tensor(np.asarray(logits, np.float32)),
                           dim=-1).numpy()
    t, c = lp.shape
    # beams: prefix tuple -> (p_blank, p_nonblank) in log space
    beams = {(): (0.0, -np.inf)}
    for step in range(t):
        new: dict[tuple, list[float]] = {}

        def add(prefix, pb, pnb):
            old = new.get(prefix, [-np.inf, -np.inf])
            new[prefix] = [np.logaddexp(old[0], pb), np.logaddexp(old[1], pnb)]

        for prefix, (pb, pnb) in beams.items():
            total = np.logaddexp(pb, pnb)
            add(prefix, total + lp[step, BLANK], -np.inf)
            for k in range(1, c):
                p_k = lp[step, k]
                if prefix and prefix[-1] == k:
                    # a repeat extends the non-blank mass only from a blank
                    add(prefix, -np.inf, pnb + p_k)
                    add(prefix + (k,), -np.inf, pb + p_k)
                else:
                    add(prefix + (k,), -np.inf, total + p_k)
        ranked = sorted(new.items(), key=lambda kv: -np.logaddexp(*kv[1]))
        beams = dict(ranked[:beam])
    best = max(beams.items(), key=lambda kv: np.logaddexp(*kv[1]))[0]
    return np.array(best, np.int32)


def tokens_to_str(tokens, length=None) -> str:
    """1..4 -> ACGT (anything else dropped)."""
    alpha = "NACGT"
    arr = np.asarray(tokens.cpu() if isinstance(tokens, torch.Tensor)
                     else tokens)
    if length is not None:
        arr = arr[: int(length)]
    return "".join(alpha[int(x)] for x in arr if 0 < int(x) <= 4)


def str_to_tokens(s: str) -> np.ndarray:
    """ACGT -> 1..4, int32."""
    lut = {"A": 1, "C": 2, "G": 3, "T": 4}
    return np.array([lut[ch] for ch in s], np.int32)
