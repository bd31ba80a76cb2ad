"""The LM prefill step (``repro/launch/steps.py``).

:func:`prefill` is the decoder-family ``fn`` of JAX's ``_prefill_cell``
(``transformer.apply(params, tokens, cfg, last_logits_only=True)``) on one
device, without meshes or shardings: the slice's entry point.

    from repro_torch.configs import ARCHS
    from repro_torch.launch.steps import prefill
    from repro_torch.models import transformer
    cfg = ARCHS["qwen3-4b"].config()
    params, _ = transformer.init(torch.Generator("cuda").manual_seed(0), cfg)
    logits = prefill(params, tokens, cfg)            # (B, 1, vocab)

It runs on the card unless the caller asks for ``device="cpu"`` (the plain
versions of the kernels, as the tests run it).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def prefill(params, tokens, cfg: ModelConfig, *,
            device="cuda") -> torch.Tensor:
    """Last-token logits (B, 1, vocab) of ``tokens`` (B, S): int array or
    tensor, moved to ``device``.  ``params`` must already live there."""
    dev = resolve_device(device)
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"prefill: the {cfg.family} family is not ported yet "
            "(ROADMAP.md, Queue 1)")
    emb = params["embedding"]["embed"]
    if emb.device != dev:
        raise ValueError(f"prefill: params on {emb.device}, asked for {dev}")
    tokens = torch.as_tensor(tokens).to(device=dev, dtype=torch.int64)
    with torch.inference_mode():
        logits, _ = transformer.apply(params, tokens, cfg,
                                      last_logits_only=True)
    return logits
