"""The LM prefill step (``repro/launch/steps.py``).

:func:`prefill` is the ``fn`` of JAX's ``_prefill_cell`` on one device,
without meshes or shardings, by family: the decoder families (dense, ssm,
moe, hybrid) ``transformer.apply(params, tokens, cfg,
last_logits_only=True)``, the VLM the same with its ``input_embeds``,
and the encoder-decoder ``encdec.encode(params, frames, cfg)``.

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
from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig


def prefill(params, tokens, cfg: ModelConfig, *, input_embeds=None,
            device="cuda") -> torch.Tensor:
    """Last-token logits (B, 1, vocab) of ``tokens`` (B, S): int array or
    tensor, moved to ``device``; ``input_embeds`` (B, F, d), the VLM's
    patch embeddings, replace the first F embedding rows.  For an
    ``encdec`` config ``tokens`` are the frames (B, S, d_model) and the
    result is the encoder's states (B, S, d_model).  ``params`` must
    already live on ``device``."""
    dev = resolve_device(device)
    emb = params["embedding"]["embed"]
    if emb.device != dev:
        raise ValueError(f"prefill: params on {emb.device}, asked for {dev}")
    with torch.inference_mode():
        if cfg.family == "encdec":
            return encdec.encode(params, torch.as_tensor(tokens).to(dev),
                                 cfg)
        tokens = torch.as_tensor(tokens).to(device=dev, dtype=torch.int64)
        if input_embeds is not None:
            input_embeds = torch.as_tensor(input_embeds).to(dev)
        logits, _ = transformer.apply(params, tokens, cfg,
                                      input_embeds=input_embeds,
                                      last_logits_only=True)
    return logits
