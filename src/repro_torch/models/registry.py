"""The uniform Model API over the decoder families
(``repro/models/registry.py``), consumed by the LM engine and the tests.

    model = get_model(cfg)
    params, axes = model.init(gen, cfg, device=...)
    cache = model.init_cache(cfg, batch_size, max_len, device=...)
    logits, cache = model.serve(params, cache, tokens, pos, cfg)
    loss, metrics = model.loss(params, batch, cfg)

    shapes, axes = model.abstract_params(cfg)   # meta tensors, no memory

An ``encdec`` config (the encoder-decoder family, ROADMAP.md Queue 1
item 6) raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    init: Callable
    abstract_params: Callable
    loss: Callable
    init_cache: Callable
    serve: Callable
    cache_axes: Callable


def _decoder_model() -> Model:
    return Model(
        init=transformer.init,
        abstract_params=lambda cfg: transformer.abstract_params(cfg),
        loss=transformer.loss_fn,
        init_cache=lambda cfg, batch, max_len, **kw:
            transformer.init_cache(cfg, batch, max_len, **kw),
        serve=transformer.serve_step,
        cache_axes=transformer.cache_specs,
    )


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family is not ported yet "
            "(ROADMAP.md, Queue 1 item 6: MoE and the other families)")
    return _decoder_model()
