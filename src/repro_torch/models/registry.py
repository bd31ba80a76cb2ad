"""The uniform Model API over the decoder families
(``repro/models/registry.py``), consumed by the LM engine and the tests.

    model = get_model(cfg)
    params, axes = model.init(gen, cfg, device=...)
    cache = model.init_cache(cfg, batch_size, max_len, device=...)
    logits, cache = model.serve(params, cache, tokens, pos, cfg)
    loss, metrics = model.loss(params, batch, cfg)

    shapes, axes = model.abstract_params(cfg)   # meta tensors, no memory

An ``encdec`` config gets the encoder-decoder model, whose ``init_cache``
takes JAX's ``enc_len=1500`` cross-attention length unless told.

Training on the card (``launch.train``) and tensor parallelism run the
``dense`` and ``ssm`` families; :func:`require_train_and_tp` refuses the
others by name (ROADMAP.md, Queue 1 item 6b).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models import encdec, transformer
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


def _encdec_model() -> Model:
    def cache_axes(cfg):
        return {
            "k": (None, None, "batch", "kv_seq", "kv_heads"),
            "v": (None, None, "batch", "kv_seq", "kv_heads"),
            "xk": (None, "batch", None, "kv_heads"),
            "xv": (None, "batch", None, "kv_heads"),
        }

    return Model(
        init=encdec.init,
        abstract_params=lambda cfg: transformer.abstract_params(
            cfg, init_fn=encdec.init),
        loss=encdec.loss_fn,
        init_cache=lambda cfg, batch, max_len, enc_len=1500, **kw:
            encdec.init_cache(cfg, batch, max_len, enc_len, **kw),
        serve=encdec.serve_step,
        cache_axes=cache_axes,
    )


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family == "encdec":
        return _encdec_model()
    return _decoder_model()


# the families that train on the card and run tensor-parallel
TRAIN_AND_TP_FAMILIES = ("dense", "ssm")


def require_train_and_tp(cfg: ModelConfig, what: str) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP.md Queue 1 item 6b
    where ``what`` (a training launch, a tensor-parallel run) needs a
    family outside :data:`TRAIN_AND_TP_FAMILIES`."""
    if cfg.family not in TRAIN_AND_TP_FAMILIES:
        raise NotImplementedError(
            f"{what}: the {cfg.family} family ({cfg.name}) is not ported "
            "for it yet (ROADMAP.md, Queue 1 item 6b)")
