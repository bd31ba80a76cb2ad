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

Every family trains (``launch.train``, one device or a mesh of ranks)
and every decoder family serves tensor-parallel;
:func:`require_train_and_tp` refuses the one run JAX's own TP engine
cannot make, the encoder-decoder's TP decode.
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


def require_train_and_tp(cfg: ModelConfig, what: str) -> None:
    """Raise ``NotImplementedError`` where ``what`` (a tensor-parallel
    decode: ``LMDecodeEngine``'s TP branch, ``serve --tp``) needs the
    ``encdec`` family: JAX's TP engine does not serve it either (its cache
    specs have no cross-attention K/V, ``KeyError: 'xk'``).  Training, on
    one device or over a (data, model) mesh, runs every family."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{what}: the encdec family ({cfg.name}) has no tensor-parallel "
            "decode, as JAX's TP engine has none (its cache specs hold no "
            "cross-attention K/V: KeyError 'xk'); serve it on one device")
