"""Micro-basecaller training (``repro/train/micro_basecaller.py``).

A small CNN and a short CTC training run on simulated squiggles, so the
demos and the int8 edge path run real weights rather than random ones.

The step is a module function, :func:`train_step`, so a test can hold one
step against JAX's.  On the card its forward runs the hand ``conv1d``
kernels (and ``matmul`` for a k=1 head, which ``DEMO_CFG`` has not) and
its backward is the gradient of their plain versions
(``kernels/_build.py::PlainGrad``): JAX has no backward kernel either, and
differentiates its reference.

    from repro_torch.train.micro_basecaller import train_micro_basecaller
    cfg, params = train_micro_basecaller(steps=220, device="cuda")
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import basecaller as bc
from repro_torch.core import ctc
from repro_torch.data import nanopore
from repro_torch.device import resolve_device
from repro_torch.quant.fake_quant import fake_quant_params
from repro_torch.train import optimizer as opt
from repro_torch.utils.tree import leaves, tree_map

# cheap, low-noise physics, so a few hundred steps suffice
DEMO_PORE = nanopore.PoreModel(k=1, mean_dwell=6.0, min_dwell=4, noise=0.02,
                               drift=0.0)

DEMO_CFG = bc.BasecallerConfig(kernels=(5, 5, 3), channels=(48, 64, 5),
                               strides=(1, 2, 2))

BATCH_KEYS = ("signal", "signal_paddings", "labels", "label_paddings")


def batch_to(batch: dict, device) -> dict:
    """A ``nanopore.make_ctc_batch`` dict (numpy) as tensors on
    ``device``."""
    return {k: torch.as_tensor(np.asarray(batch[k])).to(device)
            for k in BATCH_KEYS}


def loss_fn(params, batch: dict, cfg: bc.BasecallerConfig = DEMO_CFG, *,
            qat: bool = False) -> torch.Tensor:
    """Mean CTC loss of ``params`` on one batch (tensors on the params'
    device).  ``qat`` sees the weights fake-quantized, as serving stores
    them."""
    p = fake_quant_params(params) if qat else params
    logits = bc.apply(p, batch["signal"], cfg)
    lp = batch["signal_paddings"][:, ::cfg.total_stride][:, :logits.shape[1]]
    return ctc.ctc_loss(logits, lp, batch["labels"],
                        batch["label_paddings"]).mean()


def loss_and_grads(params, batch: dict, cfg: bc.BasecallerConfig = DEMO_CFG,
                   *, qat: bool = False):
    """``(loss, grads)``: the loss and its gradient for every leaf, a tree
    shaped like ``params`` (JAX's ``value_and_grad`` of :func:`loss_fn`)."""
    live = tree_map(lambda x: x.detach().requires_grad_(), params)
    loss = loss_fn(live, batch, cfg, qat=qat)
    got = iter(torch.autograd.grad(loss, leaves(live)))
    flat = {id(x): next(got) for x in leaves(live)}
    return loss.detach(), tree_map(lambda x: flat[id(x)], live)


def train_step(params, state, batch: dict, *, cfg: bc.BasecallerConfig,
               ocfg: opt.OptimizerConfig, qat: bool = False):
    """One training step: the loss and its gradient, then one AdamW
    update.  Returns ``(params, state, loss)``, new trees."""
    loss, grads = loss_and_grads(params, batch, cfg, qat=qat)
    params, state, _ = opt.apply_update(params, grads, state, ocfg)
    return params, state, loss


def train_micro_basecaller(steps: int = 400, *,
                           pm: nanopore.PoreModel = DEMO_PORE,
                           cfg: bc.BasecallerConfig = DEMO_CFG,
                           seq_len: int = 40, batch: int = 8,
                           lr: float = 3e-3, seed: int = 0, qat: bool = False,
                           log: Optional[Callable[[int, float], None]] = None,
                           device="cuda"):
    """Returns ``(cfg, params)`` of a basecaller trained on simulated reads,
    the params on ``device``.  Batches come from ``np.random.default_rng(
    seed)`` as JAX's; the initial draw is a ``torch.Generator``'s, which JAX
    cannot reproduce.  ``log(i, loss)`` is called every 100 steps.

    ``qat=True`` trains against the int8 deployment numerics: the loss sees
    fake-quantized weights (straight-through gradients), so the float
    params lose almost nothing when ``quant.quantize_params`` stores them
    as int8 for the ``edge_int8`` presets."""
    dev = resolve_device(device)
    params = bc.init(torch.Generator().manual_seed(seed), cfg, device=dev)
    ocfg = opt.OptimizerConfig(lr=lr, warmup_steps=20, total_steps=steps,
                               schedule="cosine", weight_decay=0.0)
    state = opt.init_opt_state(params, ocfg)
    rng = np.random.default_rng(seed)
    for i in range(steps):
        b = batch_to(nanopore.make_ctc_batch(rng, batch=batch,
                                             seq_len=seq_len, pm=pm), dev)
        params, state, loss = train_step(params, state, b, cfg=cfg,
                                         ocfg=ocfg, qat=qat)
        if log is not None and i % 100 == 0:
            log(i, float(loss))
    return cfg, params
