"""The rank side of ``tests/test_torch_tp.py``: what each tensor-parallel
rank runs, in a module that imports neither JAX nor the JAX package (the
ranks are spawned processes that import this module by name).

Inputs arrive as numpy trees (quantized weights as ``{"q", "scale",
"axis", "act_scale"}`` dicts, ``param.load_numpy_params``' form) and every
rank returns plain numpy results; the parent holds them against JAX.
"""
import sys

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.distributed import tp
from repro_torch.engine import build
from repro_torch.kernels import fabric
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import load_numpy_params
from repro_torch.models.registry import get_model


def config(arch: str) -> ModelConfig:
    """The arch's smoke config in float32 (JAX's TP tests' dtype)."""
    import dataclasses
    return dataclasses.replace(ARCHS[arch].smoke_config(),
                               dtype=torch.float32)


def decode_logits(eng, steps: int) -> list:
    """JAX's ``decode_logits``: slots start at tokens 3 and 5, each step
    feeds back the argmax; the last position's logits of every step."""
    toks = np.array([[3], [5]], np.int32)
    out = []
    for i in range(steps):
        eng.pos[:] = i
        logits = eng._step(toks)
        out.append(logits)
        toks = logits.argmax(-1)[:, None].astype(np.int32)
    return out


def engine(arch: str, world: int, params=None, **kw):
    cfg = config(arch)
    return build("lm_decode", model=get_model(cfg), params=params, cfg=cfg,
                 slots=2, max_len=16, mesh=world, device="cpu", **kw)


def _tp_counters(base: dict) -> dict:
    return {k: v - base.get(k, 0) for k, v in fabric.counters().items()
            if k.startswith("tp.load.") and v - base.get(k, 0)}


def run_cases(rank: int, world: int, spec: dict) -> dict:
    """Every case of the TP test in one rank: decode parity (int8 and
    f32), the vocab-parallel loss, the sharded-checkpoint loads, and which
    JAX modules the rank holds."""
    out: dict = {}
    for name, (arch, tree, steps) in spec["decode"].items():
        eng = engine(arch, world, load_numpy_params(tree, "cpu"))
        out[name] = decode_logits(eng, steps)

    cfg = config("qwen3-4b")
    params = load_numpy_params(spec["decode"]["qwen3-4b/f32"][1], "cpu")
    shapes, axes = get_model(cfg).abstract_params(cfg)
    plan = tp.build_plan(axes, shapes, cfg=cfg, tp=world)
    local = tp.partition_params(params, plan, rank=rank)
    batch = {k: torch.from_numpy(v) for k, v in spec["loss_batch"].items()}
    with torch.no_grad(), tp.axis_ctx("model", world):
        loss, _ = transformer.loss_fn(local, batch, cfg)
    out["loss"] = float(loss)

    ck = spec["ckpt"]
    base = fabric.counters()
    eng = engine("qwen3-4b", world, ckpt_dir=ck["sharded"])
    out["counters"] = _tp_counters(base)
    wi = eng.params["blocks"]["l0"]["mlp"]["wi"]
    out["local_cols"] = int(wi.q.shape[-1])
    out["local_scale_cols"] = int(wi.scale.shape[-1])
    out["ckpt_logits"] = decode_logits(eng, 6)
    base = fabric.counters()
    engine("qwen3-4b", world, ckpt_dir=ck["full"])
    out["migration_counters"] = _tp_counters(base)
    try:
        engine("qwen3-4b", world, ckpt_dir=ck["wrong"])
        out["wrong_tp_error"] = ""
    except ValueError as e:
        out["wrong_tp_error"] = str(e)

    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    out["rank"] = torch.distributed.get_rank()
    return out


def loaded_modules(rank: int, world: int) -> list:
    """The JAX and JAX-package modules a rank holds after importing the
    port's tensor-parallel modules."""
    import repro_torch.distributed.tp  # noqa: F401
    import repro_torch.engine.lm  # noqa: F401
    import repro_torch.launch.serve  # noqa: F401
    import repro_torch.train.checkpoint_converter  # noqa: F401
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def sleeping_rank(rank: int, world: int, seconds: float) -> None:
    """A rank that outlives ``launch.run``'s deadline."""
    import time
    time.sleep(seconds)
