"""Deterministic sharded token pipeline (``repro/data/tokens.py``).

Synthetic LM batches with the properties a production loader must have:

  * **step-addressable determinism**: batch(step) is a pure function of
    (seed, step, shard), so a restarted job resumes mid-epoch with zero
    drift (the fault-tolerance tests rely on this);
  * **shard-local generation**: each data-parallel host draws only its
    slice, from a generator of its own (seed, step, shard);
  * Zipfian marginals, so embedding rows see realistic skew rather than
    uniform noise.

The uniform draws come from a CPU ``torch.Generator`` seeded from
``np.random.SeedSequence((seed, step, shard))``, so they differ from
``jax.random``'s (a parity test feeds JAX's batch in as numpy); the map
from the draws to tokens (:func:`_zipf_map`) is JAX's, in float32, bit
for bit.  The tokens are made on the CPU and moved to the caller's
device, so the card and the CPU train on the same batch.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1


_LIBM = None


def _powf(x: torch.Tensor, y: float) -> torch.Tensor:
    """float32 ``x ** y`` (``y`` rounded to float32) by the C library's
    ``powf``, element by element: the function XLA's CPU backend calls for
    JAX's float32 ``pow``.  torch's vectorised ``pow`` is another
    approximation, an ulp away from it on ~2% of inputs, which moves a
    token's rank by one."""
    global _LIBM
    if _LIBM is None:
        lib = ctypes.CDLL(ctypes.util.find_library("m"))
        lib.powf.restype = ctypes.c_float
        lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
        _LIBM = lib
    yf = float(np.float32(y))
    flat = x.detach().to(torch.float32).reshape(-1).tolist()
    out = np.fromiter((_LIBM.powf(v, yf) for v in flat), np.float32,
                      len(flat))
    return torch.from_numpy(out).reshape(x.shape)


def _zipf_map(u: torch.Tensor, vocab: int, alpha: float) -> torch.Tensor:
    """Map uniform (0,1) to a Zipf-ish rank distribution over [0, vocab)."""
    # inverse-CDF of p(r) ~ (r+1)^-alpha via the analytic integral approx
    v = torch.tensor(vocab, dtype=torch.float32)
    r = (_powf(v, 1.0 - alpha) - 1.0) * u.float() + 1.0
    rank = _powf(r, 1.0 / (1.0 - alpha)) - 1.0
    return torch.clamp(rank.to(torch.int32), 0, vocab - 1)


def _generator(seed: int, step: int, shard: int) -> torch.Generator:
    words = np.random.SeedSequence((seed, step, shard)).generate_state(2)
    return torch.Generator().manual_seed(
        (int(words[0]) << 31) ^ int(words[1]))


def batch_at_step(cfg: TokenPipelineConfig, step: int, *, shard: int = 0,
                  num_shards: int = 1, device="cuda") -> dict:
    """Deterministic batch slice for (step, shard): ``tokens`` and
    ``labels`` (the tokens shifted by one), int32 (B / num_shards,
    seq_len), on ``device``."""
    if cfg.global_batch % num_shards:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"into {num_shards} shards")
    dev = resolve_device(device)
    local = cfg.global_batch // num_shards
    u = torch.rand((local, cfg.seq_len + 1), generator=_generator(
        cfg.seed, step, shard), dtype=torch.float32)
    # jax.random.uniform(minval=1e-6, maxval=1.0)
    u = torch.clamp_min(u * (1.0 - 1e-6) + 1e-6, 1e-6)
    toks = _zipf_map(u, cfg.vocab_size, cfg.zipf_alpha)
    return {"tokens": toks[:, :-1].contiguous().to(dev),
            "labels": toks[:, 1:].contiguous().to(dev)}


def host_batch_at_step(cfg: TokenPipelineConfig, step: int, *, shard: int = 0,
                       num_shards: int = 1) -> dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in batch_at_step(
        cfg, step, shard=shard, num_shards=num_shards, device="cpu").items()}
