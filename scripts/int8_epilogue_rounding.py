#!/usr/bin/env python3
"""How the JAX package rounds its int8 dequant epilogue, eager and jitted.

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/int8_epilogue_rounding.py

Runs one int8 conv (``repro.kernels.ops.conv1d`` with a stored
``QuantizedTensor``, a nonzero bias) eagerly and under ``jax.jit``, and
counts the outputs that differ from two float32 references computed in
numpy: one rounding of ``float(acc) * scale + bias`` (a fused
multiply-add) and two roundings (multiply, then add).  The PyTorch port
(``repro_torch``) computes the one-rounding form, which is what the JAX
engines compute, since they run jitted.  Prints one JSON line.
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np

from repro import quant
from repro.kernels import ops, ref


def main() -> None:
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 300, 64)).astype(np.float32)
    w = (rng.standard_normal((7, 64, 96)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(96) * 0.3).astype(np.float32)
    sa = np.float32(0.031)
    qt = quant.quantize_tensor(jnp.asarray(w), axis=2, act_scale=sa)

    def conv(v):
        return ops.conv1d(v, qt, jnp.asarray(b), stride=2, padding="valid",
                          fabric="reference")

    eager = np.asarray(conv(jnp.asarray(x)))
    jitted = np.asarray(jax.jit(conv)(jnp.asarray(x)))
    aq = np.asarray(quant.quantize(jnp.asarray(x), sa))
    acc = np.asarray(ref.conv1d(jnp.asarray(aq), qt.q, stride=2))
    scale = (sa * np.asarray(qt.scale)).astype(np.float32)
    accf = acc.astype(np.float32)
    # a float32 product is exact in float64, so this rounds once, save for
    # sums that land exactly on a float32 tie in float64 (rare)
    once = (accf.astype(np.float64) * scale + b).astype(np.float32)
    twice = (accf * scale).astype(np.float32) + b
    print(json.dumps({
        "outputs": int(eager.size),
        "eager_vs_one_rounding": int((eager != once).sum()),
        "eager_vs_two_roundings": int((eager != twice).sum()),
        "jit_vs_one_rounding": int((jitted != once).sum()),
        "jit_vs_two_roundings": int((jitted != twice).sum()),
        "jax": jax.__version__, "backend": jax.default_backend()}))


if __name__ == "__main__":
    main()
