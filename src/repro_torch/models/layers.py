"""Shared neural layers of the LM stack (``repro/models/layers.py``).

Plain functions on tensors, in the model's dtype, rounding where JAX
rounds: norms and RoPE compute in float32 and cast back; projections are
``torch.matmul`` (JAX leaves them to an einsum), whose bf16 sums run in
float32 and round once; the MLP always goes through ``ops.mat_mul``, so
the tensor's device picks the Hopper GEMM kernel or its plain version.

Waiting (ROADMAP.md, Queue 1): the tensor-parallel branches (``row_dense``
is the single-device ``dense``) and int8 ``QuantizedTensor`` weights,
which raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ScopedBuilder
from repro_torch.quant import core as qcore

_WAITING_INT8 = ("int8 QuantizedTensor weights in the LM layers are not "
                 "ported yet (ROADMAP.md, Queue 1: the TP and int8-weight "
                 "branches of layers.py)")


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` in x's dtype, each op rounding, as
    ``jax.nn.silu``: its sigmoid (``lax.logistic``) is ``1 / (1 +
    exp(-x))`` with a rounding after each op, which in bf16 differs from
    ``torch.sigmoid`` (one rounding of the exact value) by a unit in the
    last place on about a third of inputs."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def _float_weight(w) -> None:
    if qcore.is_quantized(w):
        raise NotImplementedError(_WAITING_INT8)


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """``x (..., D) @ w (D, F)``, the one projection primitive."""
    _float_weight(w)
    return torch.matmul(x, w)


def row_dense(x: torch.Tensor, w, *, full_in: int) -> torch.Tensor:
    """The row-parallel ``dense`` on one device: ``w`` holds its whole
    input dim, so this is :func:`dense`."""
    if w.shape[0] < full_in:
        raise NotImplementedError(
            f"row_dense: a weight sliced to {w.shape[0]} of {full_in} input "
            "rows needs tensor parallelism, which is not ported yet "
            "(ROADMAP.md, Queue 1)")
    return dense(x, w)


# ------------------------------------------------------------------ norm ---
def init_rmsnorm(b: ScopedBuilder, dim: int):
    b.param("scale", (dim,), ("embed",), init="ones", dtype=torch.float32)


def rmsnorm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def head_rmsnorm(scale: torch.Tensor, x: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """qk-norm: normalise the trailing head_dim (qwen3)."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


# ------------------------------------------------------------------ rope ---
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, D) rotary over D; positions: (..., S)."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(
            f"rope requires an even head_dim, got {d}: the rotation pairs "
            f"feature i with feature i + d//2")
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq      # (..., S, half)
    cos = torch.cos(angles)[..., None, :]             # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------------- mlp ---
def init_mlp(b: ScopedBuilder, cfg: ModelConfig):
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp_gated:
        b.param("wi_gate", (d, ff), ("embed", "mlp"))
        b.param("wi", (d, ff), ("embed", "mlp"))
    else:
        b.param("wi", (d, ff), ("embed", "mlp"))
    b.param("wo", (ff, d), ("mlp", "embed"))


def mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The MLP as (B*S, D) GEMMs with the activation in the kernel's
    epilogue (JAX's kernel path, ``layers.py:194-209``): gate with the
    activation, then up, multiplied in the model's dtype, then down."""
    for k in ("wi", "wi_gate", "wo"):
        _float_weight(p.get(k))
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    if cfg.mlp_gated:
        h = (ops.mat_mul(x2, p["wi_gate"], activation=cfg.activation)
             * ops.mat_mul(x2, p["wi"]))
    else:
        h = ops.mat_mul(x2, p["wi"], activation=cfg.activation)
    return ops.mat_mul(h, p["wo"]).reshape(b, s, d)


# ------------------------------------------------------------- embedding ---
def init_embedding(b: ScopedBuilder, cfg: ModelConfig):
    b.param("embed", (cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
            scale=1.0)
    if not cfg.tie_embeddings:
        b.param("unembed", (cfg.d_model, cfg.vocab_size), ("embed", "vocab"))


def embed(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return p["embed"][tokens]


def unembed(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    logits = torch.matmul(x, w)
    if cfg.logits_softcap > 0:
        c = cfg.logits_softcap
        logits = c * torch.tanh(logits / c)
    return logits
