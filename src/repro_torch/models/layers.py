"""Shared neural layers of the LM stack (``repro/models/layers.py``).

Plain functions on tensors, in the model's dtype, rounding where JAX
rounds: norms and RoPE compute in float32 and cast back; float projections
are ``torch.matmul`` (JAX leaves them to an einsum), whose bf16 sums run
in float32 and round once; the MLP always goes through ``ops.mat_mul``, so
the tensor's device picks the Hopper GEMM kernel or its plain version.

A :class:`~repro_torch.quant.QuantizedTensor` weight (``quantize_params``)
takes the int8 MAC path through ``ops.mat_mul`` wherever a float one takes
a product: the activation quantized per call, the int8 GEMM (the tiled
``matmul_int8`` kernel on the card), the one-FMA dequant epilogue.

Tensor parallelism (:mod:`repro_torch.distributed.tp`): inside a
``tp.axis_ctx`` a weight sliced by ``tp.build_plan`` holds this rank's
share.  Column-parallel projections need no collective; ``row_dense``
all-reduces its partial products (the int8 one its int32 accumulator,
before the epilogue, with the activation's absmax taken over every rank),
the vocab-parallel ``embed`` all-reduces its rows and ``unembed`` gathers
its logits.  Outside a context every collective is the identity.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import tp
from repro_torch.kernels import fabric
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ScopedBuilder
from repro_torch.quant import core as qcore


class _Silu(torch.autograd.Function):
    """``x * s``, ``s = 1 / (1 + exp(-x))``, whose gradient is JAX's:
    ``lax.logistic``'s own rule (``s * (1 - s)``), not the chain through
    ``exp``, which gives ``0 * inf = nan`` where ``exp(-x)`` overflows
    (x < -88 in float32; an MoE expert's row that sums the overflowed
    tokens reaches it)."""

    @staticmethod
    def forward(ctx, x):
        s = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (g * x) * (s * (1 - s))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` in x's dtype, each op rounding, as
    ``jax.nn.silu``: its sigmoid (``lax.logistic``) is ``1 / (1 +
    exp(-x))`` with a rounding after each op, which in bf16 differs from
    ``torch.sigmoid`` (one rounding of the exact value) by a unit in the
    last place on about a third of inputs.  Its gradient is JAX's too
    (:class:`_Silu`)."""
    return _Silu.apply(x)


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """``x (..., D) @ w (D, F)``, the one projection primitive.  A
    QuantizedTensor ``w`` takes ``ops.mat_mul``'s int8 path (the result
    in x's dtype)."""
    if qcore.is_quantized(w):
        lead = x.shape[:-1]
        out = ops.mat_mul(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*lead, w.shape[-1])
    return torch.matmul(x, w)


def _sliced(w, full_in: int) -> bool:
    """Whether ``w`` holds a tensor-parallel slice of its input dim."""
    return tp.axis() is not None and w.shape[0] < full_in


def row_dense(x: torch.Tensor, w, *, full_in: int) -> torch.Tensor:
    """Row-parallel ``dense``: under tensor parallelism ``w`` holds only a
    slice of its input dim and ``x`` the matching activation slice, so the
    partial products need one all-reduce.  ``full_in`` is the unsharded
    input width; a ``w`` that still carries it (no TP, or a replicated
    leaf) makes this exactly :func:`dense`.

    The int8 path all-reduces the int32 accumulator before the float
    epilogue and takes the dynamic activation absmax over every rank
    (``pmax``), so sharded int8 results equal the single-device ones bit
    for bit: integer partial sums commute exactly."""
    if not _sliced(w, full_in):
        return dense(x, w)
    if qcore.is_quantized(w):
        return _row_parallel_int8(x, w)
    return tp.psum(torch.matmul(x, w))


def _row_parallel_int8(x: torch.Tensor, w) -> torch.Tensor:
    """JAX's ``_row_parallel_int8``: the global activation scale, the int8
    GEMM of this rank's slice (``kernels.matmul.matmul_int8``, raw int32),
    the accumulators summed over the ranks, then the one-FMA epilogue."""
    if w.axis is not None and w.axis % w.ndim != w.ndim - 1:
        raise ValueError(
            f"row_dense: per-channel scales must run along the output "
            f"(last) weight axis, got axis={w.axis} for shape "
            f"{tuple(w.shape)}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    sa = w.act_scale
    if sa is None:
        # the dynamic per-tensor scale is the global absmax: every rank
        # quantizes its slice as the unsharded activation would be
        sa = qcore.dynamic_scale(tp.pmax(qcore.absmax(x2)))
    else:
        fabric.record("fabric.precision.matmul.act_static")
    aq = qcore.quantize(x2, sa)
    fabric.record("fabric.precision.matmul.int8")
    fabric.record("tp.row_parallel.matmul")
    acc = tp.psum(_mm.matmul_int8(aq, w.q))   # int32 partials: exact sum
    scale = (torch.as_tensor(sa, dtype=torch.float32, device=x.device)
             * w.scale.to(device=x.device, dtype=torch.float32))
    out = ops._int8_epilogue(acc, scale, None, "none").to(x.dtype)
    return out.reshape(*lead, w.shape[-1])


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
    epilogue (JAX's kernel path, ``layers.py:194-209``, which quantized
    weights take on every target): gate with the activation, then up,
    multiplied in the model's dtype, then down.  Under tensor parallelism
    (JAX's branch at ``layers.py:179-186``) ``wi``/``wi_gate`` are this
    rank's columns, with no collective, and ``wo`` is row-parallel."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    if cfg.mlp_gated:
        h = (ops.mat_mul(x2, p["wi_gate"], activation=cfg.activation)
             * ops.mat_mul(x2, p["wi"]))
    else:
        h = ops.mat_mul(x2, p["wi"], activation=cfg.activation)
    wo = p["wo"]
    if not _sliced(wo, cfg.d_ff):
        out = ops.mat_mul(h, wo)
    elif qcore.is_quantized(wo):
        out = _row_parallel_int8(h, wo)
    else:
        out = tp.psum(ops.mat_mul(h, wo))
    return out.reshape(b, s, d)


# ------------------------------------------------------------- embedding ---
def init_embedding(b: ScopedBuilder, cfg: ModelConfig):
    b.param("embed", (cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
            scale=1.0)
    if not cfg.tie_embeddings:
        b.param("unembed", (cfg.d_model, cfg.vocab_size), ("embed", "vocab"))


def embed(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = p["embed"]
    if tp.axis() is not None and w.shape[0] < cfg.vocab_size:
        # vocab-parallel: each rank owns a contiguous vocab slice; rows
        # outside it contribute exact zeros, so the all-reduce gives the
        # unsharded lookup bit for bit
        vl = w.shape[0]
        local = tokens - tp.index() * vl
        ok = (local >= 0) & (local < vl)
        rows = w[torch.clamp(local, 0, vl - 1)]
        return tp.psum(torch.where(ok[..., None], rows,
                                   torch.zeros((), dtype=w.dtype,
                                               device=w.device)))
    return w[tokens]


def unembed(p, x: torch.Tensor, cfg: ModelConfig, *,
            gather: bool = True) -> torch.Tensor:
    """Logits over the vocab; under tensor parallelism over this rank's
    vocab slice, gathered from every rank unless ``gather=False`` (the
    vocab-parallel loss)."""
    w = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    logits = torch.matmul(x, w)
    if cfg.logits_softcap > 0:
        c = cfg.logits_softcap
        logits = c * torch.tanh(logits / c)   # elementwise: safe pre-gather
    if (gather and tp.axis() is not None
            and logits.shape[-1] < cfg.vocab_size):
        logits = tp.all_gather_last(logits)
    return logits


def parallel_cross_entropy(local_logits: torch.Tensor,
                           labels: torch.Tensor) -> torch.Tensor:
    """NLL over vocab-sharded logits ``(..., V / tp)``: the softmax
    statistics reduce across ranks (the max of maxes, the sum of
    sum-of-exps) and the label's logit comes from the one rank that owns
    it, so the full logit row never exists (JAX's
    ``parallel_cross_entropy``)."""
    lf = local_logits.float()
    vl = lf.shape[-1]
    m = tp.pmax(torch.amax(lf, dim=-1))
    se = tp.psum(torch.sum(torch.exp(lf - m[..., None]), dim=-1))
    labels = labels.long()
    local = labels - tp.index() * vl if tp.axis() is not None else labels
    ok = (local >= 0) & (local < vl)
    picked = torch.gather(lf, -1, torch.clamp(local, 0, vl - 1)[..., None]
                          )[..., 0]
    label_logit = tp.psum(torch.where(ok, picked, torch.zeros(
        (), dtype=lf.dtype, device=lf.device)))
    return m + torch.log(se) - label_logit
