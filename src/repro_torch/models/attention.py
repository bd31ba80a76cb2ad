"""GQA attention, the full-sequence (prefill) path
(``repro/models/attention.py``).

Projection weights are stored flattened, wq: (d_model, H * head_dim), as
in JAX.  ``attention_block`` always runs ``ops.flash_attention``: the
tensor's device picks the Hopper kernel (which takes every length, so
JAX's full and chunked jnp paths have no counterpart here) or its plain
version.  The decode functions (``decode_attention``, the KV cache) wait
for the decode server (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense, head_rmsnorm, rope, row_dense
from repro_torch.models.param import ScopedBuilder


def init_attention(b: ScopedBuilder, cfg: ModelConfig):
    d = cfg.d_model
    b.param("wq", (d, cfg.q_dim), ("embed", "heads"))
    b.param("wk", (d, cfg.kv_dim), ("embed", "kv_heads"))
    b.param("wv", (d, cfg.kv_dim), ("embed", "kv_heads"))
    b.param("wo", (cfg.q_dim, d), ("heads", "embed"))
    if cfg.qk_norm:
        b.param("q_norm", (cfg.head_dim,), (None,), init="ones",
                dtype=torch.float32)
        b.param("k_norm", (cfg.head_dim,), (None,), init="ones",
                dtype=torch.float32)


def _project_qkv(p, x, cfg: ModelConfig, positions):
    """q (B, S, H, D), k and v (B, S, Hkv, D): projection, qk-norm, RoPE."""
    b, s, _ = x.shape
    q = dense(x, p["wq"]).reshape(b, s, -1, cfg.head_dim)
    k = dense(x, p["wk"]).reshape(b, s, -1, cfg.head_dim)
    v = dense(x, p["wv"]).reshape(b, s, -1, cfg.head_dim)
    if cfg.qk_norm:
        q = head_rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = head_rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return (rope(q, positions, cfg.rope_theta), rope(k, positions,
                                                     cfg.rope_theta), v)


def attention_block(p, x, cfg: ModelConfig, positions, *, causal=True):
    """Full-sequence self-attention over (B, S, d_model).  Cross-attention
    (JAX's ``kv_override``) waits for the encoder-decoder family."""
    bsz, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = ops.flash_attention(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), causal=causal,
        scale=cfg.head_dim ** -0.5)
    out = out.transpose(1, 2).reshape(bsz, s, -1)
    return row_dense(out, p["wo"], full_in=cfg.q_dim)
