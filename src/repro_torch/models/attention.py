"""GQA attention: the full-sequence (prefill) path and one-token decode
(``repro/models/attention.py``).

Projection weights are stored flattened, wq: (d_model, H * head_dim), as
in JAX.  ``attention_block`` always runs ``ops.flash_attention``: the
tensor's device picks the Hopper kernel (which takes every length, so
JAX's full and chunked jnp paths have no counterpart here) or its plain
version.  ``decode_attention`` is JAX's replicated decode branch, which
JAX computes in jnp outside any Pallas kernel: plain PyTorch ops here.
Under tensor parallelism each rank holds ``num_heads / tp`` query heads
and ``num_kv_heads / tp`` KV heads (the reshapes read the head count from
the sliced weight), caches only its KV heads, and ``wo`` is row-parallel.
JAX's sequence-sharded combine (``_seq_parallel_decode_attn``) needs a
GSPMD ``kv_seq`` rule, which the tensor-parallel engine never sets: it
waits for ROADMAP.md Queue 1 item 5c.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import tp
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


# ------------------------------------------------------------- decode ----
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                  dtype=torch.bfloat16, *, device="cuda"):
    """Stacked KV cache for the attention layers of one layer stack:
    ``{"k", "v"}`` of (n_layers, batch, max_len, kv_dim), zeros.  Under
    tensor parallelism each rank caches only its KV heads: kv_dim / tp."""
    shape = (n_layers, batch, max_len, cfg.kv_dim // tp.extent())
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(p, x, cfg: ModelConfig, cache_k, cache_v, pos):
    """One-token decode.  x: (B, 1, d); cache_k/v: (B, S_max, kv_dim);
    pos: (B,) current position.  Writes this token's k and v into the
    caches at ``pos`` (in place, one row each) and returns (out, cache_k,
    cache_v).

    JAX's order of rounding: logits in float32 (scaled after the
    product), positions past ``pos`` masked to -1e30, the softmax cast
    to q's dtype, then the product with v.  GQA groups the query heads
    of one KV head instead of repeating the cache (``_repeat_kv``): head
    h reads KV head ``h // (H / Hkv)``, as ``jnp.repeat`` lays them out.
    A tensor-parallel rank's heads are a contiguous run of H / tp query
    heads and the Hkv / tp KV heads they read, so the same grouping holds
    on its local heads."""
    bsz = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, pos[:, None])
    rows = torch.arange(bsz, device=x.device)
    cache_k[rows, pos] = k.reshape(bsz, -1).to(cache_k.dtype)
    cache_v[rows, pos] = v.reshape(bsz, -1).to(cache_v.dtype)

    s_max = cache_k.shape[1]
    d = cfg.head_dim
    kc = cache_k.view(bsz, s_max, -1, d).transpose(1, 2)    # (B, Hkv, S, D)
    vc = cache_v.view(bsz, s_max, -1, d).transpose(1, 2)
    g = kc.shape[1]
    qg = q.reshape(bsz, g, -1, d)                           # (B, Hkv, R, D)
    logits = torch.matmul(qg.float(), kc.float().transpose(2, 3))
    logits = logits * (d ** -0.5)                           # (B, Hkv, R, S)
    past = (torch.arange(s_max, device=x.device)[None, :]
            > pos[:, None])[:, None, None]
    # a Python scalar: a tensor made from one would be a blocking copy to
    # the card, a stream sync every layer
    logits = logits.masked_fill(past, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(probs, vc.to(q.dtype))               # (B, Hkv, R, D)
    out = out.reshape(bsz, 1, -1).to(x.dtype)
    return (row_dense(out, p["wo"], full_in=cfg.q_dim).to(x.dtype),
            cache_k, cache_v)
