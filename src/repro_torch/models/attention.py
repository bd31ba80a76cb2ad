"""GQA attention: the full-sequence (prefill) path and one-token decode
(``repro/models/attention.py``).

Projection weights are stored flattened, wq: (d_model, H * head_dim), as
in JAX.  ``attention_block`` always runs ``ops.flash_attention``: the
tensor's device picks the Hopper kernel (which takes every length, so
JAX's chunked jnp path has no counterpart here) or its plain version; its
``kv_override`` is the encoder-decoder's cross-attention.
``full_attention`` is JAX's plain full attention, which the
encoder-decoder's decode cross-attention calls.  ``decode_attention`` is
JAX's replicated decode branch, which JAX computes in jnp outside any
Pallas kernel: plain PyTorch ops here.
Under tensor parallelism each rank holds ``num_heads / tp`` query heads
and ``num_kv_heads / tp`` KV heads (the reshapes read the head count from
the sliced weight), caches only its KV heads, and ``wo`` is row-parallel.

A ``kv_seq`` rule in the active sharding context (``default_rules(mesh,
overrides={"kv_seq": "model"})``, JAX's spelling) makes the decode
sequence-sharded, JAX's ``_seq_parallel_decode_attn``: each rank of the
rule's axes holds ``S / n`` cache positions, attends over them, and the
partials combine by the log-sum-exp over the ranks' process group (plain
PyTorch ops and collectives, as JAX computes it in jnp); where those
axes span the TP axis, each rank attends over every head of its
positions (:func:`decode_attention`).  An ``act_seq`` rule (JAX's
context parallelism, where the heads do not divide the model axis)
splits the query sequence of :func:`attention_block` over its ranks
(:func:`_context_parallel`) and a decode's cache by sequence.
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


def _project_qkv(p, x, cfg: ModelConfig, positions, *, apply_rope=True,
                 q_only=False):
    """q (B, S, H, D), k and v (B, S, Hkv, D): projection, qk-norm, RoPE
    (``apply_rope=False``: none, whisper's cross-attention query);
    ``q_only`` returns ``(q, None, None)``."""
    b, s, _ = x.shape
    q = dense(x, p["wq"]).reshape(b, s, -1, cfg.head_dim)
    if cfg.qk_norm:
        q = head_rmsnorm(p["q_norm"], q, cfg.norm_eps)
    if apply_rope:
        q = rope(q, positions, cfg.rope_theta)
    if q_only:
        return q, None, None
    k = dense(x, p["wk"]).reshape(b, s, -1, cfg.head_dim)
    v = dense(x, p["wv"]).reshape(b, s, -1, cfg.head_dim)
    if cfg.qk_norm:
        k = head_rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if apply_rope:
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def full_attention(q, k, v, *, causal: bool, scale: float) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Skv, Hkv, D) -> (B, Sq, H, D): JAX's
    ``full_attention`` in plain ops (the encoder-decoder's decode
    cross-attention, which JAX computes in jnp).  Logits in float32,
    scaled after the product, the causal mask aligned to the last key,
    the softmax cast to q's dtype, then the product with v in the two
    operands' promoted dtype."""
    n_rep = q.shape[2] // k.shape[2]
    kk = torch.repeat_interleave(k, n_rep, dim=2) if n_rep > 1 else k
    vv = torch.repeat_interleave(v, n_rep, dim=2) if n_rep > 1 else v
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * scale
    if causal:
        sq, skv = q.shape[1], k.shape[1]
        qi = torch.arange(sq, device=q.device)[:, None]
        kj = torch.arange(skv, device=q.device)[None, :]
        logits = logits.masked_fill(kj > qi + (skv - sq), float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    dt = torch.promote_types(probs.dtype, vv.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(dt), vv.to(dt))


def _act_seq():
    """``(group, index, n)`` of the active sharding context's ``act_seq``
    axes (those of extent above 1 in its mesh), or None where the rule is
    unset or splits nothing."""
    from repro_torch.distributed import sharding
    ctx = sharding.active()
    axes = _rule_axes(ctx, "act_seq")
    if not axes:
        return None
    mesh = ctx.mesh
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return mesh.group(axes), mesh.index(axes), n


def _rule_axes(ctx, logical: str) -> tuple:
    """The mesh axes ``logical`` maps to in ``ctx`` that split something
    (present in its mesh at an extent above 1), in the rule's order."""
    rule = ctx.rules.get(logical) if ctx is not None else None
    if not rule:
        return ()
    axes = (rule,) if isinstance(rule, str) else tuple(rule)
    return tuple(a for a in axes if ctx.mesh.shape.get(a, 1) > 1)


def attention_block(p, x, cfg: ModelConfig, positions, *, causal=True,
                    kv_override=None):
    """Full-sequence attention over (B, S, d_model).  ``kv_override``
    (k, v), each (B, Skv, Hkv, D) already split into heads, makes it
    cross-attention (the encoder-decoder's): q is projected without RoPE,
    ``wk``/``wv`` are unused, and the kernel runs at Sq != Skv.

    Under an ``act_seq`` rule (JAX's context parallelism, where the heads
    do not divide the model axis) each of the rule's ``n`` ranks takes
    its block of the query sequence: :func:`_context_parallel`."""
    cp = _act_seq()
    if cp is not None:
        return _context_parallel(p, x, cfg, positions, causal, kv_override,
                                 *cp)
    bsz, s, _ = x.shape
    if kv_override is not None:
        q, _, _ = _project_qkv(p, x, cfg, positions, apply_rope=False,
                               q_only=True)
        k, v = kv_override
    else:
        q, k, v = _project_qkv(p, x, cfg, positions)
    out = ops.flash_attention(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), causal=causal,
        scale=cfg.head_dim ** -0.5)
    out = out.transpose(1, 2).reshape(bsz, s, -1)
    return row_dense(out, p["wo"], full_in=cfg.q_dim)


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` (B, S, ...) with zero rows appended on dim 1 up to ``rows``."""
    if t.shape[1] == rows:
        return t
    pad = torch.zeros((t.shape[0], rows - t.shape[1]) + tuple(t.shape[2:]),
                      dtype=t.dtype, device=t.device)
    return torch.cat([t, pad], dim=1)


def _context_parallel(p, x, cfg: ModelConfig, positions, causal,
                      kv_override, grp, r: int, n: int):
    """Context-parallel attention (JAX's ``act_seq`` over the model axis,
    ``repro/models/attention.py:200-208``), realised by hand on rank ``r``
    of the ``n`` ranks of ``grp``, each holding the whole residual ``x``
    and whole attention weights (``tp.build_plan`` gives their heads no
    rule; a mesh gathers them at the block's top).

    The rank takes rows [r L, r L + L) of the sequence, L = ceil(S / n)
    (the last ranks hold fewer, or none, where n does not divide S),
    projects q, k and v for them at their absolute positions, all-gathers
    k and v over the sequence (cropped to S), and runs
    ``ops.flash_attention`` with its q against the key prefix its rows
    can see: the kernel aligns its causal mask to the last key, so the
    prefix of length Skv - S + r L + (its rows) gives each row exactly its
    causal keys, a padded key never among them (not causal: every key).
    ``wo`` maps its rows, and the output is all-gathered over the
    sequence, so every rank again holds the whole residual.

    Gradients, by ``tp``'s convention (a replicated tensor's gradient is
    this rank's share, a rank-local one's whole): the row slice of ``x``
    gives its share with no collective; both gathers reduce-scatter in
    the backward, which sums the ranks' shares of the gathered tensor
    into the whole gradient of this rank's block."""
    bsz, s, _ = x.shape
    rows = -(-s // n)
    lo = min(r * rows, s)
    real = min(rows, s - lo)
    xr, pr = x[:, lo:lo + real], positions[:, lo:lo + real]
    if kv_override is not None:
        q, _, _ = _project_qkv(p, xr, cfg, pr, apply_rope=False, q_only=True)
        k, v = kv_override
    else:
        q, k, v = _project_qkv(p, xr, cfg, pr)
        k = tp.gather(_pad_rows(k, rows), grp, 1)[:, :s]
        v = tp.gather(_pad_rows(v, rows), grp, 1)[:, :s]
    width = cfg.num_heads * cfg.head_dim
    if real:
        keys = k.shape[1] - s + lo + real if causal else k.shape[1]
        out = ops.flash_attention(
            q.transpose(1, 2).contiguous(),
            k[:, :keys].transpose(1, 2).contiguous(),
            v[:, :keys].transpose(1, 2).contiguous(), causal=causal,
            scale=cfg.head_dim ** -0.5)
        out = out.transpose(1, 2).reshape(bsz, real, width)
    else:
        out = q.new_zeros((bsz, 0, width))
    y = row_dense(out, p["wo"], full_in=cfg.q_dim)
    return tp.gather(_pad_rows(y, rows), grp, 1)[:, :s]


# ------------------------------------------------------------- decode ----
def decode_seq_axes():
    """``(axes, mesh)``: the mesh axes a decode's KV cache is split over by
    sequence under the active sharding context, or ``(None, None)``.
    Those are the ``kv_seq`` rule's (JAX's reading at
    ``attention.py:305-320``), then the ``act_seq`` rule's: under context
    parallelism the heads stay whole, and the cache is split by sequence
    over the same ranks in place of JAX's split of its columns.  Axes of
    extent 1 split nothing and are left out."""
    from repro_torch.distributed import sharding
    ctx = sharding.active()
    axes = _rule_axes(ctx, "kv_seq")
    axes += tuple(a for a in _rule_axes(ctx, "act_seq") if a not in axes)
    return (axes, ctx.mesh) if axes else (None, None)


def decode_seq_extent() -> int:
    """The ranks a decode's cache is split over by sequence (1 where it is
    whole): a rank holds ``S / decode_seq_extent()`` positions."""
    axes, mesh = decode_seq_axes()
    n = 1
    for a in axes or ():
        n *= mesh.shape[a]
    return n


def _cache_heads_whole() -> bool:
    """Whether a tensor-parallel rank's decode caches every KV head: where
    its cache is split by sequence over the TP axis, the token's heads are
    gathered over that axis and each rank attends over all of them."""
    axes, _ = decode_seq_axes()
    return tp.axis() is not None and tp.axis() in (axes or ())


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                  dtype=torch.bfloat16, *, device="cuda"):
    """Stacked KV cache for the attention layers of one layer stack:
    ``{"k", "v"}`` of (n_layers, batch, max_len, kv_dim), zeros;
    ``max_len`` is the positions this rank holds (``S /
    decode_seq_extent()`` of a sequence-sharded decode's S).  Under tensor
    parallelism each rank caches only its KV heads, kv_dim / tp, unless
    the cache is split by sequence over the TP axis
    (:func:`decode_seq_axes`): then it caches all of them."""
    width = cfg.kv_dim if _cache_heads_whole() else cfg.kv_dim // tp.extent()
    shape = (n_layers, batch, max_len, width)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _seq_parallel_decode_attn(q, kc, vc, pos, cfg: ModelConfig, grp,
                              index: int):
    """Decode attention over this rank's slice of a sequence-sharded cache
    (JAX's ``_seq_parallel_decode_attn``).  q: (B, Hkv, R, D); kc/vc: (B,
    Hkv, S_local, D), positions ``index * S_local`` on; pos: (B,).  Each
    rank's masked logits give its max ``m``, sum ``l`` and weighted values
    ``o``; with ``m_g = pmax(m)`` the ranks add ``l e^{m - m_g}`` and ``o
    e^{m - m_g}``, and ``o_g / max(l_g, 1e-30)`` is the attention.
    Returns (B, Hkv, R, D) in q's dtype."""
    s_local = kc.shape[2]
    scale = cfg.head_dim ** -0.5
    logits = torch.matmul(q.float(), kc.float().transpose(2, 3)) * scale
    kpos = index * s_local + torch.arange(s_local, device=q.device)
    past = (kpos[None, :] > pos[:, None])[:, None, None]
    logits = logits.masked_fill(past, -1e30)              # (B, Hkv, R, S)
    m = torch.amax(logits, dim=-1)                        # (B, Hkv, R)
    e = torch.exp(logits - m[..., None])
    l = torch.sum(e, dim=-1)
    o = torch.matmul(e.to(vc.dtype).float(), vc.float())  # (B, Hkv, R, D)
    m_g = tp.pmax(m, grp)
    corr = torch.exp(m - m_g)
    l_g = tp.psum(l * corr, grp)
    o_g = tp.psum(o * corr[..., None], grp)
    return (o_g / torch.clamp_min(l_g[..., None], 1e-30)).to(q.dtype)


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
    on its local heads.

    A cache split by sequence (:func:`decode_seq_axes`) holds positions
    [i S, (i + 1) S) on the rank at index i of those axes; the rank that
    holds ``pos`` writes the token, and the ranks combine by
    :func:`_seq_parallel_decode_attn`.  Where that split spans the TP axis
    (``kv_seq`` over model beside tensor-parallel heads) the projections
    stay column-parallel, the token's q, k and v are all-gathered over
    the TP axis along the heads (O(B H D) a layer), every rank attends
    over all heads of its positions, and the combined output is cut back
    to this rank's heads for the row-parallel ``wo``."""
    bsz = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, pos[:, None])
    rows = torch.arange(bsz, device=x.device)
    seq_axes, mesh = decode_seq_axes()
    s_max = cache_k.shape[1]
    d = cfg.head_dim
    gathered = _cache_heads_whole() and q.shape[2] < cfg.num_heads
    if gathered:
        q, k, v = (tp.all_gather_last(t.reshape(bsz, 1, -1)).reshape(
            bsz, 1, -1, d) for t in (q, k, v))
    if seq_axes is not None:
        # this rank holds positions [index * S, (index + 1) * S): it writes
        # the token only where pos falls there (a gather and a where: no
        # host sync on a mask)
        index = mesh.index(seq_axes)
        local = pos - index * s_max
        ok = ((local >= 0) & (local < s_max))[:, None]
        at = torch.clamp(local, 0, s_max - 1)
        for cache, new in ((cache_k, k), (cache_v, v)):
            cache[rows, at] = torch.where(
                ok, new.reshape(bsz, -1).to(cache.dtype), cache[rows, at])
    else:
        cache_k[rows, pos] = k.reshape(bsz, -1).to(cache_k.dtype)
        cache_v[rows, pos] = v.reshape(bsz, -1).to(cache_v.dtype)

    kc = cache_k.view(bsz, s_max, -1, d).transpose(1, 2)    # (B, Hkv, S, D)
    vc = cache_v.view(bsz, s_max, -1, d).transpose(1, 2)
    g = kc.shape[1]
    qg = q.reshape(bsz, g, -1, d)                           # (B, Hkv, R, D)
    if seq_axes is not None:
        out = _seq_parallel_decode_attn(qg, kc, vc, pos, cfg,
                                        mesh.group(seq_axes), index)
        out = out.reshape(bsz, 1, -1).to(x.dtype)
        if gathered:
            # this rank's heads, for the row-parallel wo
            w = p["wo"].shape[0]
            out = out[..., tp.index() * w:(tp.index() + 1) * w]
        return (row_dense(out, p["wo"], full_in=cfg.q_dim).to(x.dtype),
                cache_k, cache_v)
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
