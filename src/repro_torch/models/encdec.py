"""Whisper-style encoder-decoder backbone (``repro/models/encdec.py``).

The conv/mel frontend is a stub, as in JAX: precomputed frame embeddings
(B, S_frames, d_model) go straight into the encoder.  RoPE replaces
Whisper's absolute positions.

Decoder blocks: self-attention (causal) -> cross-attention (the encoder's
K/V) -> MLP.  Serving: the cross-attention K/V are computed once a
request batch (:func:`prefill_cross`) and live in the cache next to the
self-attention K/V.

  init(gen, cfg, device=...) -> (params, axes)
  encode(params, frames, cfg) -> encoder states (B, S, d)
  decode_train(params, enc_out, tokens, cfg) -> logits (B, S_dec, V)
  loss_fn(params, batch, cfg) -> (loss, metrics)
  init_cache(cfg, batch, max_len, enc_len, device=...) -> cache
  prefill_cross(params, cache, enc_out, cfg) -> cache
  serve_step(params, cache, tokens, pos, cfg) -> (logits, cache)

The training path's attention (encoder, decoder self- and cross-) runs
``ops.flash_attention`` (non-causal in the encoder and the
cross-attention, at Sq != Skv in the latter), the MLPs ``ops.mat_mul``:
the Hopper kernels on the card, their plain versions on the CPU.  The
decode cross-attention is :func:`attention.full_attention`, plain ops,
as JAX computes it in jnp.  ``serve_step`` writes the self-attention K/V
in place at ``pos``.

Tensor parallelism (training at ``--mesh DxM``, as JAX's GSPMD step): the
encoder's and decoder's attention and MLP take the decoder families'
column- and row-parallel branches (JAX's ``build_plan`` rules for
``encoder/*``, ``decoder/*/attn``, ``decoder/*/xattn`` and the MLPs), and
``_cross_kv`` projects the replicated encoder states onto this rank's
heads.  Decode under TP is refused, as JAX's TP engine refuses it
(``registry.require_train_and_tp``).
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.distributed import tp
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ParamBuilder, torch_dtype
from repro_torch.models.transformer import (_StackedBuilder, embedding_for,
                                            unstacked)


def init(gen: torch.Generator, cfg: ModelConfig, *, device="cuda"):
    """Random parameters from ``gen`` on ``device`` and their logical
    axes, JAX's tree (``device="meta"``: shapes only)."""
    pb = ParamBuilder(gen, dtype=torch_dtype(cfg.dtype), device=device)
    L.init_embedding(pb.scope("embedding"), cfg)

    enc = _StackedBuilder(pb.scope("encoder"), cfg.encoder_layers)
    eb = enc.scope("l0")
    L.init_rmsnorm(eb.scope("norm1"), cfg.d_model)
    attn.init_attention(eb.scope("attn"), cfg)
    L.init_rmsnorm(eb.scope("norm2"), cfg.d_model)
    L.init_mlp(eb.scope("mlp"), cfg)

    dec = _StackedBuilder(pb.scope("decoder"), cfg.num_blocks)
    db = dec.scope("l0")
    L.init_rmsnorm(db.scope("norm1"), cfg.d_model)
    attn.init_attention(db.scope("attn"), cfg)
    L.init_rmsnorm(db.scope("norm_x"), cfg.d_model)
    attn.init_attention(db.scope("xattn"), cfg)
    L.init_rmsnorm(db.scope("norm2"), cfg.d_model)
    L.init_mlp(db.scope("mlp"), cfg)

    L.init_rmsnorm(pb.scope("enc_final_norm"), cfg.d_model)
    L.init_rmsnorm(pb.scope("final_norm"), cfg.d_model)
    return pb.params, pb.axes


def _stack(body, x, params, name: str, n: int, cfg: ModelConfig):
    """``body(x, layer_params)`` over the ``n`` stacked layers of
    ``params[name]``, each under ``torch.utils.checkpoint`` where
    ``cfg.remat`` and autograd are on (JAX's ``jax.checkpoint`` with
    ``nothing_saveable``); a mesh rank's blocks gathered inside it
    (``tp.gathered``)."""
    remat = cfg.remat and torch.is_grad_enabled()

    def layer(x, l0):
        return body(x, tp.gathered(l0, f"{name}/l0", stacked=True))
    for lp in unstacked(params[name], n):
        if remat:
            x = torch.utils.checkpoint.checkpoint(layer, x, lp["l0"],
                                                  use_reentrant=False)
        else:
            x = layer(x, lp["l0"])
    return x


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, S, d_model) stub embeddings -> encoder states."""
    x = frames.to(torch_dtype(cfg.dtype))
    positions = _positions(x.shape[0], x.shape[1], x.device)

    def body(x, l0):
        h = L.rmsnorm(l0["norm1"], x, cfg.norm_eps)
        x = x + attn.attention_block(l0["attn"], h, cfg, positions,
                                     causal=False)
        h = L.rmsnorm(l0["norm2"], x, cfg.norm_eps)
        return x + L.mlp(l0["mlp"], h, cfg)

    x = _stack(body, x, params, "encoder", cfg.encoder_layers, cfg)
    return L.rmsnorm(tp.gathered(params["enc_final_norm"], "enc_final_norm"),
                     x, cfg.norm_eps)


def _cross_kv(p, enc_out: torch.Tensor, cfg: ModelConfig):
    """The cross-attention K/V of ``enc_out``, (B, S, Hkv, D) each: under
    tensor parallelism this rank's heads (``wk``/``wv`` column-parallel,
    ``enc_out`` replicated)."""
    b, s, _ = enc_out.shape
    k = torch.matmul(enc_out, p["wk"]).reshape(b, s, -1, cfg.head_dim)
    v = torch.matmul(enc_out, p["wv"]).reshape(b, s, -1, cfg.head_dim)
    return k, v


def decode_train(params, enc_out: torch.Tensor, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Teacher-forced decoder pass -> logits (B, S_dec, V)."""
    return L.unembed(embedding_for(params, cfg, "unembed"),
                     decoder_hidden(params, enc_out, tokens, cfg), cfg)


def decoder_hidden(params, enc_out: torch.Tensor, tokens: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """The unembedding's input of :func:`decode_train`: the decoder
    stack's output after the final norm, (B, S_dec, d)."""
    x = L.embed(embedding_for(params, cfg, "embed"), tokens, cfg)
    positions = _positions(tokens.shape[0], tokens.shape[1], x.device)

    def body(x, l0):
        h = L.rmsnorm(l0["norm1"], x, cfg.norm_eps)
        x = x + attn.attention_block(l0["attn"], h, cfg, positions,
                                     causal=True)
        h = L.rmsnorm(l0["norm_x"], x, cfg.norm_eps)
        k, v = _cross_kv(l0["xattn"], enc_out, cfg)
        x = x + attn.attention_block(l0["xattn"], h, cfg, positions,
                                     causal=False, kv_override=(k, v))
        h = L.rmsnorm(l0["norm2"], x, cfg.norm_eps)
        return x + L.mlp(l0["mlp"], h, cfg)

    x = _stack(body, x, params, "decoder", cfg.num_blocks, cfg)
    return L.rmsnorm(tp.gathered(params["final_norm"], "final_norm"), x,
                     cfg.norm_eps)


def loss_fn(params, batch: dict, cfg: ModelConfig, **_):
    """Cross entropy of the decoder's logits over ``batch["frames"]`` (B,
    S, d), ``tokens`` and ``labels`` (B, S_dec): ``(nll, {"nll"})``."""
    enc_out = encode(params, batch["frames"], cfg)
    logits = decode_train(params, enc_out, batch["tokens"], cfg)
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(lp, -1, batch["labels"].long()[..., None])[..., 0]
    return nll.mean(), {"nll": nll.mean()}


# --------------------------------------------------------------- serve ---
def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int,
               dtype=torch.bfloat16, *, device="cuda") -> dict:
    """Zeroed caches, JAX's layout and dtype (bf16 whatever the model's):
    self-attention ``k``/``v`` (num_blocks, 1, batch, max_len, kv_dim) and
    cross-attention ``xk``/``xv`` (num_blocks, batch, enc_len, kv_dim)."""
    nb = cfg.num_blocks
    dtype = torch_dtype(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {"k": zeros(nb, 1, batch, max_len, cfg.kv_dim),
            "v": zeros(nb, 1, batch, max_len, cfg.kv_dim),
            "xk": zeros(nb, batch, enc_len, cfg.kv_dim),
            "xv": zeros(nb, batch, enc_len, cfg.kv_dim)}


def prefill_cross(params, cache: dict, enc_out: torch.Tensor,
                  cfg: ModelConfig) -> dict:
    """The cache with ``xk``/``xv`` replaced by every decoder layer's
    cross-attention K/V of ``enc_out`` (B, S, d), in the cache's dtype:
    once a request batch.  As JAX's, the new leaves take ``enc_out``'s
    length S."""
    b, s, _ = enc_out.shape
    ks, vs = [], []
    for lp in unstacked(params["decoder"], cfg.num_blocks):
        xattn = tp.gathered(lp["l0"]["xattn"], "decoder/l0/xattn",
                            stacked=True)
        k, v = _cross_kv(xattn, enc_out, cfg)
        ks.append(k.reshape(b, s, cfg.kv_dim))
        vs.append(v.reshape(b, s, cfg.kv_dim))
    out = dict(cache)
    out["xk"] = torch.stack(ks).to(cache["xk"].dtype)
    out["xv"] = torch.stack(vs).to(cache["xv"].dtype)
    return out


def serve_step(params, cache: dict, tokens: torch.Tensor, pos: torch.Tensor,
               cfg: ModelConfig):
    """One decoder token against the cached self- and cross-attention K/V.
    tokens: (B, 1), pos: (B,) -> (logits (B, 1, V), cache), the
    self-attention K/V written in place at ``pos``."""
    x = L.embed(embedding_for(params, cfg, "embed"), tokens, cfg)
    b = x.shape[0]
    scale = cfg.head_dim ** -0.5
    for i, lp in enumerate(unstacked(params["decoder"], cfg.num_blocks)):
        l0 = tp.gathered(lp["l0"], "decoder/l0", stacked=True)
        h = L.rmsnorm(l0["norm1"], x, cfg.norm_eps)
        h, _, _ = attn.decode_attention(l0["attn"], h, cfg, cache["k"][i, 0],
                                        cache["v"][i, 0], pos)
        x = x + h
        # cross-attention against the whole cached encoder K/V
        h = L.rmsnorm(l0["norm_x"], x, cfg.norm_eps)
        q, _, _ = attn._project_qkv(l0["xattn"], h, cfg, pos[:, None],
                                    apply_rope=False, q_only=True)
        kc = cache["xk"][i].reshape(b, -1, cfg.num_kv_heads, cfg.head_dim)
        vc = cache["xv"][i].reshape(b, -1, cfg.num_kv_heads, cfg.head_dim)
        out = attn.full_attention(q, kc, vc, causal=False, scale=scale)
        out = out.reshape(b, 1, cfg.q_dim)
        wo = l0["xattn"]["wo"]
        dt = torch.promote_types(out.dtype, wo.dtype)
        x = x + torch.matmul(out.to(dt), wo.to(dt))
        h = L.rmsnorm(l0["norm2"], x, cfg.norm_eps)
        x = x + L.mlp(l0["mlp"], h, cfg)
    x = L.rmsnorm(tp.gathered(params["final_norm"], "final_norm"), x,
                  cfg.norm_eps)
    return L.unembed(embedding_for(params, cfg, "unembed"), x, cfg), cache
