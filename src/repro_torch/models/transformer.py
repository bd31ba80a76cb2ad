"""Decoder-only LM over block patterns: the prefill and decode paths
(``repro/models/transformer.py``).

The layer stack is ``num_blocks`` x ``block_pattern`` (see config.py).
Every per-layer parameter carries a leading ``num_blocks`` dim, as in JAX,
so JAX's tree carries across one to one (``param.load_numpy_params``); the
block loop is a Python loop over that dim.

  init(gen, cfg, device=...) -> (params, axes)
  apply(params, tokens, cfg, ...) -> (logits, aux)
  loss_fn(params, batch, cfg) -> (loss, metrics)           (train)
  init_cache(cfg, batch, max_len, device=...) -> cache      (serve)
  serve_step(params, cache, tokens, pos, cfg) -> (logits, cache)

``serve_step`` updates the cache in place, at ``pos`` for each row.
With ``cfg.remat`` and autograd on, each block runs under
``torch.utils.checkpoint`` (non-reentrant), as JAX's ``jax.checkpoint``
with ``nothing_saveable``: the backward recomputes the block, so a
training step launches each of its kernels twice.  ``remat_group``
(JAX's two-level sqrt-L remat) only shapes memory; the port checkpoints
per block whatever the group.

Tensor parallelism (:mod:`repro_torch.distributed.tp`): inside a
``tp.axis_ctx`` with this rank's slice of the params (``tp.build_plan``),
``serve_step`` gathers the vocab-parallel logits on every rank and
``loss_fn`` takes JAX's ``parallel_vocab`` branch, the sharded-softmax
``parallel_cross_entropy`` over ungathered logits.  A stacked
:class:`~repro_torch.quant.QuantizedTensor` (``quantize_params(...,
stack_dims=1)``) indexes payload, scales and act scale together by block.

A ``moe`` feed-forward (the MoE family, and every odd layer of the
hybrid) runs :func:`repro_torch.models.moe.moe`, whose load-balance loss
``apply`` sums into ``aux``; ``input_embeds`` (the VLM frontend's patch
embeddings) replace the first embedding rows in ``apply`` and
``loss_fn``.

On a (data, model) mesh (``tp.mesh_ctx``, ``sharding.mesh_plan``) each
rank holds its blocks of the leaves, and every reader takes them through
``tp.gathered``: a block's at the top of its body (inside the checkpointed
region, so that under remat the backward gathers again), the embedding,
the final norm and the unembedding where they are used.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.distributed import tp
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ParamBuilder, ScopedBuilder, torch_dtype


class _StackedBuilder:
    """Wraps a ScopedBuilder: every param gains a leading num_blocks dim,
    with the fan-in scale of the unstacked shape."""

    def __init__(self, inner: ScopedBuilder, n: int):
        self._inner = inner
        self._n = n

    def scope(self, name):
        return _StackedBuilder(self._inner.scope(name), self._n)

    def param(self, name, shape, axes, *, init="normal", scale=None,
              dtype=None):
        if init == "normal" and scale is None:
            fan_in = shape[0] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / (max(fan_in, 1) ** 0.5)
        return self._inner.param(name, (self._n,) + tuple(shape),
                                 (None,) + tuple(axes), init=init,
                                 scale=scale, dtype=dtype)


def _init_block_stack(b: ScopedBuilder, cfg: ModelConfig, n_blocks: int,
                      *, cross_attention: bool = False):
    sb = _StackedBuilder(b, n_blocks)
    for li, spec in enumerate(cfg.block_pattern):
        lb = sb.scope(f"l{li}")
        L.init_rmsnorm(lb.scope("norm1"), cfg.d_model)
        if spec.mixer == "attn":
            attn.init_attention(lb.scope("attn"), cfg)
        else:
            mamba2.init_mamba(lb.scope("mamba"), cfg)
        if cross_attention:
            L.init_rmsnorm(lb.scope("norm_x"), cfg.d_model)
            attn.init_attention(lb.scope("xattn"), cfg)
        if spec.ff is not None:
            L.init_rmsnorm(lb.scope("norm2"), cfg.d_model)
            if spec.ff == "mlp":
                L.init_mlp(lb.scope("mlp"), cfg)
            else:
                moe_mod.init_moe(lb.scope("moe"), cfg)


def init(gen: torch.Generator, cfg: ModelConfig, *, device="cuda"):
    """Random parameters from ``gen`` (a generator on ``device``) and their
    logical axes: ``(params, axes)``, the trees of JAX's ``init``.
    ``device="meta"`` (``gen`` None) builds shapes only."""
    pb = ParamBuilder(gen, dtype=torch_dtype(cfg.dtype), device=device)
    L.init_embedding(pb.scope("embedding"), cfg)
    _init_block_stack(pb.scope("blocks"), cfg, cfg.num_blocks)
    L.init_rmsnorm(pb.scope("final_norm"), cfg.d_model)
    return pb.params, pb.axes


def abstract_params(cfg: ModelConfig, init_fn=None):
    """``(shapes, axes)``: the params tree as tensors on the ``meta``
    device (shapes and dtypes, nothing allocated, so a full-width plan
    costs no memory) and its logical axes."""
    return (init_fn or init)(None, cfg, device="meta")


def block_params(blocks: dict, i: int) -> dict:
    """Block ``i`` of the stacked tree (views, no copy; a stacked
    QuantizedTensor indexes its scales with its payload)."""
    return {k: block_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def unstacked(blocks: dict, n: int) -> list:
    """The stacked tree as ``n`` per-block trees of views, each tensor
    leaf split by one ``torch.unbind``: its gradient is one stack of the
    blocks' gradients, where ``n`` indexings would each add a zero-padded
    copy of the whole leaf."""
    out = [{} for _ in range(n)]
    for k, v in blocks.items():
        if isinstance(v, dict):
            parts = unstacked(v, n)
        elif isinstance(v, torch.Tensor):
            parts = torch.unbind(v, 0)
        else:
            parts = [v[i] for i in range(n)]
        for o, part in zip(out, parts):
            o[k] = part
    return out


# ------------------------------------------------------------- forward ---
def embedding_for(params, cfg: ModelConfig, use: str) -> dict:
    """The embedding leaf ``use`` reads (``"embed"``: the lookup;
    ``"unembed"``: the unembedding, the table itself where tied), as
    ``L.embed``/``L.unembed`` take it, gathered on a mesh
    (``tp.gathered``)."""
    key = "embed" if use == "embed" or cfg.tie_embeddings else "unembed"
    return tp.gathered({key: params["embedding"][key]}, "embedding")


def _block_fn(bp, x, cfg: ModelConfig, positions, aux):
    # inside the checkpointed region: under remat the backward gathers again
    bp = tp.gathered(bp, "blocks", stacked=True)
    for li, spec in enumerate(cfg.block_pattern):
        lp = bp[f"l{li}"]
        h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
        if spec.mixer == "attn":
            h = attn.attention_block(lp["attn"], h, cfg, positions,
                                     causal=True)
        else:
            h, _ = mamba2.mamba_block(lp["mamba"], h, cfg)
        x = x + h
        if spec.ff is not None:
            h = L.rmsnorm(lp["norm2"], x, cfg.norm_eps)
            if spec.ff == "mlp":
                h = L.mlp(lp["mlp"], h, cfg)
            else:
                h, a = moe_mod.moe(lp["moe"], h, cfg)
                aux = aux + a
            x = x + h
    return x, aux


def final_hidden(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                 input_embeds: Optional[torch.Tensor] = None,
                 positions: Optional[torch.Tensor] = None,
                 last_only: bool = False):
    """The unembedding's input: the stack's output after the final norm,
    (B, S, d), or (B, 1, d) with ``last_only``; arguments as
    :func:`apply`'s."""
    x = L.embed(embedding_for(params, cfg, "embed"), tokens, cfg)
    if input_embeds is not None:
        f = input_embeds.shape[1]
        x = torch.cat([input_embeds.to(x.dtype), x[:, f:]], dim=1)
    if positions is None:
        positions = torch.arange(tokens.shape[1],
                                 device=tokens.device).expand(tokens.shape)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for bp in unstacked(params["blocks"], cfg.num_blocks):
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                _block_fn, bp, x, cfg, positions, aux, use_reentrant=False)
        else:
            x, aux = _block_fn(bp, x, cfg, positions, aux)
    if last_only:
        x = x[:, -1:]
    return L.rmsnorm(tp.gathered(params["final_norm"], "final_norm"), x,
                     cfg.norm_eps), aux


def apply(params, tokens: torch.Tensor, cfg: ModelConfig, *,
          input_embeds: Optional[torch.Tensor] = None,
          positions: Optional[torch.Tensor] = None,
          last_logits_only: bool = False,
          gather_logits: bool = True):
    """tokens: (B, S) -> (logits (B, S, V), aux).  ``input_embeds`` (B, F,
    d) overrides the first F embedding rows (VLM/audio frontends).
    ``last_logits_only`` unembeds just the final position (prefill: a (B,
    32k, V) logits tensor must never materialise).  ``gather_logits=False``
    leaves tensor-parallel logits as this rank's vocab slice."""
    x, aux = final_hidden(params, tokens, cfg, input_embeds=input_embeds,
                          positions=positions, last_only=last_logits_only)
    return L.unembed(embedding_for(params, cfg, "unembed"), x, cfg,
                     gather=gather_logits), aux


def loss_fn(params, batch: dict, cfg: ModelConfig, *, aux_weight=0.01):
    """Next-token cross entropy (``repro/models/transformer.py``):
    ``batch`` holds ``tokens`` and ``labels`` (B, S) and optionally
    ``loss_mask`` (B, S) and ``input_embeds`` (B, F, d); the NLL of a
    float32 ``log_softmax`` over the logits (under tensor parallelism
    ``parallel_cross_entropy``), averaged over the masked-in positions.
    Returns ``(total, {"nll", "moe_aux"})``, ``total = nll + aux_weight *
    moe_aux``."""
    parallel_vocab = tp.axis() is not None
    logits, aux = apply(params, batch["tokens"], cfg,
                        input_embeds=batch.get("input_embeds"),
                        gather_logits=not parallel_vocab)
    labels = batch["labels"].long()
    if parallel_vocab and logits.shape[-1] < cfg.vocab_size:
        # sharded-softmax cross entropy: the statistics all-reduce over the
        # vocab shards, the full logit row never exists
        nll = L.parallel_cross_entropy(logits, labels)
    elif logits.shape[-1] < cfg.vocab_size:
        raise ValueError(
            f"loss_fn: logits over {logits.shape[-1]} of {cfg.vocab_size} "
            "vocab entries outside a tensor-parallel context (a sliced "
            "unembedding needs tp.axis_ctx and the other ranks)")
    else:
        lp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(lp, -1, labels[..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is None:
        loss = nll.mean()
    else:
        mask = mask.to(nll.dtype)
        loss = (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    total = loss + aux_weight * aux
    return total, {"nll": loss, "moe_aux": aux}


# -------------------------------------------------------------- decode ---
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device="cuda") -> dict:
    """Zeroed decode caches on ``device``: ``k``/``v`` (num_blocks, attn
    layers a block, batch, max_len, kv_dim) and ``conv``/``ssm``
    (num_blocks, mamba layers a block, ...), as JAX's.  The dtype follows
    the model's (a float32 model must not round its KV and conv state
    through bf16); the SSM state is float32 always."""
    dtype = torch_dtype(cfg.dtype if dtype is None else dtype)
    cache: dict = {}
    nb = cfg.num_blocks
    na = cfg.attn_layers_per_block
    nm = cfg.mamba_layers_per_block
    if na:
        kv = attn.init_kv_cache(cfg, batch, max_len, nb * na, dtype,
                                device=device)
        cache["k"] = kv["k"].reshape((nb, na) + kv["k"].shape[1:])
        cache["v"] = kv["v"].reshape((nb, na) + kv["v"].shape[1:])
    if nm:
        mc = mamba2.init_mamba_cache(cfg, batch, nb * nm, dtype,
                                     device=device)
        cache["conv"] = mc["conv"].reshape((nb, nm) + mc["conv"].shape[1:])
        cache["ssm"] = mc["ssm"].reshape((nb, nm) + mc["ssm"].shape[1:])
    return cache


def cache_specs(cfg: ModelConfig) -> dict:
    """Logical axes of the cache leaves (JAX's names)."""
    out = {}
    if cfg.attn_layers_per_block:
        out["k"] = (None, None, "batch", "kv_seq", "kv_heads")
        out["v"] = (None, None, "batch", "kv_seq", "kv_heads")
    if cfg.mamba_layers_per_block:
        out["conv"] = (None, None, "batch", None, "ssm_inner")
        out["ssm"] = (None, None, "batch", None, None)
    return out


def serve_step(params, cache: dict, tokens: torch.Tensor, pos: torch.Tensor,
               cfg: ModelConfig):
    """One decode step.  tokens: (B, 1), pos: (B,) -> (logits (B, 1, V),
    cache).  Each layer's KV rows are written at ``pos`` and its conv and
    SSM state replaced, in place in ``cache``, which is returned."""
    x = L.embed(embedding_for(params, cfg, "embed"), tokens, cfg)
    for i in range(cfg.num_blocks):
        bp = tp.gathered(block_params(params["blocks"], i), "blocks",
                         stacked=True)
        ai = mi = 0
        for li, spec in enumerate(cfg.block_pattern):
            lp = bp[f"l{li}"]
            h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
            if spec.mixer == "attn":
                h, _, _ = attn.decode_attention(
                    lp["attn"], h, cfg, cache["k"][i, ai],
                    cache["v"][i, ai], pos)
                ai += 1
            else:
                h, nc, ns = mamba2.mamba_decode(
                    lp["mamba"], h, cfg, cache["conv"][i, mi],
                    cache["ssm"][i, mi])
                cache["conv"][i, mi].copy_(nc)
                cache["ssm"][i, mi].copy_(ns)
                mi += 1
            x = x + h
            if spec.ff is not None:
                h = L.rmsnorm(lp["norm2"], x, cfg.norm_eps)
                if spec.ff == "mlp":
                    h = L.mlp(lp["mlp"], h, cfg)
                else:
                    h, _ = moe_mod.moe(lp["moe"], h, cfg)
                x = x + h
    x = L.rmsnorm(tp.gathered(params["final_norm"], "final_norm"), x,
                  cfg.norm_eps)
    return L.unembed(embedding_for(params, cfg, "unembed"), x, cfg), cache
