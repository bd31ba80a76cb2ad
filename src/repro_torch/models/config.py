"""Model configuration (``repro/models/config.py``, copied: the port keeps
its own copy of every module it needs).

A model is ``num_blocks`` repetitions of a ``block pattern``: a tuple of
layer specs, each naming a mixer ("attn" | "mamba") and a feed-forward
("mlp" | "moe" | none).  Every per-layer parameter carries a leading
``num_blocks`` dim, so the block loop walks one stacked tree.

``remat`` checkpoints each block when autograd is on (training,
``transformer.final_hidden``); ``remat_group`` and ``scan_blocks`` are
kept for parity with the JAX configs and have no effect here (the port
checkpoints per block, and the block stack is a Python loop).
``attn_chunk`` and ``chunked_attn_threshold`` have none either: the
prefill path always runs the flash-attention kernel, which takes every
length in O(S) memory.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str            # "attn" | "mamba"
    ff: Optional[str]     # "mlp" | "moe" | None (mamba blocks may fold FF in)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads

    # attention / norm features
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    logits_softcap: float = 0.0     # grok-style tanh cap (0 = off)
    tie_embeddings: bool = False

    # feed-forward
    activation: str = "silu"        # silu | gelu | squared_relu | relu
    mlp_gated: bool = True          # SwiGLU-style gate

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_layer_period: int = 1       # every p-th layer is MoE (1 = all)
    moe_shared_expert: bool = False
    moe_capacity_factor: float = 1.25
    moe_impl: str = "dispatch"      # dispatch (GShard) | dense (smoke)

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    attn_layer_period: int = 0      # hybrid: 1 attn layer per p layers
    attn_layer_offset: int = 0

    # encoder-decoder
    encoder_layers: int = 0
    decoder_train_frac: int = 8     # train decoder len = seq // frac

    # frontend stubs ([vlm]/[audio]): input_specs() supplies embeddings
    frontend: Optional[str] = None  # "patch" | "frames"
    frontend_tokens: int = 0

    # numerics / lowering
    dtype: str = "bfloat16"
    remat: bool = True
    scan_blocks: bool = True
    # two-level (sqrt-L) remat: scan groups of G blocks, checkpointing at
    # both levels — the (L, B, S, d) carry stack shrinks to (L/G + G)
    # slices at the price of one extra fwd recompute in bwd.  0 = off.
    remat_group: int = 0
    attn_chunk: int = 1024          # chunked-attention block (long prefill)
    chunked_attn_threshold: int = 8192

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)

    # -------------------------------------------------------- pattern ----
    @property
    def block_pattern(self) -> tuple[LayerSpec, ...]:
        if self.family in ("dense", "vlm", "encdec"):
            return (LayerSpec("attn", "mlp"),)
        if self.family == "moe":
            p = self.moe_layer_period
            return tuple(
                LayerSpec("attn", "moe" if (i % p == p - 1) else "mlp")
                for i in range(p))
        if self.family == "ssm":
            return (LayerSpec("mamba", None),)
        if self.family == "hybrid":
            p = self.attn_layer_period
            pattern = []
            for i in range(p):
                mixer = "attn" if i == self.attn_layer_offset else "mamba"
                ff = "moe" if (i % 2 == 1) else "mlp"
                pattern.append(LayerSpec(mixer, ff))
            return tuple(pattern)
        raise ValueError(self.family)

    @property
    def num_blocks(self) -> int:
        pat = len(self.block_pattern)
        assert self.num_layers % pat == 0, (self.num_layers, pat)
        return self.num_layers // pat

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def attn_layers_per_block(self) -> int:
        return sum(1 for s in self.block_pattern if s.mixer == "attn")

    @property
    def mamba_layers_per_block(self) -> int:
        return sum(1 for s in self.block_pattern if s.mixer == "mamba")

    def param_count_estimate(self) -> int:
        """Closed-form parameter count (embeddings + blocks), for docs/tests."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        for spec in self.block_pattern:
            if spec.mixer == "attn":
                total_attn = d * self.q_dim * 2 + d * self.kv_dim * 2
                total += self.num_blocks * total_attn
            else:
                di, ds, nh = self.ssm_d_inner, self.ssm_state, self.ssm_heads
                in_proj = d * (2 * di + 2 * ds + nh)
                out_proj = di * d
                total += self.num_blocks * (in_proj + out_proj
                                            + self.ssm_conv_width
                                            * (di + 2 * ds))
            if spec.ff == "mlp":
                total += self.num_blocks * d * ff * (3 if self.mlp_gated else 2)
            elif spec.ff == "moe":
                e = d * ff * (3 if self.mlp_gated else 2)
                total += self.num_blocks * (
                    self.num_experts * e + d * self.num_experts
                    + (e if self.moe_shared_expert else 0))
        if self.encoder_layers:
            # encoder blocks + decoder cross-attention
            enc_attn = d * self.q_dim * 2 + d * self.kv_dim * 2
            enc_mlp = d * ff * (3 if self.mlp_gated else 2)
            total += self.encoder_layers * (enc_attn + enc_mlp)
            total += self.num_layers * enc_attn  # cross-attn per dec layer
        return total
