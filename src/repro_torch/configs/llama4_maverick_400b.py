"""llama4-maverick-400b-a17b [moe]: 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128 experts top-1 + shared expert.

Per [hf:meta-llama/Llama-4-*]: MoE layers interleave with dense layers
(moe_layer_period=2) and each MoE layer adds a shared expert — with the
listed dims this lands at ~400B total / ~17B active (DESIGN.md Sec 4).
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
        d_ff=8192, vocab_size=202048, head_dim=128, remat_group=6,
        activation="silu", mlp_gated=True,
        num_experts=128, experts_per_token=1, moe_layer_period=2,
        moe_shared_expert=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-smoke", family="moe",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        activation="silu", mlp_gated=True, remat=False,
        num_experts=8, experts_per_token=1, moe_layer_period=2,
        moe_shared_expert=True, moe_impl="dense",
        chunked_attn_threshold=64, attn_chunk=32,
    )


SPEC = ArchSpec(
    config=config, smoke_config=smoke_config,
    fsdp=True,
    rules_overrides={"expert": "data"},
    grad_accum={"train_4k": 8},
    optimizer_state_dtype="bfloat16",
    grad_accum_dtype="bfloat16",
)
