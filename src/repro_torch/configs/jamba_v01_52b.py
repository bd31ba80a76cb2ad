"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
MoE 16 experts top-2, Mamba:attention 7:1 interleave [arXiv:2403.19887; hf].

Block pattern (8 layers, x4): attention at offset 4, Mamba elsewhere; MoE on
odd layers (16 of 32), dense MLP on even.  SSD (Mamba-2-style) replaces
Jamba's Mamba-1 mixer — the TPU-native chunked-matmul formulation
(DESIGN.md hardware-adaptation note); state n=128, d_inner 2*d_model.
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=65536, head_dim=128,
        activation="silu", mlp_gated=True,
        num_experts=16, experts_per_token=2,
        attn_layer_period=8, attn_layer_offset=4,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv_width=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        activation="silu", mlp_gated=True, remat=False,
        num_experts=4, experts_per_token=2, moe_impl="dense",
        attn_layer_period=2, attn_layer_offset=1,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_conv_width=4,
        ssm_chunk=32, chunked_attn_threshold=64, attn_chunk=32,
    )


SPEC = ArchSpec(
    config=config, smoke_config=smoke_config,
    fsdp=True,
    rules_overrides={"expert": "data"},
    grad_accum={"train_4k": 16},
    optimizer_state_dtype="bfloat16",
)
