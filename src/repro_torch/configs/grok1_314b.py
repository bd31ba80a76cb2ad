"""grok-1-314b [moe]: 64L d=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2 [hf:xai-org/grok-1].

Grok-1 features: every layer MoE, gated GELU experts, 30.0 tanh logits
softcap.  8 experts do not divide the 16-wide data axis, so expert
parallelism is off; the d_model dim of expert weights FSDP-shards over data
instead (rules_overrides).
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family="moe",
        num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=32768, vocab_size=131072, head_dim=128, remat_group=8,
        activation="gelu", mlp_gated=True, logits_softcap=30.0,
        num_experts=8, experts_per_token=2, moe_layer_period=1,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-smoke", family="moe",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        activation="gelu", mlp_gated=True, logits_softcap=30.0,
        num_experts=4, experts_per_token=2, moe_layer_period=1,
        moe_impl="dense", remat=False,
        chunked_attn_threshold=64, attn_chunk=32,
    )


SPEC = ArchSpec(
    config=config, smoke_config=smoke_config,
    fsdp=True,
    rules_overrides={"expert": None, "embed": ("data",)},
    grad_accum={"train_4k": 8},
    optimizer_state_dtype="bfloat16",
    grad_accum_dtype="bfloat16",
)
