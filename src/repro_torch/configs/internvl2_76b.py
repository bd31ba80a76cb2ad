"""internvl2-76b [vlm]: 80L d=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.

InternViT + LLM backbone per [arXiv:2404.16821].  Per the assignment spec the
vision frontend is a STUB: input_specs() supplies 256 precomputed patch
embeddings (B, 256, d_model) that replace the first 256 token positions.
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b", family="vlm",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=28672, vocab_size=128256, head_dim=128, remat_group=8,
        activation="silu", mlp_gated=True,
        frontend="patch", frontend_tokens=256,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b-smoke", family="vlm",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        activation="silu", mlp_gated=True, remat=False,
        frontend="patch", frontend_tokens=8,
        chunked_attn_threshold=64, attn_chunk=32,
    )


SPEC = ArchSpec(
    config=config, smoke_config=smoke_config,
    fsdp=True,
    grad_accum={"train_4k": 8},
    optimizer_state_dtype="bfloat16",
)
