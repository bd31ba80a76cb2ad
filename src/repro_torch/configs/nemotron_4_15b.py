"""nemotron-4-15b [dense]: 32L d=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.

GQA + squared-ReLU (non-gated MLP) per [arXiv:2402.16819].
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense",
        num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=24576, vocab_size=256000, head_dim=128, remat_group=8,
        activation="squared_relu", mlp_gated=False,
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b-smoke", family="dense",
        num_layers=4, d_model=96, num_heads=6, num_kv_heads=2,
        d_ff=192, vocab_size=512, head_dim=16,
        activation="squared_relu", mlp_gated=False, remat=False,
        chunked_attn_threshold=64, attn_chunk=32,
    )


SPEC = ArchSpec(
    config=config, smoke_config=smoke_config,
    fsdp=True,
    grad_accum={"train_4k": 8},
)
