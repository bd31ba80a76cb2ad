"""starcoder2-3b [dense]: 30L d=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.

GQA (kv=2) + RoPE per [arXiv:2402.19173; hf].  GELU non-gated MLP.
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b", family="dense",
        num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
        d_ff=12288, vocab_size=49152, head_dim=128, remat_group=6,
        activation="gelu", mlp_gated=False,
        rope_theta=100_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b-smoke", family="dense",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=1,
        d_ff=128, vocab_size=256, head_dim=16,
        activation="gelu", mlp_gated=False, remat=False,
        chunked_attn_threshold=64, attn_chunk=32,
    )


SPEC = ArchSpec(
    config=config, smoke_config=smoke_config,
    fsdp=False,
    grad_accum={"train_4k": 8},
)
