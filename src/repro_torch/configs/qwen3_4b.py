"""qwen3-4b [dense]: 36L d=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.

qk_norm + GQA per [hf:Qwen/Qwen3-8B; hf].  head_dim=128 (q_dim 4096 >
d_model, as in Qwen3), RoPE theta 1e6, tied embeddings, SwiGLU.
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b", family="dense",
        num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8,
        d_ff=9728, vocab_size=151936, head_dim=128, remat_group=6,
        qk_norm=True, rope_theta=1e6, tie_embeddings=True,
        activation="silu", mlp_gated=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b-smoke", family="dense",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        qk_norm=True, rope_theta=1e6, tie_embeddings=True,
        activation="silu", mlp_gated=True, remat=False,
        chunked_attn_threshold=64, attn_chunk=32,
    )


SPEC = ArchSpec(
    config=config, smoke_config=smoke_config,
    fsdp=False,
    grad_accum={"train_4k": 8},
)
