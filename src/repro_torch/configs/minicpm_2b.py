"""minicpm-2b [dense]: 40L d=2304 36H (MHA kv=36) d_ff=5760 vocab=122753.

Llama-like arch; the WSD (warmup-stable-decay) schedule the paper introduces
is implemented in train/optimizer.py and selected by this arch's trainer
defaults [arXiv:2404.06395; hf].
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b", family="dense",
        num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
        d_ff=5760, vocab_size=122753, head_dim=64, remat_group=8,
        tie_embeddings=True, activation="silu", mlp_gated=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b-smoke", family="dense",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16,
        tie_embeddings=True, activation="silu", mlp_gated=True, remat=False,
        chunked_attn_threshold=64, attn_chunk=32,
    )


SPEC = ArchSpec(
    config=config, smoke_config=smoke_config,
    fsdp=False,
    grad_accum={"train_4k": 8},
    schedule="wsd",
)
