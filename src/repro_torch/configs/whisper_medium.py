"""whisper-medium [audio]: 24L d=1024 16H (MHA kv=16) d_ff=4096 vocab=51865.

Encoder-decoder with conv frontend STUB per the assignment spec:
input_specs() supplies precomputed frame embeddings (B, S, d_model) to the
encoder [arXiv:2212.04356].  24 encoder + 24 decoder layers, GELU non-gated
MLP; RoPE replaces absolute positions (DESIGN.md hardware-adaptation note).
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="encdec",
        num_layers=24, encoder_layers=24,
        d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=4096, vocab_size=51865, head_dim=64,
        activation="gelu", mlp_gated=False,
        frontend="frames", decoder_train_frac=8,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium-smoke", family="encdec",
        num_layers=2, encoder_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16,
        activation="gelu", mlp_gated=False, remat=False,
        frontend="frames", decoder_train_frac=8,
        chunked_attn_threshold=64, attn_chunk=32,
    )


SPEC = ArchSpec(
    config=config, smoke_config=smoke_config,
    fsdp=False,
    grad_accum={"train_4k": 4},
)
