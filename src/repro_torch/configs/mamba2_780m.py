"""mamba2-780m [ssm]: 48L d=1536 (attention-free) vocab=50280, state=128.

SSD (state-space duality) per [arXiv:2405.21060]: d_inner = 2*d_model = 3072,
head_dim 64 -> 48 SSD heads, n=128 state.  num_heads/num_kv_heads/d_ff are
irrelevant to the stack (attention-free) and set to placeholder values.
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        num_layers=48, d_model=1536, num_heads=12, num_kv_heads=12,
        d_ff=0, vocab_size=50280, head_dim=128, remat_group=8,
        tie_embeddings=True,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv_width=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m-smoke", family="ssm",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=256, head_dim=16,
        tie_embeddings=True, remat=False,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_conv_width=4,
        ssm_chunk=32,
    )


SPEC = ArchSpec(
    config=config, smoke_config=smoke_config,
    fsdp=False,
    grad_accum={"train_4k": 8},
)
