"""The paper's own architecture: the 6-layer CNN basecaller (Sec III)
(``repro/configs/basecaller_soc.py``).

Not part of the LM pool: this is the SoC's workload, exposed beside the
config registry (it stays outside ``ARCHS``, as in JAX).
"""
from repro_torch.core.basecaller import BasecallerConfig


def config() -> BasecallerConfig:
    return BasecallerConfig()


def smoke_config() -> BasecallerConfig:
    return BasecallerConfig(
        kernels=(3, 3, 1), channels=(16, 16, 5), strides=(1, 2, 1))
