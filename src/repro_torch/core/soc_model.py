"""The paper's SoC energy model, the part the basecalling engines report
(``repro/core/soc_model.py``): ``SoCSpec``, the CNN's MACs per sample and
the ``soc_energy_*`` summary block.

The constants are the paper's (Sec III: 22-nm FDSOI, 4x4 systolic MAT at
250 MHz, 50 mW) and the per-MAC energies of the JAX package's model, so an
engine's summary carries the same modelled SoC energy in both packages.
These are figures for the paper's edge SoC, not for the card the port runs
on.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.basecaller import BasecallerConfig


@dataclasses.dataclass(frozen=True)
class SoCSpec:
    """Constants lifted from the paper (Sec III unless noted)."""
    clock_hz: float = 250e6
    power_w: float = 0.050
    mat_dim: int = 4                       # 4x4 systolic array
    n_cores: int = 2
    core_flops_per_cycle: float = 2.0      # in-order RV64 + FPU (FMA)
    sram_bytes: int = 700 * 1024
    area_mm2: float = 5.0
    process_nm: int = 22
    # paper-reported ratios (validation targets, not inputs)
    mat_speedup_reported: float = 15.0
    mat_energy_eff_reported: float = 13.0
    ed_speedup_reported: float = 40.0
    ed_kbase_per_s_reported: float = 900.0
    # ED engine: one PE per anti-diagonal cell of a 100-base comparison
    ed_pes: int = 100
    ed_overhead_cycles: float = 26_900.0
    core_cycles_per_dp_cell: float = 217.0
    # MAC energy by datapath precision (J/MAC), Horowitz ISSCC'14 (45 nm)
    # with fp32 trimmed so fp32:int8 lands on the paper's ~13x
    mac_energy_fp32_j: float = 4.0e-12
    mac_energy_bf16_j: float = 1.3e-12
    mac_energy_int8_j: float = 0.3e-12


def basecaller_macs_per_sample(
        cfg: BasecallerConfig = BasecallerConfig()) -> float:
    """MACs per raw input sample for the CNN."""
    macs = 0.0
    stride_prod = 1
    cin = cfg.in_channels
    for k, cout, s in zip(cfg.kernels, cfg.channels, cfg.strides):
        stride_prod *= s
        macs += k * cin * cout / stride_prod
        cin = cout
    return macs


def energy_summary(params, bc_cfg, n_samples: float) -> dict:
    """Telemetry block shared by the basecalling engines: the datapath
    precision the params imply (stored int8 -> the fixed-point MAC path)
    and the modelled SoC energy for the samples processed."""
    from repro_torch.quant.params import params_precision
    precision = params_precision(params)
    model = SoCModel(bc_cfg=bc_cfg)
    return {
        "soc_energy_precision": precision,
        "soc_energy_est_j": model.basecall_energy_j(n_samples, precision),
        "soc_energy_ratio_vs_fp32": (model.mac_energy_j("fp32")
                                     / model.mac_energy_j(precision)),
    }


class SoCModel:
    """The energy half of the JAX package's ``SoCModel``."""

    def __init__(self, soc: SoCSpec = SoCSpec(),
                 bc_cfg: BasecallerConfig = BasecallerConfig(),
                 samples_per_base: float = 9.0):
        self.soc = soc
        self.bc_cfg = bc_cfg
        self.samples_per_base = samples_per_base

    def mac_energy_j(self, precision: str = "fp32") -> float:
        """Modelled energy per MAC on the named datapath precision."""
        table = {
            "fp32": self.soc.mac_energy_fp32_j,
            "float32": self.soc.mac_energy_fp32_j,
            "bf16": self.soc.mac_energy_bf16_j,
            "bfloat16": self.soc.mac_energy_bf16_j,
            "int8": self.soc.mac_energy_int8_j,
        }
        if precision not in table:
            raise ValueError(f"unknown precision {precision!r}; "
                             f"one of {sorted(set(table))}")
        return table[precision]

    def basecall_energy_j(self, n_samples: float,
                          precision: str = "fp32") -> float:
        """Modelled MAC energy to basecall ``n_samples`` raw samples with
        this CNN at the given datapath precision."""
        return (basecaller_macs_per_sample(self.bc_cfg) * n_samples
                * self.mac_energy_j(precision))
