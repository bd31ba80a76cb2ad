"""The paper's analytical SoC model, the port against the JAX package: the
same arithmetic on the same constants gives the same floats."""
import dataclasses

import pytest

import torch  # noqa: F401
import torch_port_util  # noqa: F401
from repro.core import basecaller as jbc
from repro.core import soc_model as jsoc
from repro_torch.core import basecaller as tbc
from repro_torch.core import soc_model as tsoc

SMALL = dict(kernels=(3, 3, 1), channels=(16, 16, 5), strides=(1, 2, 1))


def _models(small=False):
    kw = SMALL if small else {}
    return (tsoc.SoCModel(bc_cfg=tbc.BasecallerConfig(**kw)),
            jsoc.SoCModel(bc_cfg=jbc.BasecallerConfig(**kw)))


def test_specs_equal():
    for t, j in ((tsoc.SoCSpec(), jsoc.SoCSpec()),
                 (tsoc.SensorSpec(), jsoc.SensorSpec()),
                 (tsoc.TPUv5eSpec(), jsoc.TPUv5eSpec())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_validate_equals_jax():
    t, j = _models()
    assert t.validate() == j.validate()
    assert all(err < 0.1 for _, _, err in t.validate().values())


@pytest.mark.parametrize("m,n", [(100, 100), (12, 12), (256, 512)])
def test_ed_methods_equal_jax(m, n):
    t, j = _models()
    for name in ("ed_pair_cycles", "ed_pairs_per_s", "ed_kbase_per_s",
                 "ed_speedup"):
        assert getattr(t, name)(m, n) == getattr(j, name)(m, n), name


@pytest.mark.parametrize("small", [False, True])
def test_mat_and_workload_methods_equal_jax(small):
    t, j = _models(small)
    for name in ("mat_macs_per_s", "core_macs_per_s", "mat_speedup",
                 "mat_energy_efficiency", "sensor_ingest_bps",
                 "ingest_vs_audio", "basecaller_gflops_per_sensor",
                 "tpu_sensors_per_chip"):
        assert getattr(t, name)() == getattr(j, name)(), name
    for acc in (True, False):
        assert t.basecall_bases_per_s(acc) == j.basecall_bases_per_s(acc)
        assert t.sensors_served(acc) == j.sensors_served(acc)
    for prec in ("fp32", "bf16", "int8"):
        assert (t.basecall_energy_j(1e6, prec)
                == j.basecall_energy_j(1e6, prec))
    cfg_t = tbc.BasecallerConfig(**(SMALL if small else {}))
    cfg_j = jbc.BasecallerConfig(**(SMALL if small else {}))
    assert (tsoc.basecaller_flops_per_base(cfg_t)
            == jsoc.basecaller_flops_per_base(cfg_j))
