"""The engine API of the port (``repro/engine``): one scheduler, one
telemetry surface, one entry point.

    import repro_torch.engine
    eng = repro_torch.engine.build("adaptive_sampling", preset="flowcell_512")
    report = eng.drain()
"""
from repro_torch.engine.registry import (build, presets, register,  # noqa: F401
                                         workloads)
from repro_torch.engine.scheduler import SlotScheduler  # noqa: F401
from repro_torch.engine.telemetry import Telemetry  # noqa: F401
