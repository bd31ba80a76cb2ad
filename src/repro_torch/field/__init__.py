"""Fleet-scale field deployment (``repro/field``).

N mobile-SoC sequencers at the edge, each running int8 Read-Until locally,
uplinking only their accepted reads as compressed frames to one aggregator
that does the fleet-level genomics — pathogen surveillance and variant
calling — incrementally as evidence accumulates.

  :mod:`repro_torch.field.device`      :class:`EdgeDevice` — flowcell-fed
                                       ``edge_int8`` engine emitting
                                       uplink frames
  :mod:`repro_torch.field.uplink`      the frame codec (2-bit bases, the
                                       shared int8/top-k signal codecs,
                                       telemetry JSON)
  :mod:`repro_torch.field.aggregator`  :class:`AggregatorEngine` — fleet-
                                       hostable ingest, incremental detect
                                       + pileup, telemetry rollups
  :mod:`repro_torch.field.scenario`    :class:`FieldSpec`,
                                       :class:`LossyChannel`,
                                       :func:`run_field_scenario`
"""
from repro_torch.field.aggregator import AggregatorEngine
from repro_torch.field.device import EdgeDevice, calibrated_step_params
from repro_torch.field.scenario import (FieldSpec, LossyChannel, build_field,
                                        run_field_scenario)
from repro_torch.field.uplink import (DecodedRead, UplinkFrame, decode_read,
                                      decode_telemetry, pack_bases,
                                      read_frame, telemetry_frame,
                                      unpack_bases)

__all__ = [
    "AggregatorEngine", "EdgeDevice", "calibrated_step_params",
    "FieldSpec", "LossyChannel", "build_field", "run_field_scenario",
    "DecodedRead", "UplinkFrame", "decode_read", "decode_telemetry",
    "pack_bases", "read_frame", "telemetry_frame", "unpack_bases",
]
