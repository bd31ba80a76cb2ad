"""Real-time adaptive-sampling (Read-Until) runtime (``repro/realtime``).

  session.py   per-channel read sessions + completed-read records
  policy.py    ACCEPT / EJECT / WAIT decision rule + configuration
  mapper.py    prefix mapping against a target panel (FM-index + banded DP)
  runtime.py   batched stateful streaming runtime over a channel pool
"""
from repro_torch.realtime.mapper import (MapResult, PrefixMapper,  # noqa: F401
                                         PREFIX_ALIGN_CFG, TargetPanel)
from repro_torch.realtime.policy import (Decision, PolicyConfig,  # noqa: F401
                                         decide)
from repro_torch.realtime.runtime import (AdaptiveSamplingRuntime,  # noqa: F401
                                          build_step_fn, init_lane_state)
from repro_torch.realtime.session import (ChannelSession, ReadRecord,  # noqa: F401
                                          SimulatedRead)
