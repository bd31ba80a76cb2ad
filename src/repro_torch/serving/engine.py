"""Deprecated import path (``repro/serving/engine.py``): the server shims
live in :mod:`repro_torch.serving.legacy`.  ``from
repro_torch.serving.engine import LMServer`` keeps working (and keeps
warning at construction time)."""
from repro_torch.serving.legacy import (AdaptiveSamplingServer,  # noqa: F401
                                        BasecallServer, LMServer, Request,
                                        _LegacyStatsView)
