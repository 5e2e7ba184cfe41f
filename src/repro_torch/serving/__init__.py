"""Serving runtime of the port: engine, admission scheduler, metrics.

The fleet router, checkpoints and fabric wait for later slices.
"""
from repro_torch.serving.config import (EngineConfig,         # noqa: F401
                                        SamplingParams)
from repro_torch.serving.engine import Request, ServingEngine  # noqa: F401
from repro_torch.serving.metrics import (percentiles,         # noqa: F401
                                         request_metrics,
                                         summarize_requests)
from repro_torch.serving.scheduler import (AdmissionScheduler,  # noqa: F401
                                           SchedulerFull)
