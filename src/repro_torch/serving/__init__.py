"""Serving runtime of the port: engine, admission scheduler, metrics,
and the fleet router (``router``: replicas that each serve their own
precision policy or ``plan:`` artifact, placed by a static cost model
with optional measured correction). Serve-ready engine checkpoints are
in ``repro_torch.fabric``; its transport, worker and controller are not
ported yet.
"""
from repro_torch.serving.config import (EngineConfig,         # noqa: F401
                                        SamplingParams)
from repro_torch.serving.engine import Request, ServingEngine  # noqa: F401
from repro_torch.serving.metrics import (percentiles,         # noqa: F401
                                         request_metrics, slo_report,
                                         summarize_requests)
from repro_torch.serving.router import (Replica, Router,     # noqa: F401
                                        build_replicas, replica_cost)
from repro_torch.serving.scheduler import (AdmissionScheduler,  # noqa: F401
                                           SchedulerFull)
