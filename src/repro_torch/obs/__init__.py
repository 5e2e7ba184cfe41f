"""Serving telemetry: the port's own copy of ``repro.obs`` (span tracing,
typed metrics, measured replica stats; numpy only)."""
from repro_torch.obs.registry import (PERCENTILES, Counter,  # noqa: F401
                                      CountersView, Gauge, Histogram,
                                      MetricsRegistry, RollingGauge,
                                      percentile_block)
from repro_torch.obs.stats import ReplicaStats               # noqa: F401
from repro_torch.obs.trace import (Tracer, traced_call,      # noqa: F401
                                   validate_chrome_trace)
