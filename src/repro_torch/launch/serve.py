"""Compatibility module (mirror of ``repro/launch/serve.py``): the
serving runtime lives in :mod:`repro_torch.serving`; these names are
re-exported so ``from repro_torch.launch.serve import Request,
ServingEngine, make_serve_fns`` works as the reference's import does.
``make_serve_fns`` gives the prefill and decode steps on a device mesh
(``serving.engine``)."""
from repro_torch.serving.config import (EngineConfig,             # noqa: F401
                                        SamplingParams)
from repro_torch.serving.engine import (Request,                  # noqa: F401
                                        ServingEngine, make_serve_fns)
