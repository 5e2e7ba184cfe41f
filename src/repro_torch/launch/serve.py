"""Compatibility module (mirror of ``repro/launch/serve.py``): the
serving runtime lives in :mod:`repro_torch.serving`; these names are
re-exported so ``from repro_torch.launch.serve import Request,
ServingEngine`` works as the reference's import does. The reference
also re-exports ``make_serve_fns``, its jitted prefill/decode artifacts
for a device mesh, which the port has not ported."""
from repro_torch.serving.config import (EngineConfig,             # noqa: F401
                                        SamplingParams)
from repro_torch.serving.engine import Request, ServingEngine     # noqa: F401
