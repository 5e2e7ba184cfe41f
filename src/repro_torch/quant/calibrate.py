"""Static activation-scale calibration (mirror of
``repro/quant/calibrate.py``).

``calibrate_act_scales`` runs a few prefill forwards with the
``layers.mplinear.collect_act_stats`` hook open and turns each
projection's observed input absmax into a symmetric 8-bit scale keyed by
its policy path. Eager torch records directly; the random calibration
batches (tokens, and patches for vlm or frames for encdec) come from
numpy with the seed (the reference draws them with ``jax.random``, so
parity tests pass explicit ``prompts=`` to both). With ``prompts=`` no
patches or frames are passed, as in the reference, so a vlm's or an
encdec's prefill raises KeyError there.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

ACT_BITS = 8
ACT_QMAX = (1 << (ACT_BITS - 1)) - 1


def scales_from_absmax(absmax: Dict[str, float],
                       pct: float = 1.0) -> Dict[str, float]:
    """Observed per-path absolute maxima -> symmetric 8-bit scales."""
    return {path: max(m * pct, 1e-8) / ACT_QMAX
            for path, m in absmax.items()}


@torch.no_grad()
def calibrate_act_scales(cfg, api=None, params=None, *,
                         prompts: Optional[Sequence] = None,
                         n_batches: int = 2, batch: int = 2,
                         seq_len: int = 16, seed: int = 0, pct: float = 1.0,
                         device=None) -> Dict[str, float]:
    """{policy path -> f32 scale} for serving ``cfg`` under its own
    policy. Runs on ``device`` (CUDA by default; raises without it
    unless ``device="cpu"``); ``params`` are moved there if needed."""
    from repro_torch.convert import tree_to
    from repro_torch.device import resolve_device
    from repro_torch.layers import mplinear
    from repro_torch.models import registry

    device = resolve_device(device)
    if api is None:
        api = registry.build(cfg)
    params = (api.init(seed, device) if params is None
              else tree_to(params, device))
    with mplinear.collect_act_stats() as absmax:
        if prompts is not None:
            for p in prompts:
                tokens = torch.as_tensor(p, dtype=torch.int32,
                                         device=device).reshape(1, -1)
                caches = api.init_cache(1, tokens.shape[1], device)
                api.prefill(params, {"tokens": tokens}, caches)
        else:
            for i in range(n_batches):
                cal = registry.calibration_batch(cfg, batch, seq_len,
                                                 seed=seed + i)
                caches = api.init_cache(batch, seq_len, device)
                api.prefill(params, {k: torch.as_tensor(v, device=device)
                                     for k, v in cal.items()}, caches)
    return scales_from_absmax(absmax, pct=pct)
