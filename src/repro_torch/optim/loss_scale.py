"""Dynamic loss scaling for FP16-arithmetic training (mirror of
``repro/optim/loss_scale.py``).

The scale doubles every ``growth_interval`` clean steps and halves on a
non-finite gradient, whose update is skipped. Every quantity stays a
tensor, so a step decides without a host sync."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.optim.tree import tree_leaves
from repro_torch.parallel import act_sharding as act


class LossScaleState(NamedTuple):
    scale: torch.Tensor        # () f32
    good_steps: torch.Tensor   # () int32


def loss_scale_init(initial: float = 2.0 ** 15,
                    device=None) -> LossScaleState:
    return LossScaleState(
        torch.tensor(initial, dtype=torch.float32, device=device),
        torch.zeros((), dtype=torch.int32, device=device))


def grads_finite(grads) -> torch.Tensor:
    """() bool: every element of every leaf is finite."""
    fin = None
    for g in tree_leaves(grads):
        bad = act.local_sum(g, lambda t: torch.sum(
            ~torch.isfinite(t.to(torch.float32)), dtype=torch.int32))
        ok = bad == 0
        fin = ok if fin is None else fin & ok
    return torch.tensor(True) if fin is None else fin


def loss_scale_update(state: LossScaleState, finite: torch.Tensor,
                      growth_interval: int = 2000,
                      factor: float = 2.0,
                      min_scale: float = 1.0,
                      max_scale: float = 2.0 ** 24) -> LossScaleState:
    finite = torch.as_tensor(finite, device=state.scale.device)
    grow = (state.good_steps + 1) >= growth_interval
    new_scale = torch.where(
        finite,
        torch.where(grow, torch.clamp(state.scale * factor, max=max_scale),
                    state.scale),
        torch.clamp(state.scale / factor, min=min_scale))
    new_good = torch.where(finite & ~grow, state.good_steps + 1,
                           torch.zeros_like(state.good_steps))
    return LossScaleState(new_scale, new_good.to(torch.int32))
