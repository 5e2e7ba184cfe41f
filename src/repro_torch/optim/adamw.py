"""AdamW over trees of tensors (mirror of ``repro/optim/adamw.py``).

The update keeps the reference's order of operations, all in f32: the
bias corrections ``1 - b ** t`` with ``t`` the f32 step, ``mh = m /
bc1``, and weight decay on every leaf (norms and biases included). The
update is functional: it returns new parameter and moment tensors and
leaves its inputs as they were, so a caller may keep an older state
(``FaultTolerantLoop`` replays from its initial one).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.optim.tree import flatten, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    """Zero moments in f32, shaped like ``params``, on their devices."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return AdamWState(
        torch.zeros((), dtype=torch.int32, device=device),
        tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params))


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.to(torch.float32)))
          for g in tree_leaves(tree)]
    return torch.sqrt(sum(sq))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so their global norm is at most ``max_norm``, the
    norm before scaling)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: AdamWState,
                 lr_scale=1.0):
    """Returns ``(new_params, new_state, {"grad_norm": norm})``, the norm
    taken before clipping."""
    if cfg.grad_clip is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    dev = gnorm.device
    step = state.step + 1
    t = step.to(torch.float32)
    b1, b2 = _f32(cfg.b1, dev), _f32(cfg.b2, dev)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    lr = cfg.lr * _f32(lr_scale, dev)
    c1, c2 = _f32(1 - cfg.b1, dev), _f32(1 - cfg.b2, dev)
    eps, wd = _f32(cfg.eps, dev), _f32(cfg.weight_decay, dev)

    flat_p, unflatten = flatten(params)
    flat_g, flat_m, flat_v = (tree_leaves(t) for t in (grads, state.m,
                                                       state.v))
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        g = g.to(torch.float32)
        m = b1 * m + c1 * g
        v = b2 * v + c2 * torch.square(g)
        mh = m / bc1
        vh = v / bc2
        p32 = p.to(torch.float32)
        p32 = p32 - lr * (mh / (torch.sqrt(vh) + eps) + wd * p32)
        new_p.append(p32.to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return (unflatten(new_p),
            AdamWState(step, unflatten(new_m), unflatten(new_v)),
            {"grad_norm": gnorm})
