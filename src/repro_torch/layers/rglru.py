"""RG-LRU recurrent block (Griffin / RecurrentGemma; mirror of
``repro/layers/rglru.py``).

    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)  (data-dependent decay, c=8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The block is conv1d (width 4) -> RG-LRU inside a gated branch pair.
Prefill runs the recurrence as the reference's ``jax.lax.associative_scan``
does, combining the same pairs in the same order (:func:`_scan_rglru`);
decode is the O(1) recurrence. The gates are f32 products of raw dense
weights (never TF32 on the card).

The state is written IN PLACE: ``forward`` and ``decode_step`` copy the
new ``h`` and conv tail into the :class:`RGLRUState` tensors they are
given and return that same state (a captured CUDA graph reads it by
address). Training calls ``forward(..., write_state=False)``, which
leaves the (fresh zero) state it reads as it is, for autograd, and
returns the new one in new tensors.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import torch

from repro_torch.layers.common import (Generator, activation, dense_init,
                                       rand, randn)
from repro_torch.layers.mplinear import linear_init, mp_linear

_C = 8.0


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    d_rnn: int
    conv_width: int = 4


class RGLRUState(NamedTuple):
    h: torch.Tensor     # (B, d_rnn) f32 recurrent state
    conv: torch.Tensor  # (B, conv_width - 1, d_rnn) conv tail


def init(generator: Generator, cfg: RGLRUConfig, device,
         dtype=torch.float32, lead=()):
    """Seeded random parameters with the reference's tree and
    distributions; Lambda so that the decay a^c lies in [0.9, 0.999]."""
    d, dr = cfg.d_model, cfg.d_rnn

    def lin(d_in, d_out):
        return linear_init(generator, d_in, d_out, False, device, dtype, lead)

    conv_w = randn((*lead, cfg.conv_width, dr), generator, device) * 0.1
    u = rand((*lead, dr), generator, device) * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u) / _C))       # softplus^-1
    zeros = lambda: torch.zeros((*lead, dr), dtype=dtype,  # noqa: E731
                                device=device)
    return {
        "w_in_rnn": lin(d, dr), "w_in_gate": lin(d, dr), "w_out": lin(dr, d),
        "conv_w": conv_w.to(dtype), "conv_b": zeros(),
        "w_a": dense_init(generator, dr, dr, device, dtype, lead),
        "b_a": zeros(),
        "w_x": dense_init(generator, dr, dr, device, dtype, lead),
        "b_x": zeros(),
        "lambda": lam.to(dtype),
    }


def init_state(batch: int, cfg: RGLRUConfig, device, dtype=torch.float32,
               lead=()) -> RGLRUState:
    """Zero state (real tensors per stacked layer, written in place)."""
    return RGLRUState(
        h=torch.zeros((*lead, batch, cfg.d_rnn), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((*lead, batch, cfg.conv_width - 1, cfg.d_rnn),
                         dtype=dtype, device=device))


def _causal_conv(x, w, b, tail):
    """Depthwise causal conv1d. x: (B, S, dr); tail: (B, W-1, dr). The
    taps sum in f32 in the reference's order (tap i takes weight row
    W-1-i)."""
    wdt = x.dtype
    full = torch.cat([tail.to(wdt), x], 1)
    width = w.shape[0]
    s = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + full[:, i:i + s].to(torch.float32) \
            * w[width - 1 - i].to(torch.float32)
    new_tail = full[:, -(width - 1):] if width > 1 else tail
    return (out + b.to(torch.float32)).to(wdt), new_tail


def _softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): no threshold."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _gates(params, xr):
    f32 = torch.float32
    xf = xr.to(f32)
    r = torch.sigmoid(xf @ params["w_a"].to(f32) + params["b_a"].to(f32))
    i = torch.sigmoid(xf @ params["w_x"].to(f32) + params["b_x"].to(f32))
    log_a = -_C * _softplus(params["lambda"].to(f32)) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2 * log_a), min=1e-12)) \
        * (i * xf)
    return a, gated


def _combine(u: List[torch.Tensor], v: List[torch.Tensor]):
    au, bu = u
    av, bv = v
    return [au * av, bu * av + bv]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Rows of ``even`` at 0, 2, 4, ... and of ``odd`` at 1, 3, ... along
    axis 1."""
    n = even.shape[1] + odd.shape[1]
    out = torch.empty((even.shape[0], n, *even.shape[2:]), dtype=even.dtype,
                      device=even.device)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _assoc_scan(elems: List[torch.Tensor]) -> List[torch.Tensor]:
    """``jax.lax.associative_scan(_combine, elems, axis=1)`` with jax's
    recursion: adjacent pairs combined, the reduced sequence scanned,
    then the even positions combined with the scanned odd ones."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:-1:2] for e in elems],
                       [e[:, 1::2] for e in elems])
    odd = _assoc_scan(reduced)
    if n % 2 == 0:
        even = _combine([e[:, 0:-1] for e in odd],
                        [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, 0:1], r], 1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _scan_rglru(a, b, h0):
    """h_t = a_t h_{t-1} + b_t over axis 1. a, b: (B, S, dr)."""
    a_s, b_s = _assoc_scan([a, b])
    h = a_s * h0[:, None] + b_s
    return h, h[:, -1]


def _block(params, x, state: RGLRUState, policy, path, recur,
           write_state=True):
    sp = policy.spec_for
    xr = mp_linear(params["w_in_rnn"], x, sp(f"{path}/w_in_rnn"),
                   path=f"{path}/w_in_rnn")
    gate = mp_linear(params["w_in_gate"], x, sp(f"{path}/w_in_gate"),
                     path=f"{path}/w_in_gate")
    xr, new_tail = _causal_conv(xr, params["conv_w"], params["conv_b"],
                                state.conv)
    a, b = _gates(params, xr)
    h, h_last = recur(a, b, state.h)
    out = h * activation("gelu")(gate.to(torch.float32))
    out = mp_linear(params["w_out"], out.to(x.dtype), sp(f"{path}/w_out"),
                    path=f"{path}/w_out")
    if not write_state:
        return out, RGLRUState(h_last, new_tail)
    state.h.copy_(h_last)
    state.conv.copy_(new_tail)
    return out, state


def forward(params, cfg: RGLRUConfig, x, state: RGLRUState, policy,
            path: str, write_state: bool = True
            ) -> Tuple[torch.Tensor, RGLRUState]:
    """Full recurrent block over (B, S, d)."""
    return _block(params, x, state, policy, path, _scan_rglru, write_state)


def decode_step(params, cfg: RGLRUConfig, x, state: RGLRUState, policy,
                path: str) -> Tuple[torch.Tensor, RGLRUState]:
    """x: (B, 1, d)."""
    def step(a, b, h0):
        h = a[:, 0] * h0 + b[:, 0]
        return h[:, None], h
    return _block(params, x, state, policy, path, step)
