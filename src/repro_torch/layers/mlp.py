"""Gated MLP (SwiGLU / GeGLU) under the mixed-precision policy (mirror
of ``repro/layers/mlp.py``)."""
from __future__ import annotations

import torch

from repro_torch.layers.common import Generator, activation, dense_init
from repro_torch.layers.mplinear import mp_linear


def init(generator: Generator, d_model: int, d_ff: int, device,
         dtype=torch.float32, lead=()):
    return {
        "w_gate": {"w": dense_init(generator, d_model, d_ff, device, dtype,
                                   lead)},
        "w_up": {"w": dense_init(generator, d_model, d_ff, device, dtype,
                                 lead)},
        "w_down": {"w": dense_init(generator, d_ff, d_model, device, dtype,
                                   lead)},
    }


def forward(params, x, policy, path: str, act: str = "silu"):
    fn = activation(act)
    g = mp_linear(params["w_gate"], x, policy.spec_for(f"{path}/w_gate"),
                  path=f"{path}/w_gate")
    u = mp_linear(params["w_up"], x, policy.spec_for(f"{path}/w_up"),
                  path=f"{path}/w_up")
    h = fn(g.to(torch.float32)).to(u.dtype) * u
    return mp_linear(params["w_down"], h, policy.spec_for(f"{path}/w_down"),
                     path=f"{path}/w_down")
