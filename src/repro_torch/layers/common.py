"""Shared building blocks: initializers, norms, RoPE, activation
(mirror of ``repro/layers/common.py``)."""
from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

# an init's source of draws (``seeded_generator``)
Generator = Union[torch.Generator, np.random.Generator]


def seeded_generator(seed: int, device, draws: str = "torch"):
    """The source of an init's random draws. ``draws="torch"``: a
    ``torch.Generator`` on ``device``, seeded ``seed`` (its bits depend
    on the device and on the torch build). ``draws="numpy"``: numpy's
    PCG64 seeded ``seed``, drawn in float64 on the host and moved to
    ``device``, so every device and installation draws the same weights
    (slower: for small models)."""
    if draws == "numpy":
        return np.random.default_rng(seed)
    if draws != "torch":
        raise ValueError(f"draws must be 'torch' or 'numpy', got {draws!r}")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _from_numpy(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.float32)).to(device)


def _trunc_normal(shape, generator: Generator, device) -> torch.Tensor:
    if isinstance(generator, np.random.Generator):
        # redraw what falls outside +-3 until nothing does
        x = generator.standard_normal(shape)
        out = np.abs(x) > 3.0
        while out.any():
            x[out] = generator.standard_normal(int(out.sum()))
            out = np.abs(x) > 3.0
        return _from_numpy(x, device)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0,
                                       generator=generator)


def randn(shape, generator: Generator, device) -> torch.Tensor:
    """Standard normal f32 draws from either source."""
    if isinstance(generator, np.random.Generator):
        return _from_numpy(generator.standard_normal(shape), device)
    return torch.randn(shape, generator=generator, device=device)


def rand(shape, generator: Generator, device) -> torch.Tensor:
    """Uniform [0, 1) f32 draws from either source."""
    if isinstance(generator, np.random.Generator):
        return _from_numpy(generator.random(shape), device)
    return torch.rand(shape, generator=generator, device=device)


def dense_init(generator: Generator, d_in: int, d_out: int,
               device, dtype=torch.float32, lead=(),
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated normal at +-3 sigma times ``1/sqrt(d_in)`` (the
    reference's distribution; the bits differ from jax.random's)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (_trunc_normal((*lead, d_in, d_out), generator, device)
            * scale).to(dtype)


def embed_init(generator: Generator, vocab: int, d: int, device,
               dtype=torch.float32) -> torch.Tensor:
    return (_trunc_normal((vocab, d), generator, device)
            * (d ** -0.5)).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = False) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = weight.to(torch.float32)
    if zero_centered:
        w = 1.0 + w
    return (x * w).to(dt)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    x = x * weight.to(torch.float32)
    if bias is not None:
        x = x + bias.to(torch.float32)
    return x.to(dt)


def apply_norm(kind: str, x, params, eps=1e-6):
    if kind == "rms":
        return rms_norm(x, params["w"], eps)
    if kind == "rms_zc":
        return rms_norm(x, params["w"], eps, zero_centered=True)
    if kind == "ln":
        return layer_norm(x, params["w"], params.get("b"), eps)
    raise ValueError(kind)


def norm_init(kind: str, d: int, device, dtype=torch.float32, lead=()):
    if kind == "rms":
        return {"w": torch.ones((*lead, d), dtype=dtype, device=device)}
    if kind == "rms_zc":
        return {"w": torch.zeros((*lead, d), dtype=dtype, device=device)}
    if kind == "ln":
        return {"w": torch.ones((*lead, d), dtype=dtype, device=device),
                "b": torch.zeros((*lead, d), dtype=dtype, device=device)}
    raise ValueError(kind)


def activation(name: str):
    """``"gelu"`` is the tanh form, as ``jax.nn.gelu``'s default is."""
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def rope_freqs(head_dim: int, rotary_dim: int, theta: float,
               device) -> torch.Tensor:
    exps = (torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                         device=device) / rotary_dim)
    # torch.full, not torch.tensor: a host-to-device copy cannot be
    # captured into a CUDA graph
    return 1.0 / (torch.full((), theta, dtype=torch.float32,
                             device=device) ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, rotary_pct: float = 1.0
               ) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int. Rotates the first
    ``rotary_pct * D`` dims (pairwise halves)."""
    d = x.shape[-1]
    rot = int(d * rotary_pct)
    rot -= rot % 2
    if rot == 0:
        return x
    inv = rope_freqs(d, rot, theta, x.device)
    ang = positions.to(torch.float32)[:, :, None] * inv
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = torch.chunk(x_rot.to(torch.float32), 2, dim=-1)
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    x_rot = torch.cat([out1, out2], -1).to(x.dtype)
    return torch.cat([x_rot, x_pass], -1) if rot < d else x_rot


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)
