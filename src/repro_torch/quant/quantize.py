"""Symmetric int quantization and the fp8 (e4m3) / fp4 (e2m1) codecs.

Mirror of ``repro/quant/quantize.py`` on torch tensors, bit-equal to it
on the same inputs: ``torch.round`` rounds half to even like
``jnp.round``, and powers of two come from ``torch.ldexp`` so every
codec step is exact. ``fake_quant`` is a ``torch.autograd.Function``
whose forward repeats the reference's ``x + (qdq(x) - x)`` literally and
whose backward is the straight-through identity.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class FPFormat:
    """A small saturating IEEE-style format (no inf/NaN emission)."""

    name: str
    exp_bits: int
    man_bits: int
    bias: int
    max: float

    @property
    def bits(self) -> int:
        return 1 + self.exp_bits + self.man_bits


# OCP 8-bit e4m3: bias 7, max 448 (saturation keeps codes below the NaN
# pattern); OCP 4-bit e2m1: bias 1, all 16 codes finite.
FP8_E4M3 = FPFormat("fp8", exp_bits=4, man_bits=3, bias=7, max=448.0)
FP4_E2M1 = FPFormat("fp4", exp_bits=2, man_bits=1, bias=1, max=6.0)

FP_FORMATS = {f.name: f for f in (FP8_E4M3, FP4_E2M1)}


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact 2**e for an int tensor ``e``."""
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e)


def fp_encode(x: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    """fp32 -> uint8 bit-field codes (sign | exp | mantissa): round to
    nearest even on the mantissa grid, saturating at ``fmt.max``. The
    sign comes from ``signbit``, so -0.0 keeps its sign bit."""
    xf = x.to(torch.float32)
    sign = torch.signbit(xf).to(torch.int32)
    ax = torch.clamp(torch.abs(xf), 0.0, fmt.max)
    _, e = torch.frexp(ax)
    en = torch.clamp(e - 1, min=1 - fmt.bias)
    step = _pow2(en - fmt.man_bits)
    q = torch.round(ax / step).to(torch.int32)
    # mantissa overflow from rounding bumps the exponent
    of = q >= (1 << (fmt.man_bits + 1))
    en = torch.where(of, en + 1, en)
    q = torch.where(of, q >> 1, q)
    normal = q >= (1 << fmt.man_bits)
    exp_field = torch.where(normal, en + fmt.bias, torch.zeros_like(en))
    man = torch.where(normal, q - (1 << fmt.man_bits), q)
    code = ((sign << (fmt.exp_bits + fmt.man_bits))
            | (exp_field << fmt.man_bits) | man)
    return code.to(torch.uint8)


def fp_decode(codes: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    """uint8 bit-field codes -> fp32 (exact; e4m3 code 0x7F is 480)."""
    c = codes.to(torch.int32)
    sign = (c >> (fmt.exp_bits + fmt.man_bits)) & 1
    exp_field = (c >> fmt.man_bits) & ((1 << fmt.exp_bits) - 1)
    man = c & ((1 << fmt.man_bits) - 1)
    normal = exp_field > 0
    sig = torch.where(normal, man + (1 << fmt.man_bits), man)
    e = torch.where(normal, exp_field - fmt.bias,
                    torch.full_like(exp_field, 1 - fmt.bias))
    val = sig.to(torch.float32) * _pow2(e - fmt.man_bits)
    return torch.where(sign == 1, -val, val)


def _as_scale(scale, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(scale, dtype=torch.float32, device=like.device)


def fp_quantize(x: torch.Tensor, fmt: FPFormat, axis=None,
                scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (uint8 codes, f32 scale): the scale maps the (per-axis)
    absmax onto ``fmt.max``."""
    if scale is None:
        scale = calibrate_absmax(x, axis=axis) / fmt.max
    else:
        scale = _as_scale(scale, x)
    return fp_encode(x.to(torch.float32) / scale, fmt), scale


def fp_dequantize(codes: torch.Tensor, scale: torch.Tensor,
                  fmt: FPFormat) -> torch.Tensor:
    return fp_decode(codes, fmt) * scale


def calibrate_absmax(x: torch.Tensor, axis=None,
                     pct: float = 1.0) -> torch.Tensor:
    """Symmetric scale from the (clipped) absolute maximum."""
    a = torch.abs(x.to(torch.float32))
    if pct >= 1.0:
        m = a.amax() if axis is None else a.amax(dim=axis, keepdim=True)
    else:
        m = (torch.quantile(a, pct) if axis is None
             else torch.quantile(a, pct, dim=axis, keepdim=True))
    return torch.clamp(m, min=1e-8)


def quantize_symmetric(x: torch.Tensor, bits: int, axis=None,
                       scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (q int8 storage in [-2^(b-1), 2^(b-1)-1], f32 scale)."""
    qmax = (1 << (bits - 1)) - 1
    if scale is None:
        scale = calibrate_absmax(x, axis=axis) / qmax
    else:
        scale = _as_scale(scale, x)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale),
                    -qmax - 1, qmax)
    return q.to(torch.int8), scale.to(torch.float32)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


class _FakeQuant(torch.autograd.Function):
    """Quantize-dequantize forward, identity (straight-through) backward."""

    @staticmethod
    def forward(ctx, x, bits, axis, scale):
        q, s = quantize_symmetric(x, bits, axis=axis, scale=scale)
        qdq = dequantize(q, s).to(x.dtype)
        # the reference's literal x + stop_gradient(qdq - x) value
        return x + (qdq - x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None, None


def fake_quant(x: torch.Tensor, bits: int, axis=None,
               scale=None) -> torch.Tensor:
    """Quantize-dequantize with a straight-through estimator. With an
    explicit ``scale`` (calibrated static activation scale) the rounding
    grid is fixed, so the result is elementwise."""
    return _FakeQuant.apply(x, bits, axis, scale)
