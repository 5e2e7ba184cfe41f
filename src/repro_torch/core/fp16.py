"""IEEE-754 binary16/bfloat16/binary32 field codecs as integer torch ops
(mirror of ``repro/core/fp16.py``).

The IPU datapath (paper §2.2, Appendix A.2) operates on the *signed
magnitude* and *unbiased exponent* of FP operands:

  value(a) = sign * mag * 2**(exp - MANT_BITS)

where ``mag`` is the integer magnitude including the hidden bit
(``1.mantissa`` for normals, ``0.mantissa`` for subnormals) and ``exp`` is
the unbiased exponent with the subnormal adjustment ``exp = 1 - bias``.

Bit fields are read through ``tensor.view(torch.int16/int32)``, widened to
int32 and masked to unsigned; every function works on int32 tensors on
whatever device its input lies on.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class FPFormat(NamedTuple):
    """Static description of an IEEE-like binary FP format."""

    name: str
    exp_bits: int
    mant_bits: int  # explicit mantissa bits (no hidden bit)

    @property
    def bias(self) -> int:
        return (1 << (self.exp_bits - 1)) - 1

    @property
    def mag_bits(self) -> int:
        # magnitude incl. hidden bit
        return self.mant_bits + 1

    @property
    def min_exp(self) -> int:
        # unbiased exponent of subnormals and of the smallest normal
        return 1 - self.bias

    @property
    def max_exp(self) -> int:
        return (1 << self.exp_bits) - 2 - self.bias


FP16 = FPFormat("fp16", 5, 10)
BF16 = FPFormat("bf16", 8, 7)
FP32 = FPFormat("fp32", 8, 23)
# Nvidia TF32: 8-bit exponent, 10-bit mantissa (paper Appendix B).
TF32 = FPFormat("tf32", 8, 10)

FORMATS = {f.name: f for f in (FP16, BF16, FP32, TF32)}

_BITS_DTYPE = {16: torch.int16, 32: torch.int32}
_INT32_MIN = -(1 << 31)


def _storage_bits(fmt: FPFormat) -> int:
    return 16 if fmt.exp_bits + fmt.mant_bits + 1 <= 16 else 32


def native_dtype(fmt: FPFormat) -> torch.dtype:
    return {"fp16": torch.float16, "bf16": torch.bfloat16,
            "fp32": torch.float32}[fmt.name]


def _bits(x: torch.Tensor, fmt: FPFormat) -> Tuple[torch.Tensor, int]:
    """The storage bits of ``x`` (cast to the format's dtype) as
    non-negative int32 (16-bit formats) or wrapped int32 (32-bit)."""
    nbits = _storage_bits(fmt)
    x = torch.as_tensor(x).to(native_dtype(fmt)).contiguous()
    bits = x.view(_BITS_DTYPE[nbits]).to(torch.int32)
    if nbits == 16:
        bits = bits & 0xFFFF
    return bits, nbits


def _from_bits(bits: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    """int32 bit patterns (16-bit patterns as 0..0xFFFF) -> native dtype."""
    nbits = _storage_bits(fmt)
    if nbits == 16:
        # 0..0xFFFF as the signed int16 with the same bits
        bits = bits - ((bits & 0x8000) << 1)
    return bits.to(_BITS_DTYPE[nbits]).contiguous().view(native_dtype(fmt))


def decompose(x: torch.Tensor, fmt: FPFormat = FP16
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split an FP tensor into (sign, unbiased exp, integer magnitude).

    Returns int32 tensors with ``value = sign * mag * 2**(exp - fmt.mant_bits)``.
    sign is +-1 (-0 keeps sign -1 with magnitude 0). Inf/NaN are NOT
    handled by the IPU datapath: use :func:`is_finite` to validate inputs.
    """
    if fmt is TF32:
        raise ValueError("TF32 has no native storage here; decompose from fp32")
    bits, nbits = _bits(x, fmt)
    sign_bit = (bits >> (nbits - 1)) & 1
    sign = 1 - 2 * sign_bit
    e = (bits >> fmt.mant_bits) & ((1 << fmt.exp_bits) - 1)
    m = bits & ((1 << fmt.mant_bits) - 1)
    is_sub = e == 0
    mag = torch.where(is_sub, m, m | (1 << fmt.mant_bits))
    exp = torch.where(is_sub, torch.full_like(e, fmt.min_exp), e - fmt.bias)
    return sign, exp, mag


def _pack(sign_bit: torch.Tensor, low: torch.Tensor, fmt: FPFormat
          ) -> torch.Tensor:
    """Sign bit + the exponent/mantissa fields (``low``, < 2**31) -> the
    native dtype. The 32-bit sign lands through an OR with INT32_MIN, so
    no shift into the sign bit is ever taken."""
    nbits = _storage_bits(fmt)
    if nbits == 16:
        return _from_bits((sign_bit << 15) | low, fmt)
    bits = torch.where(sign_bit != 0, low | _INT32_MIN, low)
    return bits.to(torch.int32).contiguous().view(torch.float32)


def compose(sign: torch.Tensor, exp: torch.Tensor, mag: torch.Tensor,
            fmt: FPFormat = FP16) -> torch.Tensor:
    """Inverse of :func:`decompose` for in-range (sign, exp, mag) triples.

    Assumes canonical fields: for normals ``mag`` has the hidden bit set and
    ``exp`` in [min_exp, max_exp]; for subnormals ``exp == min_exp`` and
    ``mag < 2**mant_bits``. Exact (no rounding).
    """
    sign, exp, mag = torch.broadcast_tensors(torch.as_tensor(sign),
                                             torch.as_tensor(exp),
                                             torch.as_tensor(mag))
    exp = exp.to(torch.int32)
    mag = mag.to(torch.int32)
    is_sub = (mag < (1 << fmt.mant_bits)) | (exp < fmt.min_exp)
    e_field = torch.where(is_sub, torch.zeros_like(exp), exp + fmt.bias)
    m_field = mag & ((1 << fmt.mant_bits) - 1)
    sign_bit = (sign < 0).to(torch.int32)
    return _pack(sign_bit, (e_field << fmt.mant_bits) | m_field, fmt)


def make_inf(sign: torch.Tensor, fmt: FPFormat = FP16) -> torch.Tensor:
    """+-Inf with the given sign (+1/-1), as the format's native dtype."""
    sign = torch.as_tensor(sign)
    sign_bit = (sign < 0).to(torch.int32)
    low = torch.full_like(sign_bit, ((1 << fmt.exp_bits) - 1) << fmt.mant_bits)
    return _pack(sign_bit, low, fmt)


def is_finite(x: torch.Tensor, fmt: FPFormat = FP16) -> torch.Tensor:
    bits, _ = _bits(x, fmt)
    e = (bits >> fmt.mant_bits) & ((1 << fmt.exp_bits) - 1)
    return e != ((1 << fmt.exp_bits) - 1)


def product_exponent_range(fmt: FPFormat = FP16) -> Tuple[int, int]:
    """Range of the exponent of a product of two numbers of ``fmt``.

    For FP16: [-28, 30] (paper §2.2), hence worst-case alignment 58.
    """
    return 2 * fmt.min_exp, 2 * fmt.max_exp


def max_alignment(fmt: FPFormat = FP16) -> int:
    lo, hi = product_exponent_range(fmt)
    return hi - lo


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for int32 x in [1, 2**24). Exact via f32 frexp:
    every int below 2**24 is exactly representable in f32."""
    _, e = torch.frexp(x.to(torch.float32))
    return (e - 1).to(torch.int32)
