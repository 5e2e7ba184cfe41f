"""Two-limb int32 signed fixed-point arithmetic, base 2**24 (mirror of
``repro/core/fixedpoint.py``).

The IPU accumulator register is ``33 + t + l`` bits wide (paper §2.2,
Fig. 1), wider than int32. The reference carries it as two int32 limbs::

    V = hi * 2**24 + lo,   lo in [0, 2**24),   hi signed

which represents |V| < 2**54 exactly. This module keeps the same two
limbs and the same operations step by step, so the plain torch path is
the reference's arithmetic, saturations included (``_shr_unsigned``
returns 0 for shifts >= 48). The CUDA kernel (``kernels/csrc/mpmm.cu``)
carries one int64 with the same saturations instead.

Shift semantics: the paper's datapath is sign-magnitude, so right shifts
truncate toward zero (shift the magnitude, reapply the sign).
``shr_floor`` is the two's-complement alternative.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

LIMB_BITS = 24
LIMB_MASK = (1 << LIMB_BITS) - 1


class FX(NamedTuple):
    """Two-limb fixed-point value. hi*2**24 + lo with lo in [0, 2**24)."""

    hi: torch.Tensor
    lo: torch.Tensor


def _i32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int32)


def _low_mask(s: torch.Tensor) -> torch.Tensor:
    """(1 << s) - 1 for per-element s in [0, 31)."""
    return torch.bitwise_left_shift(torch.ones_like(s), s) - 1


def canon(hi: torch.Tensor, lo: torch.Tensor) -> FX:
    """Normalize so lo is in [0, 2**24). Arithmetic >> gives a floor carry,
    which is correct for negative lo as well."""
    hi, lo = _i32(hi), _i32(lo)
    carry = lo >> LIMB_BITS
    return FX(hi + carry, lo & LIMB_MASK)


def zero_like(x: torch.Tensor) -> FX:
    z = torch.zeros_like(x, dtype=torch.int32)
    return FX(z, z)


def from_int32(x: torch.Tensor) -> FX:
    x = _i32(x)
    return canon(torch.zeros_like(x), x)


def add(a: FX, b: FX) -> FX:
    return canon(a.hi + b.hi, a.lo + b.lo)


def neg(a: FX) -> FX:
    return canon(-a.hi, -a.lo)


def is_neg(a: FX) -> torch.Tensor:
    return a.hi < 0


def is_zero(a: FX) -> torch.Tensor:
    return (a.hi == 0) & (a.lo == 0)


def abs_(a: FX) -> Tuple[torch.Tensor, FX]:
    """Return (sign in {-1,+1}, |a|). sign(0) = +1."""
    n = is_neg(a)
    sign = 1 - 2 * n.to(torch.int32)
    na = neg(a)
    return sign, FX(torch.where(n, na.hi, a.hi), torch.where(n, na.lo, a.lo))


def mul_sign(sign: torch.Tensor, a: FX) -> FX:
    na = neg(a)
    neg_sel = sign < 0
    return FX(torch.where(neg_sel, na.hi, a.hi),
              torch.where(neg_sel, na.lo, a.lo))


def _shr_unsigned(a: FX, s: torch.Tensor) -> FX:
    """Logical right shift of a NON-NEGATIVE two-limb value by a per-element
    dynamic amount s >= 0 (values >= 48 yield 0). All lane shifts <= 31."""
    s = _i32(s)
    # --- branch A: s in [0, 24) ---
    sa = torch.clamp(s, 0, LIMB_BITS - 1)
    hi_a = a.hi >> sa
    cross = (a.hi & _low_mask(sa)) << (LIMB_BITS - sa)  # < 2**24
    lo_a = cross | (a.lo >> sa)
    # --- branch B: s in [24, 48) ---
    sb = torch.clamp(s - LIMB_BITS, 0, LIMB_BITS - 1)
    lo_b = a.hi >> sb
    # --- select ---
    ge48 = s >= 2 * LIMB_BITS
    in_b = (s >= LIMB_BITS) & ~ge48
    zero = torch.zeros_like(hi_a)
    hi = torch.where(ge48 | in_b, zero, hi_a)
    lo = torch.where(ge48, zero, torch.where(in_b, lo_b, lo_a))
    return FX(hi, lo)


def _dropped_nonzero(mag: FX, s: torch.Tensor) -> torch.Tensor:
    """True where shifting non-negative mag right by s drops a nonzero bit,
    i.e. any of bits [0, s) is set."""
    s = _i32(s)
    sa = torch.clamp(s, 0, LIMB_BITS - 1)
    low_a = (mag.lo & _low_mask(sa)) != 0
    sb = torch.clamp(s - LIMB_BITS, 0, LIMB_BITS - 1)
    low_b = ((mag.hi & _low_mask(sb)) != 0) | (mag.lo != 0)
    ge48 = s >= 2 * LIMB_BITS
    any_bits = (mag.hi != 0) | (mag.lo != 0)
    return torch.where(ge48, any_bits,
                       torch.where(s >= LIMB_BITS, low_b, low_a))


def shr_trunc(a: FX, s: torch.Tensor) -> FX:
    """Right shift truncating toward zero (sign-magnitude datapath)."""
    sign, mag = abs_(a)
    return mul_sign(sign, _shr_unsigned(mag, s))


def shr_floor(a: FX, s: torch.Tensor) -> FX:
    """Arithmetic right shift (floor) — two's-complement datapath variant."""
    sign, mag = abs_(a)
    shifted = _shr_unsigned(mag, s)
    dropped = _dropped_nonzero(mag, s)
    res = mul_sign(sign, shifted)
    # floor(-m / 2**s) = -(m >> s) - 1 when bits were dropped
    adj = ((sign < 0) & dropped).to(torch.int32)
    return canon(res.hi, res.lo - adj)


def shl(a: FX, s: int) -> FX:
    """Static left shift by s in [0, 24). Caller guarantees no overflow of
    the 2**54 range. (The IPU needs at most 33 - w <= 21.)"""
    if s == 0:
        return a
    if not 0 < s < LIMB_BITS:
        raise ValueError("static shl must be in [0, 24); IPU needs <= 21")
    hi = (a.hi << s) | (a.lo >> (LIMB_BITS - s))
    lo = (a.lo << s) & LIMB_MASK
    return FX(hi, lo)


def shl_dyn(a: FX, s: torch.Tensor, max_s: int = LIMB_BITS - 1) -> FX:
    """Dynamic left shift by per-element s in [0, max_s], max_s < 24."""
    s = torch.clamp(_i32(s), 0, max_s)
    carry = torch.where(s == 0, torch.zeros_like(a.lo),
                        a.lo >> (LIMB_BITS - s))
    hi = (a.hi << s) | carry
    lo = (a.lo << s) & LIMB_MASK
    return FX(hi, lo)


def to_float32(a: FX) -> torch.Tensor:
    """Value as f32 — EXACT only when |V| <~ 2**24; for diagnostics."""
    return a.hi.to(torch.float32) * float(1 << LIMB_BITS) + a.lo.to(
        torch.float32)


def select(pred: torch.Tensor, t: FX, f: FX) -> FX:
    return FX(torch.where(pred, t.hi, f.hi), torch.where(pred, t.lo, f.lo))


def msb_index(mag: FX) -> torch.Tensor:
    """floor(log2(V)) of a non-negative two-limb value in canonical form.

    Exact: each limb < 2**24 is exactly representable in f32. Returns 0 for
    V == 0 (caller must mask)."""
    _, e_hi = torch.frexp(mag.hi.to(torch.float32))
    _, e_lo = torch.frexp(mag.lo.to(torch.float32))
    return torch.where(mag.hi > 0, LIMB_BITS + e_hi.to(torch.int32) - 1,
                       torch.clamp(e_lo.to(torch.int32) - 1, min=0))


def _bit_at(mag: FX, pos: torch.Tensor) -> torch.Tensor:
    """Bit ``pos`` (>=0, <48) of a non-negative two-limb value, as bool."""
    pos = _i32(pos)
    in_hi = pos >= LIMB_BITS
    p_lo = torch.clamp(pos, 0, LIMB_BITS - 1)
    p_hi = torch.clamp(pos - LIMB_BITS, 0, LIMB_BITS - 1)
    b_lo = (mag.lo >> p_lo) & 1
    b_hi = (mag.hi >> p_hi) & 1
    return torch.where(in_hi, b_hi, b_lo) != 0


def round_to_fp(acc: FX, exp: torch.Tensor, fmt) -> torch.Tensor:
    """Round the non-normalized accumulator to an IEEE format, RNE.

    Accumulator semantics (paper §2.2): value = acc * 2**(exp - 30) —
    sign + (3+t+l) integer bits + 30 fraction bits w.r.t. ``exp``.

    Implements normalize -> round-to-nearest-even -> pack, handling
    subnormal outputs and overflow-to-inf, entirely in int32 ops.
    """
    from repro_torch.core import fp16 as fp16mod  # local: avoids a cycle

    exp = _i32(exp)
    sign, mag = abs_(acc)
    zero = is_zero(mag)
    nb = msb_index(mag)  # MSB position; value in [2**nb, 2**(nb+1))
    e_val = exp - 30 + nb
    mt = fmt.mag_bits  # target magnitude bits incl hidden
    keep = nb + 1 - mt
    # Subnormal squeeze: if e_val < min_exp we must drop extra bits.
    extra = torch.clamp(fmt.min_exp - e_val, min=0)
    keep = keep + extra
    keep_pos = torch.clamp(keep, min=0)

    q = _shr_unsigned(mag, keep_pos)
    rb_pos = torch.clamp(keep_pos - 1, min=0)
    rb = _bit_at(mag, rb_pos) & (keep_pos > 0)
    sticky = _dropped_nonzero(mag, rb_pos)
    q_lsb = (q.lo & 1) != 0
    round_up = rb & (sticky | q_lsb)
    q = select(round_up, add(q, from_int32(torch.ones_like(q.lo))), q)
    # q now fits 25 bits worst case; flatten to a plain int32.
    qi = q.hi * (1 << LIMB_BITS) + q.lo
    # keep < 0: value has fewer bits than the target mantissa — left-pad so
    # the hidden bit lands at position mt-1 (exact, no rounding happened).
    pad = torch.clamp(-keep, 0, mt - 1)
    qi = torch.where(keep < 0, qi << pad, qi)
    # Rounding carry: q == 2**mt -> halve and bump exponent.
    carried = qi >= (1 << mt)
    qi = torch.where(carried, qi >> 1, qi)
    e_q = torch.where(carried, e_val + 1, e_val)
    e_q = torch.clamp(e_q, min=fmt.min_exp)  # subnormal exponent pin
    overflow = e_q > fmt.max_exp
    out = fp16mod.compose(sign, e_q, qi, fmt)
    inf = fp16mod.make_inf(sign, fmt)
    out = torch.where(overflow, inf, out)
    zero_val = fp16mod.compose(torch.ones_like(sign),
                               torch.full_like(e_q, fmt.min_exp),
                               torch.zeros_like(qi), fmt)
    return torch.where(zero, zero_val, out)
