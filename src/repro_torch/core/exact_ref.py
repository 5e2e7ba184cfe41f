"""The infinitely precise dot product of FP16 operands, as a Fraction
(copied from ``repro/core/exact_ref.py``: ``decompose_fp16``,
``fp16_value`` and ``exact_dot``).

The examples measure the approximate FP-IP's error against it
(``repro_torch.examples.quickstart``). The rest of the reference's
module, the Python-integer oracle of the approximate FP-IP
(``approx_fp_ip`` and its helpers), stays a test oracle: the port's
tests import the reference's copy.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Sequence, Tuple

import numpy as np


def decompose_fp16(x) -> Tuple[int, int, int]:
    """(sign, unbiased exp, integer magnitude) of a python/np scalar as
    FP16. value = sign * mag * 2**(exp - 10)."""
    bits = int(np.float16(x).view(np.uint16))
    s = 1 - 2 * (bits >> 15)
    e = (bits >> 10) & 0x1F
    m = bits & 0x3FF
    if e == 0x1F:
        raise ValueError("Inf/NaN not supported by the IPU datapath")
    if e == 0:
        return s, -14, m
    return s, e - 15, m | 0x400


def fp16_value(x) -> Fraction:
    s, e, m = decompose_fp16(x)
    return Fraction(s * m) * Fraction(2) ** (e - 10)


def exact_dot(a: Sequence, b: Sequence) -> Fraction:
    """Infinitely precise sum of FP16 products."""
    return sum((fp16_value(x) * fp16_value(y) for x, y in zip(a, b)),
               Fraction(0))
