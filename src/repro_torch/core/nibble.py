"""Temporal nibble decomposition for the 5b x 5b signed multiplier array
(mirror of ``repro/core/nibble.py``).

The IPU's multipliers are 5-bit signed (paper §2): wide enough for a
*signed* 4-bit nibble (high nibble of a two's-complement operand, range
[-8, 7]) or an *unsigned* 4-bit nibble (low nibbles, range [0, 15]).

FP16 path (paper §2.2 "Converting numbers"): the 12-bit signed magnitude
M[11:0] is converted to three 5-bit operands::

    N2 = {M11 .. M7}        (sign + top 4 magnitude bits)
    N1 = {0, M6 .. M3}
    N0 = {0, M2 .. M0, 0}   (implicit left shift preserves accuracy)

Each plane is a signed int32 carrying the operand's sign, with plane
weights 2**gamma_i, gamma = (-1, 3, 7):

    signed_magnitude = n2*2**7 + n1*2**3 + n0*2**-1

INT path: a b-bit two's-complement integer is decomposed into
ceil(b/4) nibbles — unsigned low nibbles plus a signed top nibble — with
plane weights 16**i.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

# Plane weights exponents for the FP16 mantissa decomposition:
# signed_mag = sum_i n_i * 2**GAMMA[i]
FP16_GAMMA: Tuple[int, int, int] = (-1, 3, 7)
FP16_NUM_PLANES = 3


def fp16_planes(sign: torch.Tensor, mag: torch.Tensor) -> List[torch.Tensor]:
    """Decompose an 11-bit magnitude + sign into 3 signed nibble planes.

    Returns [n0, n1, n2] (ascending significance), each int32 in
    [-30, 30] (n0 carries the implicit <<1), such that

        sign * mag = n2 * 2**7 + n1 * 2**3 + n0 * 2**-1.
    """
    n2 = sign * ((mag >> 7) & 0xF)
    n1 = sign * ((mag >> 3) & 0xF)
    n0 = sign * ((mag & 0x7) << 1)
    return [n0.to(torch.int32), n1.to(torch.int32), n2.to(torch.int32)]


def int_planes(x: torch.Tensor, bits: int) -> List[torch.Tensor]:
    """Decompose a two's-complement ``bits``-wide integer into nibbles.

    Low nibbles are unsigned in [0, 15]; the top nibble is signed. Planes
    are returned ascending, with value = sum_i plane_i * 16**i. ``bits``
    must be a multiple of 4.
    """
    if bits % 4 != 0:
        raise ValueError(f"bits must be a multiple of 4, got {bits}")
    x = torch.as_tensor(x).to(torch.int32)
    k = bits // 4
    planes = []
    for i in range(k):
        if i < k - 1:
            planes.append((x >> (4 * i)) & 0xF)
        else:
            # top nibble: arithmetic shift keeps the sign
            planes.append(x >> (4 * i))
    return planes


def num_nibble_iterations(a_bits: int, b_bits: int) -> int:
    """Total nibble iterations = product of operand nibble counts (paper §2).

    E.g. INT8 x INT12 -> 2 * 3 = 6; FP16 x FP16 -> 3 * 3 = 9.
    """
    return (a_bits // 4) * (b_bits // 4)


def int_iteration_shift(i: int, j: int, ka: int, kb: int) -> int:
    """Accumulator right-shift for INT-mode nibble iteration (i, j).

    Paper §2.1: 4 * ((Ka - i - 1) + (Kb - j - 1)).
    """
    return 4 * ((ka - i - 1) + (kb - j - 1))


def fp16_iteration_shift(i: int, j: int) -> int:
    """Accumulator right-shift for FP-mode nibble iteration (i, j) before
    exponent alignment. Paper §2.2: 4 * ((3-i-1) + (3-j-1)) = 4 * (4-i-j)."""
    return 4 * ((3 - i - 1) + (3 - j - 1))


# --- BF16 (paper Appendix B: 8-bit exponents, four nibble iterations) ---
# BF16 magnitude is 8 bits (1.mmmmmmm): two 4-bit nibbles with the sign
# carried on each plane, weights 16**i:  signed_mag = n1*16 + n0.
BF16_GAMMA: Tuple[int, int] = (0, 4)
BF16_NUM_PLANES = 2


def bf16_planes(sign: torch.Tensor, mag: torch.Tensor) -> List[torch.Tensor]:
    """Decompose an 8-bit magnitude + sign into 2 signed nibble planes."""
    n1 = sign * ((mag >> 4) & 0xF)
    n0 = sign * (mag & 0xF)
    return [n0.to(torch.int32), n1.to(torch.int32)]


def bf16_iteration_shift(i: int, j: int) -> int:
    """Accumulator right-shift for a BF16 nibble iteration: the K=2
    analogue of the §2.2 formula, 4 * ((2-i-1) + (2-j-1))."""
    return 4 * ((2 - i - 1) + (2 - j - 1))
