"""Theorem 1 error bounds for the approximate nibble iteration (a
pure-Python copy of ``repro/core/error_bounds.py``).

Paper (Theorem 1): for an FP-IP with n FP16 input pairs, the absolute
error of approximate_nibble_iteration(i, j, precision) is no larger than

    225 * 2**(4*(i+j) - 22) * 2**(max - precision) * (n - 1)

where ``max`` is the maximum product exponent.

A *partially* truncated product can drop up to one ULP of the iteration
sum scale, i.e. up to 2**9 * 2**(max-precision) * 2**(4(i+j)-22) per
product (2**9 = 512 > 225), so the provably safe bound uses the constant
512; the property tests assert measured error <= that tight bound.
"""
from __future__ import annotations

from fractions import Fraction

PAPER_CONSTANT = 225
TIGHT_CONSTANT = 512  # 2**9: one ULP of the iteration-sum scale per product


def iteration_bound(i: int, j: int, precision: int, max_exp: int, n: int,
                    constant: int = PAPER_CONSTANT) -> Fraction:
    """Absolute-error bound for one approximate nibble iteration."""
    if n <= 1:
        return Fraction(0)
    return (Fraction(constant) * Fraction(2) ** (4 * (i + j) - 22)
            * Fraction(2) ** (max_exp - precision) * (n - 1))


def tight_iteration_bound(i: int, j: int, precision: int, max_exp: int,
                          n: int) -> Fraction:
    return iteration_bound(i, j, precision, max_exp, n, TIGHT_CONSTANT)


def fp_ip_bound(precision: int, max_exp: int, n: int,
                constant: int = PAPER_CONSTANT,
                acc_granularity_updates: int = 0) -> Fraction:
    """Total FP-IP bound: sum of the nine iteration bounds, plus (for the
    full pipeline) one accumulator-granularity ULP (2**(max-30)) per
    accumulator update that can truncate."""
    total = sum(
        (iteration_bound(i, j, precision, max_exp, n, constant)
         for i in range(3) for j in range(3)), Fraction(0))
    if acc_granularity_updates:
        total += acc_granularity_updates * Fraction(2) ** (max_exp - 30)
    return total


def remark1_weights() -> dict:
    """Remark 1: relative error weights of the nine iterations; the most
    significant nibble pair (i+j largest) dominates."""
    return {(i, j): Fraction(2) ** (4 * (i + j))
            for i in range(3) for j in range(3)}
