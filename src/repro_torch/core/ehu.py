"""Exponent Handling Unit (EHU) — paper §2.2 and Fig. 5 (mirror of
``repro/core/ehu.py``).

The EHU computes, per FP-IP operation (shared across all nine nibble
iterations, which is how the hardware amortizes it):

  1. element-wise product exponents  c_k = exp(a_k) + exp(b_k)
  2. the maximum product exponent    max_c
  3. alignment shift amounts         s_k = max_c - c_k
  4. software-precision masking      s_k > P  ->  product contributes 0
  5. (MC-IPU only) the multi-cycle service schedule: partition k serves
     products whose shift lies in [k*sp, (k+1)*sp), one partition per
     cycle (Fig. 5's ``serv_i`` bits / threshold walk).

All functions operate on int32 tensors with a reduction axis (the IPU's
n inputs, last by default).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

# Sentinel for "no product" lanes (padding): treated as -inf exponent.
NEG_INF_EXP = -(1 << 20)


class EHUOut(NamedTuple):
    max_exp: torch.Tensor     # (...,)  max product exponent per group
    shift: torch.Tensor       # (..., n) alignment shift per product
    active: torch.Tensor      # (..., n) bool: survives software masking


def product_exponents(exp_a: torch.Tensor, exp_b: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stage 1: element-wise exponent sums; padded lanes get -inf."""
    c = exp_a.to(torch.int32) + exp_b.to(torch.int32)
    if valid is not None:
        c = torch.where(valid, c, torch.full_like(c, NEG_INF_EXP))
    return c


def run(exp_a: torch.Tensor, exp_b: torch.Tensor, sw_precision: int,
        valid: Optional[torch.Tensor] = None, axis: int = -1) -> EHUOut:
    """Stages 1-4 of the EHU for one (group of) FP-IP operation(s)."""
    c = product_exponents(exp_a, exp_b, valid)
    max_c = torch.amax(c, dim=axis)
    shift = max_c.unsqueeze(axis) - c
    active = shift <= sw_precision
    if valid is not None:
        active = active & valid
    # All-padding groups: max is NEG_INF_EXP; nothing active.
    return EHUOut(max_c, shift, active)


def partition_index(shift: torch.Tensor, sp: int) -> torch.Tensor:
    """MC-IPU partition k for each product: k = shift // sp (paper §3.2)."""
    return torch.div(shift, sp, rounding_mode="floor")


def num_cycles(shift: torch.Tensor, active: torch.Tensor, sp: int,
               skip_empty: bool = False, axis: int = -1) -> torch.Tensor:
    """Cycles an MC-IPU needs for one nibble iteration's alignment.

    Fig. 5's threshold walk serves partition k in cycle k, so the faithful
    count is ``max occupied partition + 1`` (empty intermediate partitions
    still burn a cycle). ``skip_empty=True`` models a scheduler that skips
    unoccupied partitions (counts distinct occupied partitions).

    Inactive (masked) products take no service. A group with no active
    products still costs 1 cycle (the adder tree produces a zero).
    """
    k = partition_index(shift, sp)
    k_masked = torch.where(active, k, torch.full_like(k, -1))
    if not skip_empty:
        cycles = torch.amax(k_masked, dim=axis) + 1
        return torch.clamp(cycles, min=1).to(torch.int32)
    # distinct occupied partitions: one-hot over partitions, OR-reduce.
    # Max meaningful partition index is 58 // sp.
    # The reduction axis is the reference's own: with the default
    # axis=-1 it reduces the partition axis, so this counts the active
    # products whose partition is below kmax (shift [0, 1, 40] at sp=5:
    # 3, where the distinct partitions are 2). Kept bit-equal to it.
    kmax = 58 // sp + 1
    ks = torch.arange(kmax, dtype=k_masked.dtype, device=k_masked.device)
    occupied = torch.any(k_masked.unsqueeze(-1) == ks, dim=axis)
    cycles = torch.sum(occupied, dim=-1).to(torch.int32)
    return torch.clamp(cycles, min=1)


def service_schedule(shift: torch.Tensor, active: torch.Tensor, sp: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-product (cycle_index, local_shift) under the MC-IPU schedule.

    cycle_index = partition k (served in cycle k); local_shift = shift
    remainder within the partition, guaranteed < sp <= w - 9, hence exact
    by Proposition 1. Masked products get cycle_index = -1.
    """
    k = partition_index(shift, sp)
    local = shift - k * sp
    cycle = torch.where(active, k, torch.full_like(k, -1))
    return cycle.to(torch.int32), local.to(torch.int32)
