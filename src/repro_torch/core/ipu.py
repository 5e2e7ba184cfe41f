"""Bit-exact emulation of the mixed-precision inner-product unit (IPU)
(mirror of ``repro/core/ipu.py``).

Implements the paper's approximate FP-IP operation (Fig. 2) and the
multi-cycle MC-IPU variant (§3.2) as integer torch arithmetic:

  * FP16 operands are decomposed into 3 signed 5-bit nibble planes
    (``nibble.fp16_planes``); BF16 into 2; TF32 (f32 inputs RNE-rounded
    to an 11-bit magnitude) takes the FP16 planes on an 8-bit EHU.
  * Per-iteration alignment: each 9-bit nibble product is left-shifted by
    ``w - 9``, right-shifted by its EHU alignment amount with truncation,
    and summed in a ``w``-bit adder tree (w = "IPU precision").
  * The accumulator is the paper's non-normalized (33+t+l)-bit register,
    carried as a two-limb int32 fixed-point value with 30 fraction bits
    w.r.t. the running exponent; swap-and-shift on exponent increase.
  * MC-IPU(w): alignments beyond the safe precision ``sp = w - 9`` are
    served in multiple cycles; partition k's products are locally shifted
    by ``shift - k*sp`` (exact, Proposition 1) and the adder output takes
    the extra ``k*sp`` shift into the accumulator.

INT mode (§2.1) runs the same datapath with zero alignment and exact
results for INT4/8/12 operands.

The reference's ``lax.fori_loop``s over groups, nibble iterations and
MC cycles are Python loops here; every step is the same integer op on
the same int32 values, so results are bit-equal.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch

from repro_torch.core import ehu, fixedpoint as fx, fp16 as fpmod, nibble

NEG_INF_EXP = ehu.NEG_INF_EXP


@dataclasses.dataclass(frozen=True)
class IPUConfig:
    """Static configuration of one IPU / MC-IPU.

    Attributes:
      n: number of IPU inputs (products per group); paper uses 8 or 16.
      w: IPU precision — adder-tree width and max local alignment shift.
      accum: accumulator target format, 'fp16', 'fp32' or 'bf16'.
      sw_precision: software precision P (EHU stage-4 mask threshold).
        Defaults to the paper's accuracy-preserving minima: 16 for FP16
        accumulation, 28 for FP32 accumulation (§3.1).
      multi_cycle: MC-IPU(w) mode — serve alignments up to P over
        ceil((P+1)/sp) cycles instead of truncating at w.
      rounding: 'trunc' (sign-magnitude, paper datapath) or 'floor'
        (two's-complement arithmetic shift) for alignment truncation.
      iter_order: 'asc' iterates nibble pairs (i,j) in Fig.-2 order
        (ascending significance); 'desc' most-significant-first.
      acc_l: l = ceil(log2(max accumulation depth d)); register is
        33 + ceil(log2 n) + l bits and must stay < 54 for two limbs.
      operand: 'fp16' (3 nibble planes, 9 iterations); 'bf16' (8-bit
        exponents, 2 planes, 4 iterations); 'tf32' (8-bit exponents with
        the FP16 11-bit magnitude; f32 inputs RNE-rounded to TF32).
    """

    n: int = 16
    w: int = 16
    accum: str = "fp32"
    sw_precision: Optional[int] = None
    multi_cycle: bool = False
    rounding: str = "trunc"
    iter_order: str = "asc"
    acc_l: int = 10
    operand: str = "fp16"

    def __post_init__(self):
        if self.w < 10:
            raise ValueError("IPU precision w must be >= 10 (sp = w-9 >= 1)")
        if self.accum not in ("fp16", "fp32", "bf16"):
            raise ValueError(f"bad accum {self.accum}")
        if self.operand not in ("fp16", "bf16", "tf32"):
            raise ValueError(f"bad operand {self.operand}")
        if self.accum == "bf16" and self.sw_precision is None:
            raise ValueError("accum='bf16' needs an explicit sw_precision")
        if self.rounding not in ("trunc", "floor"):
            raise ValueError(f"bad rounding {self.rounding}")
        # int32 adder-tree overflow guard: n * 225 * 2**(w-9) < 2**31
        if self.n * 225 * (1 << (self.w - 9)) >= (1 << 31):
            raise ValueError(f"n={self.n}, w={self.w} overflows int32 adder")
        if 33 + math.ceil(math.log2(self.n)) + self.acc_l >= 54:
            raise ValueError("accumulator exceeds two-limb range")

    @property
    def precision(self) -> int:
        """Effective software precision P."""
        if self.sw_precision is not None:
            return self.sw_precision
        return 16 if self.accum == "fp16" else 28

    @property
    def sp(self) -> int:
        """Safe precision: max exact local alignment (Proposition 1)."""
        return self.w - 9

    @property
    def mask_threshold(self) -> int:
        """Alignment beyond this contributes zero. Plain IPU cannot shift
        past its adder width; MC-IPU serves the full software precision."""
        return self.precision if self.multi_cycle else min(self.w,
                                                           self.precision)

    @property
    def num_cycles_static(self) -> int:
        """Static upper bound on MC cycles per nibble iteration."""
        if not self.multi_cycle:
            return 1
        return self.mask_threshold // self.sp + 1

    @property
    def accum_format(self) -> fpmod.FPFormat:
        return {"fp16": fpmod.FP16, "fp32": fpmod.FP32,
                "bf16": fpmod.BF16}[self.accum]

    @property
    def operand_format(self) -> fpmod.FPFormat:
        return {"fp16": fpmod.FP16, "bf16": fpmod.BF16,
                "tf32": fpmod.TF32}[self.operand]

    @property
    def num_planes(self) -> int:
        return 2 if self.operand == "bf16" else 3

    def plane_fn(self):
        return (nibble.bf16_planes if self.operand == "bf16"
                else nibble.fp16_planes)

    def pre_shift(self, i, j):
        """Accumulator pre-shift 4*(2(K-1) - i - j) for plane pair (i,j)."""
        return 4 * (2 * (self.num_planes - 1) - i - j)

    def iteration_pairs(self) -> List[Tuple[int, int]]:
        k = self.num_planes
        pairs = [(i, j) for i in range(k) for j in range(k)]
        if self.iter_order == "desc":
            pairs = sorted(pairs, key=lambda p: -(p[0] + p[1]))
        return pairs


def _shr(v: fx.FX, s: torch.Tensor, rounding: str) -> fx.FX:
    return fx.shr_trunc(v, s) if rounding == "trunc" else fx.shr_floor(v, s)


def _shr_i32(d: torch.Tensor, s: torch.Tensor, rounding: str) -> torch.Tensor:
    """Right shift int32 products with the configured truncation.

    |d| < 2**31; shifts >= 31 are clamped."""
    s = torch.clamp(torch.as_tensor(s).to(torch.int32), max=31)
    if rounding == "trunc":
        return torch.sign(d) * (torch.abs(d) >> s)
    return d >> s  # arithmetic shift == floor


def accumulate(acc: fx.FX, exp_acc: torch.Tensor, s_tree: torch.Tensor,
               max_c: torch.Tensor, pre_shift, extra_shift: torch.Tensor,
               cfg: IPUConfig) -> Tuple[fx.FX, torch.Tensor]:
    """One accumulator update (paper §2.2 right-hand side of Fig. 1).

    ``s_tree`` is the adder-tree output (int32, w + log2 n bits);
    ``pre_shift`` the static nibble-significance shift 4*(4-i-j);
    ``extra_shift`` the MC-IPU per-cycle k*sp (0 for plain IPU).

    The hardware concatenates (33 - w) zero bits then right-shifts by
    pre_shift + extra_shift + (exp_acc' - max_c); the equivalent net
    shift avoids widening past two limbs.
    """
    swap = max_c > exp_acc
    exp_new = torch.maximum(exp_acc, max_c)
    acc = fx.select(swap, _shr(acc, torch.clamp(exp_new - exp_acc, max=63),
                               cfg.rounding), acc)
    inc_shift = pre_shift + extra_shift + (exp_new - max_c)
    net = inc_shift - (33 - cfg.w)  # >0: right shift; <0: exact left shift
    # Left shifts are exact; 23 is the static FX-safe bound. Faithful mode
    # needs at most 33-w <= 23; the fused matmul mode can need (33-w)+1
    # via its negative pre_shift.
    v = fx.from_int32(s_tree)
    v = fx.shl_dyn(v, torch.clamp(-net, 0, 23), max_s=23)
    v = _shr(v, torch.clamp(net, 0, 1 << 20), cfg.rounding)
    return fx.add(acc, v), exp_new


_OPERAND_DTYPE = {"fp16": torch.float16, "bf16": torch.bfloat16,
                  "tf32": torch.float32}


def _prepare_groups(a, b, cfg: IPUConfig):
    """Decompose, pad to a multiple of n, reshape to (..., G, n) and move
    the G axis to the front for the group loop."""
    n = cfg.n
    dt = _OPERAND_DTYPE[cfg.operand]
    a = torch.as_tensor(a).to(dt)
    b = torch.as_tensor(b).to(dt)
    a, b = torch.broadcast_tensors(a, b)
    if a.dim() == 0 or a.shape[-1] == 0:
        raise ValueError("inputs must have a non-empty last axis")
    length = a.shape[-1]
    g = -(-length // n)
    pad = g * n - length
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, pad))
    valid = (torch.arange(g * n, device=a.device) < length).reshape(g, n)
    valid = valid.expand(a.shape[:-1] + (g, n))

    if cfg.operand == "tf32":
        sa, ea, ma = _decompose_tf32(a)
        sb, eb, mb = _decompose_tf32(b)
    else:
        fmt = cfg.operand_format
        sa, ea, ma = fpmod.decompose(a, fmt)
        sb, eb, mb = fpmod.decompose(b, fmt)
    pa = cfg.plane_fn()(sa, ma)  # num_planes x (..., G*n)
    pb = cfg.plane_fn()(sb, mb)

    def to_front(x):
        x = x.reshape(x.shape[:-1] + (g, n))
        return torch.movedim(x, -2, 0)  # (G, ..., n)

    pa = [to_front(p) for p in pa]
    pb = [to_front(p) for p in pb]
    return pa, pb, to_front(ea), to_front(eb), torch.movedim(valid, -2, 0), g


def _decompose_tf32(x: torch.Tensor):
    """f32 -> TF32 fields: RNE-round the 24-bit magnitude to 11 bits.
    Returns (sign, unbiased exp, 11-bit magnitude): value = s*m*2**(e-10)
    after rounding — the TF32 input quantization TensorCores apply."""
    s, e, m = fpmod.decompose(x, fpmod.FP32)
    keep = 13  # 24 -> 11 bits
    q = m >> keep
    rb = (m >> (keep - 1)) & 1
    sticky = (m & ((1 << (keep - 1)) - 1)) != 0
    q = q + ((rb == 1) & (sticky | ((q & 1) == 1))).to(torch.int32)
    carry = q >= (1 << 11)
    q = torch.where(carry, q >> 1, q)
    e = torch.where(carry, e + 1, e)
    # subnormal f32 inputs keep mag < 2**10 (already representable)
    return s, e, q


def fp16_inner_product_raw(a, b, cfg: IPUConfig) -> Tuple[fx.FX, torch.Tensor]:
    """Approximate FP-IP over the last axis; returns the non-normalized
    accumulator (two-limb FX, exponent) before output rounding.

    a, b: tensors broadcastable to a common shape (..., N), cast to the
    operand format. The reduction runs in N/n groups of the IPU width n,
    one update per nibble iteration (and per MC cycle) per group, exactly
    as the hardware schedules it.
    """
    pa, pb, ea, eb, valid, g = _prepare_groups(a, b, cfg)
    batch_shape = ea.shape[1:-1]

    # EHU (stages 1-4), shared across the nibble iterations of a group.
    out = ehu.run(ea, eb, cfg.mask_threshold, valid=valid, axis=-1)
    max_c, shift, active = out.max_exp, out.shift, out.active
    if cfg.multi_cycle:
        cyc, local = ehu.service_schedule(shift, active, cfg.sp)

    z = torch.zeros(batch_shape, dtype=torch.int32, device=ea.device)
    acc = fx.FX(z, z)
    exp_acc = torch.full(batch_shape, NEG_INF_EXP, dtype=torch.int32,
                         device=ea.device)
    for gi in range(g):
        mc = max_c[gi]
        for i, j in cfg.iteration_pairs():
            d = pa[i][gi] * pb[j][gi]  # |d| <= 225
            dw = d << (cfg.w - 9)
            pre = cfg.pre_shift(i, j)
            if not cfg.multi_cycle:
                aligned = _shr_i32(dw, shift[gi], cfg.rounding)
                aligned = torch.where(active[gi], aligned,
                                      torch.zeros_like(aligned))
                s_tree = torch.sum(aligned, dim=-1, dtype=torch.int32)
                acc, exp_acc = accumulate(acc, exp_acc, s_tree, mc, pre,
                                          torch.zeros_like(mc), cfg)
                continue
            for k in range(cfg.num_cycles_static):
                aligned = _shr_i32(dw, local[gi], cfg.rounding)
                aligned = torch.where(cyc[gi] == k, aligned,
                                      torch.zeros_like(aligned))
                s_tree = torch.sum(aligned, dim=-1, dtype=torch.int32)
                acc, exp_acc = accumulate(acc, exp_acc, s_tree, mc, pre,
                                          torch.full_like(mc, k * cfg.sp),
                                          cfg)
    return acc, exp_acc


def fp16_inner_product(a, b, cfg: IPUConfig = IPUConfig()) -> torch.Tensor:
    """Approximate FP-IP (paper Fig. 2) rounded to the accumulator format.

    Returns float16 for cfg.accum='fp16', float32 for 'fp32', bfloat16
    for 'bf16'.
    """
    acc, exp_acc = fp16_inner_product_raw(a, b, cfg)
    return fx.round_to_fp(acc, exp_acc, cfg.accum_format)


def int_inner_product(a, b, a_bits: int, b_bits: int,
                      cfg: IPUConfig = IPUConfig()) -> torch.Tensor:
    """INT-mode inner product over the last axis (paper §2.1). Exact.

    a, b: int32 tensors of two's-complement values fitting a_bits/b_bits.
    Nibble-decomposed and accumulated exactly as the hardware (result is
    bit-identical to the wide integer dot product). Returns int32.
    """
    a = torch.as_tensor(a).to(torch.int32)
    b = torch.as_tensor(b).to(torch.int32)
    a, b = torch.broadcast_tensors(a, b)
    pa = nibble.int_planes(a, a_bits)
    pb = nibble.int_planes(b, b_bits)
    acc = fx.zero_like(a[..., 0])
    for i, p in enumerate(pa):
        for j, q in enumerate(pb):
            s = torch.sum(p * q, dim=-1, dtype=torch.int32)
            acc = fx.add(acc, fx.shl(fx.from_int32(s), 4 * (i + j)))
    return acc.hi * (1 << fx.LIMB_BITS) + acc.lo  # caller range: < 2**31


def fp16_inner_product_exact_fp32(a, b) -> torch.Tensor:
    """Reference: FP-IP in f32 (products exact, f32-rounded sum) — the
    'GPU-like' baseline used in accuracy comparisons, NOT the oracle."""
    a = torch.as_tensor(a).to(torch.float32)
    b = torch.as_tensor(b).to(torch.float32)
    return torch.sum(a * b, dim=-1)
