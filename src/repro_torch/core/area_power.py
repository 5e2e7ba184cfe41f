"""Analytical 7nm area/power model of MC-IPU convolution tiles
(a numpy copy of ``repro/core/area_power.py``, the router's cost model).

The paper evaluates synthesized SystemVerilog (Synopsys DC, 7nm, 0.71V,
25% margin). Gate-level synthesis cannot run here, so we model each
datapath component with first-order gate-count scaling laws and calibrate
the unit constants against the paper's published numbers (Fig. 7
breakdown, Table 1 efficiency matrix, §4.2 deltas: 38b->28b adder saves
15-17% tile area; 12b adder saves up to 39%; FP16 support on MC-IPU(12)
costs +43% over INT-only).

Component laws (standard-cell first-order):
  multiplier (a x b bits)     ~ alpha_m * (a+1) * (b+1)   (array of FAs)
  adder tree (n inputs, w)    ~ alpha_a * (n - 1) * (w + log2(n)/2)
  barrel shifter (w wide, r range) ~ alpha_s * w * log2(r)
  registers / SRAM            ~ alpha_r / alpha_sram * bits
  EHU                         ~ adders + max-tree + compare on exponents
  fixed control per IPU       ~ ctrl_area                 (pipeline regs)
  misc control                ~ fixed fraction of datapath

Power uses per-component activity-weighted constants fitted the same way.
The calibration is produced by tools/calibrate_area.py (least squares over
Table 1 cells + Fig. 7 deltas) and frozen in DEFAULT_CAL; tests assert the
model reproduces the paper's tables within tolerance.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.simulator import (FP4, FP8, FP16, INT4, INT8, INT8x4,
                                  OperandTypes, TileConfig,
                                  iterations_per_group)

F_CLK = 0.488e9  # Hz — matches the paper's 4-TOPS big-tile baseline


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Unit-cost constants (um^2 / mW-per-um^2 classes), fitted by
    tools/calibrate_area.py against the paper's published numbers."""

    a_scale: float = 0.1723
    b_scale: float = 9.64
    alpha_mult: float = 0.95
    alpha_add: float = 1.10
    alpha_shift: float = 0.42
    alpha_reg: float = 0.65
    alpha_sram: float = 0.30
    alpha_and: float = 0.08
    ctrl_area: float = 0.0       # fixed um^2-units per IPU
    misc_fraction: float = 0.18
    serial_area_factor: float = 0.5
    serial_power_factor: float = 1.8
    beta_mult: float = 1.05e-3
    beta_adder: float = 0.95e-3
    beta_shift: float = 0.80e-3
    beta_reg: float = 0.55e-3
    beta_sram: float = 0.25e-3
    beta_ehu: float = 0.70e-3
    beta_ctrl: float = 0.55e-3

    def alpha(self, name: str) -> float:
        return getattr(self, f"alpha_{name}") * self.a_scale

    def beta(self, name: str) -> float:
        return getattr(self, f"beta_{name}") * self.b_scale


# Frozen output of tools/calibrate_area.py (least squares over Table 1
# cells, Fig. 7 deltas, and abstract headline gains):
#   table1 median |err| 3.0%, max 14.3%
#   fig7 deltas: -17.7% / -43.0% / +44.4% (targets -17 / -39 / +43)
DEFAULT_CAL = Calibration(
    a_scale=0.304053,
    b_scale=9.91956,
    alpha_add=0.2,
    alpha_shift=0.445554,
    alpha_reg=1.38445,
    alpha_sram=0.161124,
    ctrl_area=400,
    serial_area_factor=0.1,
    serial_power_factor=1.0,
    beta_mult=0.00112049,
    beta_reg=0.000184674,
    beta_sram=0.0001012,
    misc_fraction=0.5,
)


@dataclasses.dataclass(frozen=True)
class IPUDesign:
    """One design point of the sensitivity study (§4.5, Table 1)."""

    name: str
    mult_a: int = 4            # multiplier operand bits (activation side)
    mult_b: int = 4            # weight side
    adder_w: int = 16          # adder tree precision (w)
    fp_support: bool = True
    tile: TileConfig = TileConfig()
    cluster_size: Optional[int] = None  # None -> no clustering
    # average MC alignment cycles per nibble iteration for FP16 workloads;
    # produced by the simulator (simulate_network().slowdown); 1.0 = never
    # multi-cycle (wide adder).
    fp_mc_factor: float = 1.0
    # FP16 iterations override. The paper's 8x8-based designs compute an
    # FP16 mantissa product in 2 cycles (NVDLA-style spatial decomposition
    # into two INT8 units — visible in Table 1's INT8:FP16 ratio of ~2),
    # not the naive ceil(12/8)**2 = 4; serial designs pay extra passes.
    fp16_iters: Optional[float] = None

    def n_inputs(self) -> int:
        return self.tile.c_unroll

    def supports(self, t: OperandTypes) -> bool:
        if t.is_fp and not self.fp_support:
            return False
        return True

    def iterations(self, t: OperandTypes) -> float:
        """Nibble/serial iterations per inner product for a workload.

        FP iterations scale with the operand *significand* widths
        (OperandTypes carries them: 12 for FP16, 4 for fp8 e4m3, 2 for
        fp4 e2m1); the ``fp16_iters`` override models 12-bit-specific
        decompositions (NVDLA dual-INT8, serial double pass) and so
        applies only to full-width (>= 12b) significands."""
        if t.is_fp:
            if self.fp16_iters is not None and min(t.a_bits,
                                                   t.b_bits) >= 12:
                it = self.fp16_iters
            else:
                it = ((-(-t.a_bits // self.mult_a))
                      * (-(-t.b_bits // self.mult_b)))
            return it * self.fp_mc_factor
        ia = -(-t.a_bits // self.mult_a)
        ib = -(-t.b_bits // self.mult_b)
        return ia * ib


# ------------------------------------------------------------ area model

def _log2(x: float) -> float:
    return math.log2(max(x, 2.0))


def ipu_component_areas(d: IPUDesign, cal: Calibration = None
                        ) -> Dict[str, float]:
    """um^2 per IPU, by component (paper Fig. 7 categories + CTRL)."""
    cal = cal or DEFAULT_CAL
    n = d.n_inputs()
    w = d.adder_w
    areas: Dict[str, float] = {}
    areas["MULT"] = n * cal.alpha("mult") * (d.mult_a + 1) * (d.mult_b + 1)
    if d.mult_b == 1:
        # Serial (Stripes-like) datapath: the "multiplier" is an AND row —
        # smaller than the array-multiplier law predicts (fitted factor).
        areas["MULT"] *= cal.serial_area_factor
    # adder tree over n products of width w
    areas["AT"] = cal.alpha("add") * (n - 1) * (w + _log2(n) / 2)
    if d.fp_support:
        # local right-shifters: one per multiplier, w wide, range w
        areas["Shft"] = n * cal.alpha("shift") * w * _log2(w)
        # EHU share: exponent adders (6b), max tree, subtract + compare;
        # amortized over tile.ehu_share IPUs
        ehu = (n * cal.alpha("add") * 6 * 2 + (n - 1) * cal.alpha("add") * 6
               + n * cal.alpha("add") * 6 + n * cal.alpha("reg") * 8)
        areas["ShCNT"] = ehu / d.tile.ehu_share
        # masking ANDs for MC service (9b products)
        areas["Shft"] += n * cal.alpha("and") * 9
    else:
        areas["Shft"] = 0.0
        areas["ShCNT"] = 0.0
    # accumulator: register + shifter + adder. INT-only designs carry a
    # narrower fixed-point accumulator.
    t_bits = math.ceil(_log2(n))
    acc_bits = (33 + t_bits + 10) if d.fp_support else (
        d.mult_a + d.mult_b + 4 + t_bits + 10)
    areas["FAcc"] = (cal.alpha("reg") * acc_bits
                     + cal.alpha("shift") * acc_bits * _log2(acc_bits)
                     + cal.alpha("add") * acc_bits)
    # weight buffer: depth bytes x n multipliers x 8 bits
    areas["WBuf"] = cal.alpha("sram") * d.tile.weight_buf_depth * 8 * n
    # fixed per-IPU control/pipeline registers
    areas["CTRL"] = cal.ctrl_area * cal.a_scale
    return areas


_POWER_CLASS = {"MULT": "mult", "AT": "adder", "Shft": "shift",
                "ShCNT": "ehu", "FAcc": "reg", "WBuf": "sram",
                "CTRL": "ctrl"}


def tile_area_mm2(d: IPUDesign, cal: Calibration = None) -> float:
    cal = cal or DEFAULT_CAL
    per_ipu = sum(ipu_component_areas(d, cal).values())
    n_ipus = d.tile.ipus_per_tile
    total = per_ipu * n_ipus * (1 + cal.misc_fraction)
    # cluster buffers (input/output per cluster, §3.3)
    if d.cluster_size:
        n_clusters = max(n_ipus // d.cluster_size, 1)
        total += n_clusters * cal.alpha("sram") * 2 * 64 * 8  # 2x 64B bufs
    return total * d.tile.n_tiles / 1e6


def tile_power_w(d: IPUDesign, cal: Calibration = None) -> float:
    cal = cal or DEFAULT_CAL
    areas = ipu_component_areas(d, cal)
    mw = sum(areas[k] * cal.beta(_POWER_CLASS[k]) for k in areas)
    if d.mult_b == 1:
        # Serial datapath toggles its full pipeline every cycle (weight-bit
        # serializers + per-cycle accumulator writes): fitted activity.
        mw *= cal.serial_power_factor
    n_ipus = d.tile.ipus_per_tile
    mw = mw * n_ipus * (1 + cal.misc_fraction * 0.5)
    return mw * d.tile.n_tiles / 1e3


def area_breakdown(d: IPUDesign, cal: Calibration = None) -> Dict[str, float]:
    """Fig. 7(a): per-component fraction of tile area."""
    areas = ipu_component_areas(d, cal)
    tot = sum(areas.values())
    return {k: v / tot for k, v in areas.items()}


def power_breakdown(d: IPUDesign, cal: Calibration = None) -> Dict[str, float]:
    cal = cal or DEFAULT_CAL
    areas = ipu_component_areas(d, cal)
    pw = {k: areas[k] * cal.beta(_POWER_CLASS[k]) for k in areas}
    tot = sum(pw.values())
    return {k: v / tot for k, v in pw.items()}


# ------------------------------------------------------- efficiency model

def throughput_tops(d: IPUDesign, t: OperandTypes) -> Optional[float]:
    """Tera-ops/s for a workload type (Table 1 'TOPS'). The paper counts a
    MAC as 2 ops (§4.1: the 1024-MAC small tile is '1 TOPS')."""
    if not d.supports(t):
        return None
    macs_per_cycle = d.tile.macs_per_cycle  # at 1 iteration
    return 2 * macs_per_cycle * F_CLK / d.iterations(t) / 1e12


def efficiency(d: IPUDesign, t: OperandTypes, cal: Calibration = None
               ) -> Tuple[Optional[float], Optional[float]]:
    """(TOPS/mm^2, TOPS/W) for a design x workload (Table 1 cells)."""
    tops = throughput_tops(d, t)
    if tops is None:
        return None, None
    return tops / tile_area_mm2(d, cal), tops / tile_power_w(d, cal)


# ------------------------------------------------------ paper design set

def _big(**kw) -> TileConfig:
    return dataclasses.replace(TileConfig(), **kw)


def paper_designs(fp_mc_factors: Optional[Dict[str, float]] = None
                  ) -> Dict[str, IPUDesign]:
    """The §4.5 / Table 1 design points. ``fp_mc_factors`` supplies the
    simulator-derived mean alignment cycles per iteration (defaults to the
    values measured by benchmarks/fig8_perf.py on the forward study
    cases; 1.0 for wide-adder designs)."""
    f = {"MC-SER": 1.15, "MC-IPU4": 1.30, "MC-IPU84": 1.22,
         "MC-IPU8": 1.06}
    if fp_mc_factors:
        f.update(fp_mc_factors)
    D = IPUDesign
    designs = {
        "MC-SER": D("MC-SER", 12, 1, 16, True, _big(), 1, f["MC-SER"],
                    fp16_iters=24),  # serial sign-magnitude double pass
        "MC-IPU4": D("MC-IPU4", 4, 4, 16, True, _big(), 1, f["MC-IPU4"]),
        "MC-IPU84": D("MC-IPU84", 8, 4, 20, True, _big(), 1, f["MC-IPU84"]),
        "MC-IPU8": D("MC-IPU8", 8, 8, 23, True, _big(), 1, f["MC-IPU8"],
                     fp16_iters=2),  # spatial dual-INT8 decomposition
        "NVDLA": D("NVDLA", 8, 8, 36, True, _big(), None, 1.0,
                   fp16_iters=2),
        "FP16": D("FP16", 12, 12, 36, True, _big(), None, 1.0, fp16_iters=1),
        "INT8": D("INT8", 8, 8, 16, False, _big(), None, 1.0),
        "INT4": D("INT4", 4, 4, 9, False, _big(), None, 1.0),
    }
    return designs


def baseline_design(n_inputs: int = 16) -> IPUDesign:
    """'Typical mixed-precision implementation': 4x4 multipliers with a
    38-bit adder tree and no clustering (Baseline1/2 of §4.1)."""
    tile = TileConfig() if n_inputs == 16 else dataclasses.replace(
        TileConfig(), c_unroll=8, k_unroll=8)
    return IPUDesign("baseline", 4, 4, 38, True, tile, None, 1.0)


def optimized_design(n_inputs: int = 16, w: int = 16, cluster: int = 1,
                     fp_mc_factor: float = 1.3) -> IPUDesign:
    tile = TileConfig() if n_inputs == 16 else dataclasses.replace(
        TileConfig(), c_unroll=8, k_unroll=8)
    tile = dataclasses.replace(tile, adder_w=w, cluster_size=cluster)
    return IPUDesign(f"mcipu({w},{cluster})", 4, 4, w, True, tile, cluster,
                     fp_mc_factor)


# Table 1 of the paper, for side-by-side reporting and tolerance tests.
PAPER_TABLE1 = {
    # design: {workload: (TOPS/mm2, TOPS/W)}
    "MC-SER":   {"4x4": (5.5, 1.4), "8x4": (5.5, 1.4), "8x8": (2.8, 0.7),
                 "fp16": (0.9, 0.2)},
    "MC-IPU4":  {"4x4": (18.8, 3.3), "8x4": (9.4, 1.7), "8x8": (4.7, 0.8),
                 "fp16": (1.6, 0.3)},
    "MC-IPU84": {"4x4": (14.3, 2.4), "8x4": (14.3, 2.4), "8x8": (7.2, 1.2),
                 "fp16": (1.8, 0.3)},
    "MC-IPU8":  {"4x4": (11.4, 1.8), "8x4": (11.4, 1.8), "8x8": (11.4, 1.8),
                 "fp16": (5.4, 0.8)},
    "NVDLA":    {"4x4": (9.7, 1.5), "8x4": (9.7, 1.5), "8x8": (9.7, 1.5),
                 "fp16": (4.9, 0.7)},
    "FP16":     {"4x4": (6.9, 0.9), "8x4": (6.9, 0.9), "8x8": (6.9, 0.9),
                 "fp16": (6.9, 0.9)},
    "INT8":     {"4x4": (18.5, 2.8), "8x4": (18.5, 2.8), "8x8": (18.5, 2.8),
                 "fp16": (None, None)},
    "INT4":     {"4x4": (30.6, 5.6), "8x4": (15.3, 2.8), "8x8": (7.7, 1.4),
                 "fp16": (None, None)},
}

WORKLOAD_TYPES = {"4x4": INT4, "8x4": INT8x4, "8x8": INT8, "fp16": FP16}

# fp storage-tier workloads (not Table 1 columns — the paper evaluates
# fp16 only; these score the fp8/fp4 prepared-weight modes the serving
# stack deploys, on the same alignment datapath with narrower
# significand iteration counts)
FP_STORAGE_TYPES = {"fp8": FP8, "fp4": FP4}

# §4.2 relative deltas (16-input tiles)
PAPER_FIG7_DELTAS = {
    "adder_38_to_28": -0.17,
    "adder_38_to_12": -0.39,
    "int_to_mcipu12": +0.43,
}


def fig7_deltas(cal: Calibration = None) -> Dict[str, float]:
    def tile_fp(w):
        return IPUDesign("x", 4, 4, w, True, TileConfig())
    a38 = tile_area_mm2(tile_fp(38), cal)
    a28 = tile_area_mm2(tile_fp(28), cal)
    a12 = tile_area_mm2(tile_fp(12), cal)
    aint = tile_area_mm2(IPUDesign("int", 4, 4, 9, False, TileConfig()), cal)
    return {
        "adder_38_to_28": a28 / a38 - 1,
        "adder_38_to_12": a12 / a38 - 1,
        "int_to_mcipu12": a12 / aint - 1,
    }


def table1_model(cal: Calibration = None
                 ) -> Dict[str, Dict[str, Tuple[Optional[float],
                                                Optional[float]]]]:
    """Model-predicted Table 1 (same keys as PAPER_TABLE1)."""
    out = {}
    for name, d in paper_designs().items():
        row = {}
        for wl, t in WORKLOAD_TYPES.items():
            row[wl] = efficiency(d, t, cal)
        out[name] = row
    return out


def headline_gains(fp_mc_factor_16: float = 1.3,
                   cal: Calibration = None) -> Dict[str, float]:
    """Abstract-style headline: the Pareto design (16-input, w=16,
    cluster=1) vs the typical mixed-precision baseline (same 4x4
    multipliers, 38-bit adder tree, no clustering) — TOPS for INT4 and
    TFLOPS for FP16, area and power efficiency gains."""
    base = baseline_design(16)
    opt = optimized_design(16, w=16, cluster=1, fp_mc_factor=fp_mc_factor_16)
    out = {}
    for wl in ("4x4", "fp16"):
        t = WORKLOAD_TYPES[wl]
        ba, bp = efficiency(base, t, cal)
        oa, op_ = efficiency(opt, t, cal)
        key = "tops" if wl == "4x4" else "tflops"
        out[f"{key}_per_mm2_gain"] = oa / ba - 1
        out[f"{key}_per_w_gain"] = op_ / bp - 1
    return out
