"""Cycle-accurate performance model of MC-IPU convolution tiles (§4.1)
(a numpy copy of ``repro/core/simulator.py``, the router's cost model).

Models the paper's simulator: given a convolution workload, a tile
configuration (unrolls, cluster size, IPU precision) and the *statistics
of operand exponents*, compute execution cycles.

Mechanics modelled:
  * nibble iterations per inner-product group (INT: product of operand
    nibble counts; FP16: 9),
  * MC-IPU multi-cycle alignment: per group the EHU schedule is shared by
    all nine nibble iterations, so a group costing k cycles of alignment
    costs 9*k total (paper §3.2),
  * intra-tile clustering (§3.3): IPUs in a cluster stall together; the
    tile's clusters run independently (local buffers), so tile time is
    the max over clusters of their summed cycles. ``cluster_size=None``
    means the whole tile is one cluster (no clustering, the worst case).
  * empty-partition skipping (Fig. 5 threshold walk vs. an optimized
    scheduler) as an ablation flag.

The exponent statistics are sampled: activation/weight values are drawn
from a distribution (synthetic Laplace/Normal/uniform, as the paper uses)
or from empirical tensors; product exponent differences within each group
drive the per-group cycle counts. Everything is vectorized numpy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.workloads import ConvLayer


# --------------------------------------------------------------- operands

@dataclasses.dataclass(frozen=True)
class OperandTypes:
    """Workload datatype: integer bits or an FP format, per operand.

    FP operand ``bits`` are *significand magnitude* bits (hidden bit
    included) — the width the nibble-serial datapath actually iterates
    over: 12 for FP16 (sign-magnitude mantissa + round bits, paper
    §2.1), 4 for fp8 e4m3 (1 hidden + 3 mantissa), 2 for fp4 e2m1.
    Any fp operand engages the exponent-alignment machinery (EHU +
    shifters), narrower significands just take fewer iterations."""

    a_kind: str = "int"   # 'int' | 'fp16' | 'fp8' | 'fp4'
    a_bits: int = 4
    b_kind: str = "int"
    b_bits: int = 4

    @property
    def is_fp(self) -> bool:
        return (self.a_kind.startswith("fp")
                or self.b_kind.startswith("fp"))


INT4 = OperandTypes("int", 4, "int", 4)
INT8x4 = OperandTypes("int", 8, "int", 4)
INT8 = OperandTypes("int", 8, "int", 8)
FP16 = OperandTypes("fp16", 12, "fp16", 12)  # 12b signed magnitudes
# fp storage tier (quant/prepare): int8 activations against fp-coded
# weights — the weight side dequantizes through the alignment datapath
FP8 = OperandTypes("int", 8, "fp8", 4)    # e4m3: 4b significand
FP4 = OperandTypes("int", 8, "fp4", 2)    # e2m1: 2b significand


# ------------------------------------------------------------- exp source

class ExponentSource:
    """Samples product exponents for (group, lane) draws.

    ``kind``: 'laplace' | 'normal' | 'uniform' | 'lognormal_wide'
    (backward-path-like) | 'empirical' (values array provided).
    sigma: scale of the value distribution before FP16 cast.
    """

    def __init__(self, kind: str = "laplace", sigma: float = 1.0,
                 values: Optional[np.ndarray] = None,
                 weight_kind: Optional[str] = None,
                 weight_sigma: Optional[float] = None,
                 weight_values: Optional[np.ndarray] = None):
        self.kind = kind
        self.sigma = sigma
        self.values = values
        self.weight_kind = weight_kind or kind
        self.weight_sigma = weight_sigma if weight_sigma is not None else sigma
        self.weight_values = weight_values

    def _draw(self, rng: np.random.Generator, shape, kind, sigma, values):
        if kind == "empirical":
            v = rng.choice(values.ravel(), size=shape)
        elif kind == "laplace":
            v = rng.laplace(0.0, sigma, shape)
        elif kind == "normal":
            v = rng.normal(0.0, sigma, shape)
        elif kind == "uniform":
            v = rng.uniform(-sigma, sigma, shape)
        elif kind == "exp_normal":
            # exponent-controlled: value = sign * 2**N(0, sigma). The
            # forward calibration sigma=1.1 reproduces the paper's Fig.-9
            # tail (<1% of alignments exceed 8) and the ~1.2x multi-cycle
            # factor implied by Table 1 / the +25% TFLOPS headline.
            v = np.exp2(rng.normal(0.0, sigma, shape)) * rng.choice(
                [-1.0, 1.0], shape)
        elif kind == "lognormal_wide":
            # wide dynamic range, resembling backprop error tensors
            v = rng.normal(0.0, 1.0, shape) * np.exp2(
                rng.normal(0.0, 4.0, shape))
        else:
            raise ValueError(kind)
        return v

    def product_exponents(self, rng: np.random.Generator,
                          shape: Tuple[int, ...]) -> np.ndarray:
        """Unbiased exponents of FP16 products a*b for the given shape."""
        a = self._draw(rng, shape, self.kind, self.sigma, self.values)
        b = self._draw(rng, shape, self.weight_kind, self.weight_sigma,
                       self.weight_values)
        return (_fp16_exp(a) + _fp16_exp(b)).astype(np.int32)


def _fp16_exp(v: np.ndarray) -> np.ndarray:
    """Unbiased FP16 exponent of values (0 -> min exp -14). Values beyond
    the FP16 range saturate to the max normal exponent (overflow clamps)."""
    with np.errstate(over="ignore"):
        v16 = np.asarray(np.clip(v, -65504.0, 65504.0), np.float16)
    bits = v16.view(np.uint16)
    e = ((bits >> 10) & 0x1F).astype(np.int32)
    return np.where(e == 0, -14, np.minimum(e, 30) - 15)


FORWARD_SOURCE = ExponentSource("exp_normal", sigma=1.1,
                                weight_kind="exp_normal", weight_sigma=1.1)
BACKWARD_SOURCE = ExponentSource("lognormal_wide", weight_kind="normal",
                                 weight_sigma=0.05)


# ------------------------------------------------------------------ tiles

@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Convolution tile (paper §4.1). Defaults = the 'big' tile.

    (c_unroll, k_unroll, h_unroll, w_unroll) = (C, K, H, Wo) unrolls; the
    small tile is (8, 8, 2, 2). ``adder_w`` is the MC-IPU precision; 38
    reproduces the baselines (single-cycle for any FP16 alignment).
    """

    c_unroll: int = 16
    k_unroll: int = 16
    h_unroll: int = 2
    w_unroll: int = 2
    n_tiles: int = 4
    adder_w: int = 38
    cluster_size: Optional[int] = None   # None -> whole tile in lockstep
    sw_precision: int = 28               # FP32 accumulation default
    skip_empty_partitions: bool = False
    ehu_share: int = 4                   # IPUs per EHU (area model input)
    weight_buf_depth: int = 9            # bytes (paper: depth of 9B)

    @property
    def ipus_per_tile(self) -> int:
        return self.k_unroll * self.h_unroll * self.w_unroll

    @property
    def macs_per_cycle(self) -> int:
        return self.c_unroll * self.ipus_per_tile * self.n_tiles

    @property
    def sp(self) -> int:
        return self.adder_w - 9

    def effective_cluster(self) -> int:
        return self.cluster_size or self.ipus_per_tile


BIG_TILE = TileConfig()
SMALL_TILE = TileConfig(c_unroll=8, k_unroll=8)
BASELINE1 = dataclasses.replace(SMALL_TILE, adder_w=38)
BASELINE2 = dataclasses.replace(BIG_TILE, adder_w=38)


def tile_for(n_inputs: int) -> TileConfig:
    """The paper's tile for an IPU input width (16 -> big, 8 -> small)."""
    if n_inputs not in (8, 16):
        raise ValueError(f"no paper tile with {n_inputs}-input IPUs")
    return BIG_TILE if n_inputs == 16 else SMALL_TILE


# ------------------------------------------------------------- simulation

@dataclasses.dataclass
class LayerStats:
    name: str
    cycles: float
    ideal_cycles: float        # same datapath, alignment always 1 cycle
    groups: int                # inner-product groups per output pass
    passes: int
    iterations_per_group: int
    utilization: float         # MAC array utilization from shape padding
    mc_factor: float           # mean alignment cycles per nibble iteration


def _nibbles(bits: int) -> int:
    return -(-bits // 4)


def iterations_per_group(types: OperandTypes) -> int:
    return _nibbles(types.a_bits) * _nibbles(types.b_bits)


def _group_cycles(exp: np.ndarray, sp: int, sw_precision: int,
                  skip_empty: bool) -> np.ndarray:
    """Alignment cycles per group given product exponents (..., n)."""
    mx = exp.max(axis=-1, keepdims=True)
    shift = mx - exp
    active = shift <= sw_precision
    k = np.where(active, shift // sp, -1)
    if skip_empty:
        kmax = sw_precision // sp + 1
        occ = np.zeros(k.shape[:-1] + (kmax + 1,), bool)
        np.put_along_axis(occ, np.maximum(k, 0), k >= 0, axis=-1)
        cycles = occ.sum(-1)
    else:
        cycles = k.max(axis=-1) + 1
    return np.maximum(cycles, 1)


def simulate_layer(layer: ConvLayer, tile: TileConfig,
                   types: OperandTypes = FP16,
                   source: ExponentSource = FORWARD_SOURCE,
                   rng: Optional[np.random.Generator] = None,
                   n_group_samples: int = 512) -> LayerStats:
    """Cycles to run one conv layer on the tile array."""
    rng = rng or np.random.default_rng(0)
    groups = -(-layer.c // tile.c_unroll) * layer.r * layer.s
    k_passes = -(-layer.k // tile.k_unroll)
    pix_passes = -(-layer.ho // tile.h_unroll) * -(-layer.wo // tile.w_unroll)
    passes = k_passes * pix_passes * layer.count
    # tiles split passes evenly (independent work)
    passes_per_tile = -(-passes // tile.n_tiles)
    iters = iterations_per_group(types)

    util_c = layer.c / (-(-layer.c // tile.c_unroll) * tile.c_unroll)
    util_k = layer.k / (-(-layer.k // tile.k_unroll) * tile.k_unroll)
    util_p = (layer.ho * layer.wo) / (
        pix_passes * tile.h_unroll * tile.w_unroll)
    util = util_c * util_k * util_p

    if not types.is_fp or tile.adder_w >= tile.sw_precision:
        # INT mode (no alignment), or the adder covers the software
        # precision: a plain IPU(w) serves any alignment <= w in one
        # truncating cycle (§3.1/§4.3) — multi-cycling only exists to
        # deliver P > w accurately (§3.2).
        cycles = passes_per_tile * groups * iters
        return LayerStats(layer.name, float(cycles), float(cycles), groups,
                          passes, iters, util, 1.0)

    # FP mode with MC-IPU: sample per-(group, IPU) alignment cycles.
    n_ipus = tile.ipus_per_tile
    csize = tile.effective_cluster()
    n_clusters = max(n_ipus // csize, 1)
    samples = min(n_group_samples, max(passes_per_tile * groups, 1))
    exp = source.product_exponents(
        rng, (samples, n_ipus, tile.c_unroll))
    g_cycles = _group_cycles(exp, tile.sp, tile.sw_precision,
                             tile.skip_empty_partitions)  # (samples, n_ipus)
    # lockstep within a cluster: per-group max over members
    g_cycles = g_cycles.reshape(samples, n_clusters, csize).max(-1)
    # independent clusters: each runs sum over its groups; tile waits for
    # the slowest cluster (infinite local buffers; see DESIGN.md).
    per_cluster_mean = g_cycles.mean(axis=0)  # (n_clusters,)
    mc_factor = float(per_cluster_mean.max())
    total_groups = passes_per_tile * groups
    cycles = total_groups * iters * mc_factor
    ideal = total_groups * iters
    return LayerStats(layer.name, float(cycles), float(ideal), groups,
                      passes, iters, util, mc_factor)


@dataclasses.dataclass
class NetworkStats:
    layers: List[LayerStats]

    @property
    def cycles(self) -> float:
        return sum(l.cycles for l in self.layers)

    @property
    def ideal_cycles(self) -> float:
        return sum(l.ideal_cycles for l in self.layers)

    @property
    def slowdown(self) -> float:
        return self.cycles / self.ideal_cycles

    @property
    def mean_mc_factor(self) -> float:
        return self.slowdown


def simulate_network(layers: Iterable[ConvLayer], tile: TileConfig,
                     types: OperandTypes = FP16,
                     source: ExponentSource = FORWARD_SOURCE,
                     seed: int = 0,
                     n_group_samples: int = 512) -> NetworkStats:
    rng = np.random.default_rng(seed)
    return NetworkStats([
        simulate_layer(l, tile, types, source, rng, n_group_samples)
        for l in layers
    ])


def normalized_exec_time(layers: Sequence[ConvLayer], tile: TileConfig,
                         baseline: TileConfig,
                         types: OperandTypes = FP16,
                         source: ExponentSource = FORWARD_SOURCE,
                         seed: int = 0) -> float:
    """Execution time of ``tile`` normalized to ``baseline`` (Fig. 8)."""
    t = simulate_network(layers, tile, types, source, seed).cycles
    b = simulate_network(layers, baseline, types, source, seed).cycles
    return t / b


def exponent_diff_histogram(source: ExponentSource, n: int = 16,
                            samples: int = 100_000, seed: int = 0,
                            max_diff: int = 59) -> np.ndarray:
    """Distribution of (max_exp - exp) alignment sizes (Fig. 9)."""
    rng = np.random.default_rng(seed)
    exp = source.product_exponents(rng, (samples, n))
    diff = exp.max(-1, keepdims=True) - exp
    hist = np.bincount(diff.ravel().clip(0, max_diff), minlength=max_diff + 1)
    return hist / hist.sum()
