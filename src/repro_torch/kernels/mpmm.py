"""Wrapper of the FP-IP matmul kernel (``csrc/mpmm.cu``).

``mp_matmul`` replaces ``repro/kernels/mpmm.py::_mpmm_kernel`` together
with the ``round_to_fp`` epilogue the reference runs after it: the
paper's bounded-alignment approximate FP16 inner product (IPU(w)) at
matmul scale, bit-exact for every output element. On a CPU tensor it
runs its plain version (``ref.mp_matmul_blocked_ref``); on a CUDA tensor
it launches the kernel on the current stream or raises, with its launch
plan chosen here by :func:`plan_mpmm`, a pure function the CPU tests
reach. ``LAUNCHES`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import functools
from fractions import Fraction
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import fp16 as fpmod
from repro_torch.core.ipu import IPUConfig
from repro_torch.kernels import _build, ref
from repro_torch.kernels.qmm import (_sm_count, call_on, expect, on_cpu,
                                     stream_handle)

LAUNCHES = {"mp_matmul": 0}

# csrc/mpmm.cu's kernel: threads a block, rows it holds in registers,
# block widths, blocks of one cluster (the K ranges of a tile), and the
# blocks an SM runs at a time (128 registers a thread)
THREADS = 256
MPMM_ROWS = (1, 2, 4, 8)
MPMM_WIDTHS = (32, 64, 128, 256)
MAX_SPLITS = 8
BLOCKS_PER_SM = 2


class MpmmPlan(NamedTuple):
    """Launch plan of ``mp_matmul``'s kernel: chunks of ``rows`` rows
    held in registers, ``bn`` columns a block with ``THREADS // bn``
    k-lanes, and ``splits`` blocks a tile (one thread block cluster).
    The K-groups go in rounds of ``splits * lanes``: in round q, lane l
    of rank c takes group (q * splits + c) * lanes + l."""
    rows: int
    bn: int
    splits: int

    @property
    def lanes(self) -> int:
        return THREADS // self.bn

    def grid(self, m: int, n: int) -> Tuple[int, int, int]:
        return (-(-n // self.bn), self.splits, -(-m // self.rows))

    def blocks(self, m: int, n: int) -> int:
        x, y, z = self.grid(m, n)
        return x * y * z

    def rounds(self, k: int, g: int) -> int:
        return -(-(-(-k // g)) // (self.splits * self.lanes))

    def ranges(self, k: int, g: int) -> List[List[Tuple[int, int]]]:
        """Per round, per rank, the groups [g0, g1) it takes (empty past
        the last group), in K order."""
        groups = -(-k // g)
        out = []
        for q in range(self.rounds(k, g)):
            row = []
            for c in range(self.splits):
                g0 = min(groups, (q * self.splits + c) * self.lanes)
                row.append((g0, min(groups, g0 + self.lanes)))
            out.append(row)
        return out


def plan_cost(plan: MpmmPlan, m: int, n: int, k: int, g: int,
              sms: int) -> Fraction:
    """The planner's model of a launch's time, in rounds of one 8-row
    block on an SM slot: waves x (rounds + 1 for a block's setup and its
    first staging) x the cost of a round. A round costs every thread one
    group for ``rows`` rows and a share that does not scale with them
    (B's decode, staging, barriers): (rows + 4) / 12 of an 8-row round;
    1/5 more across a cluster (splits > 1: cluster barriers, remote
    traffic), and bn / 512 more for a block's wider tile. Waves are
    whole up to two and fractions past them, where the card refills
    SMs as blocks finish. Fitted to the per-launch times of forced plans
    on an H100 (chip_smoke.py's ``plans_us``; PERF.md)."""
    slots = BLOCKS_PER_SM * sms
    blocks = plan.blocks(m, n)
    waves = (Fraction(blocks, slots) if blocks > 2 * slots
             else Fraction(-(-blocks // slots)))
    cluster = Fraction(6, 5) if plan.splits > 1 else 1
    return (waves * (plan.rounds(k, g) + 1) * Fraction(plan.rows + 4, 12)
            * cluster * (1 + Fraction(plan.bn, 512)))


@functools.lru_cache(maxsize=4096)
def plan_mpmm(m: int, n: int, k: int, g: int, sms: int,
              splits: Optional[int] = None,
              bn: Optional[int] = None,
              rows: Optional[int] = None) -> MpmmPlan:
    """The plan for an (m, k) x (k, n) product in K-groups of ``g`` on a
    card of ``sms`` SMs: over row chunks of up to the fewest register
    rows that hold m (a power of two, at most 8), the block widths and 1
    to ``MAX_SPLITS`` blocks a tile, the least :func:`plan_cost`; ties go
    to fewer blocks a tile, then to narrower blocks, then to more rows.
    ``splits``, ``bn`` and ``rows`` force those choices."""
    if (min(m, n, g, sms) < 1 or k < 0
            or (splits is not None and not 1 <= splits <= MAX_SPLITS)
            or (bn is not None and bn not in MPMM_WIDTHS)
            or (rows is not None and rows not in MPMM_ROWS)):
        raise ValueError(f"no plan for m={m} n={n} k={k} g={g} sms={sms} "
                         f"splits={splits} bn={bn} rows={rows}")
    most = next((r for r in MPMM_ROWS if r >= m), MPMM_ROWS[-1])
    best, best_key = None, None
    for r in ([rows] if rows is not None
              else [r for r in MPMM_ROWS if r <= most]):
        for width in ([bn] if bn is not None else MPMM_WIDTHS):
            for c in ([splits] if splits is not None
                      else range(1, MAX_SPLITS + 1)):
                plan = MpmmPlan(r, width, c)
                key = (plan_cost(plan, m, n, k, g, sms), c, width, -r)
                if best_key is None or key < best_key:
                    best, best_key = plan, key
    return best


@functools.lru_cache(maxsize=None)
def _mpmm_library():
    """``csrc/mpmm.cu``'s library, looked up once (built at the first
    launch, never at import)."""
    return _build.library("mpmm")


def _b_vec(b: torch.Tensor) -> int:
    """The widest copy (16, 4 or 2 bytes) that every row of the
    contiguous f16 ``b`` allows: its pointer and its row stride both
    aligned."""
    row = 2 * b.shape[1]
    for v in (16, 4):
        if b.data_ptr() % v == 0 and row % v == 0:
            return v
    return 2


def check_config(cfg: IPUConfig) -> None:
    """The kernel is the plain FP16-operand IPU(w), as the reference's."""
    if cfg.multi_cycle:
        raise NotImplementedError(
            "kernel implements plain IPU(w); MC-IPU emulation is the "
            "core.ipu path (bit-different truncation points)")
    if cfg.operand != "fp16":
        raise NotImplementedError(
            "mpmm kernel is FP16-operand; BF16/TF32 run via core.ipu")


def mp_matmul(a: torch.Tensor, b: torch.Tensor,
              cfg: IPUConfig = IPUConfig(), *,
              fused: bool = False,
              plan: Optional[MpmmPlan] = None) -> torch.Tensor:
    """Approximate FP-IP matmul: (M, K) f16 x (K, N) f16 -> (M, N) in the
    accumulator format (f32, f16 or bf16). ``fused=False`` is the
    paper-faithful nine-plane datapath, ``fused=True`` the single-plane
    mode. ``plan`` replaces the launch plan (default
    :func:`plan_mpmm`)."""
    check_config(cfg)
    expect(a, "a", torch.float16)
    expect(b, "b", torch.float16)
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if on_cpu(a, b):
        return ref.mp_matmul_blocked_ref(a, b, cfg, fused=fused)
    m, k = a.shape
    n = b.shape[1]
    fmt = cfg.accum_format
    out = torch.empty((m, n), dtype=fpmod.native_dtype(fmt), device=a.device)
    if m == 0 or n == 0:
        return out                    # an empty grid is not a launch
    if plan is None:
        plan = plan_mpmm(m, n, k, cfg.n, _sm_count(a.device))
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, cfg.n,
            cfg.w, cfg.mask_threshold, int(fused),
            int(cfg.rounding == "floor"), fmt.exp_bits, fmt.mant_bits,
            *plan, _b_vec(b), stream_handle(a))
    lib = _mpmm_library()
    err = call_on(a.device, lib.mpmm_launch, *args)
    _build.check(err, "mp_matmul")
    LAUNCHES["mp_matmul"] += 1
    return out
