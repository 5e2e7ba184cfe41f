"""Wrappers of the fused kernels over stored operands.

``fused_qmm`` (``csrc/qmm.cu``) replaces
``repro/kernels/fused.py::_fused_qmm_kernel``: exact int on the int8
tensor cores, bit-equal to ``ref.fused_qmm_ref``, with its launch plan
chosen by ``kernels.qmm.plan_int_tc`` (the plan of ``qmm_packed`` too).
``fused_dequant_mm`` (``csrc/fused_dequant.cu``) replaces
``::_fused_dequant_kernel``: any storage kind, per-channel or per-group
scales, f32 accumulation, equal to ``ref.fused_dequant_mm_ref`` up to
the order of summation, with its launch plan chosen here by
:func:`plan_fused_dequant`, a pure function the CPU tests reach.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise. The static activation scale ``sa`` reaches
the kernels as a device pointer (a 0-d tensor), never through
``.item()``: the serving path would otherwise sync the host once per
projection. ``LAUNCHES`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.qmm import (IntTcPlan, _sm_count, alignment,
                                     call_on, expect, launch_int_tc, on_cpu,
                                     stream_handle)

LAUNCHES = {"fused_qmm": 0, "fused_dequant_mm": 0}

# storage kinds the kernels decode in-register, in the C enum's order
KINDS = ("int8", "int4", "int4_packed", "fp8", "fp4", "fp4_packed")
PACKED_KINDS = ("int4_packed", "fp4_packed")
ACTS = ("none", "qdq", "quant")
_STORAGE_DTYPE = {"int8": torch.int8, "int4": torch.int8,
                  "int4_packed": torch.int8, "fp8": torch.uint8,
                  "fp4": torch.uint8, "fp4_packed": torch.uint8}


# csrc/fused_dequant.cu's kernel: rows it holds in registers, block
# widths, K ranges (one thread block cluster) and their granule, a stage
# of stored weight bytes, and the most bytes of a block's activation
# slice in shared memory
ROW_LIMIT = 16
DECODE_ROWS = (1, 2, 4, 8, 16)
DECODE_WIDTHS = (128, 64, 32)
MAX_SPLITS = 8
K_STEP = 32
STAGE_BYTES = 4096
X_SLICE_BYTES = 147456
# the grid the planner aims for: at most this many blocks per SM. Two
# took 1.0-1.5 us less than one per MLP projection of qwen2-0.5b at 8
# rows on an H100, and 0.2-0.3 us more for wq/wo (chip_smoke.py phase 2,
# "fused_dequant_plans_us")
FD_BLOCKS_PER_SM = 2


class FusedPlan(NamedTuple):
    """Launch plan of ``fused_dequant_mm``'s kernel: chunks of ``rows``
    rows held in registers, ``bn`` columns per block and ``splits`` K
    ranges of ``kc`` k-rows each (the last one ragged); the splits of one
    tile form a thread block cluster that adds their partial sums in
    split order."""
    rows: int
    bn: int
    splits: int
    kc: int

    def grid(self, m: int, n: int) -> Tuple[int, int, int]:
        return (-(-n // self.bn), self.splits, -(-m // self.rows))

    def blocks(self, m: int, n: int) -> int:
        x, y, z = self.grid(m, n)
        return x * y * z

    def k_ranges(self, k: int) -> List[Tuple[int, int]]:
        return [(s * self.kc, min(k, (s + 1) * self.kc))
                for s in range(self.splits)]


def _stage_k(bn: int, kind: str) -> int:
    """k-rows of one stage of the kernel's weight ring."""
    return STAGE_BYTES // bn * (2 if kind in PACKED_KINDS else 1)


def max_kc(rows: int, bn: int, kind: str) -> int:
    """The longest K range whose activation slice (rows x k-rows, padded
    to whole stages, f32) fits the kernel's shared memory."""
    stage = _stage_k(bn, kind)
    return X_SLICE_BYTES // (4 * rows * stage) * stage


@functools.lru_cache(maxsize=4096)
def plan_fused_dequant(m: int, n: int, k: int, groups: int, kind: str,
                       sms: int, splits: Optional[int] = None,
                       blocks_per_sm: int = FD_BLOCKS_PER_SM) -> FusedPlan:
    """The plan for an (m, k) x stored (k, n) product with ``groups``
    scale groups on a card of ``sms`` SMs.

    Rows go in chunks of the fewest register rows (a power of two, at
    most ``ROW_LIMIT``) that hold m. Over blocks of 128, 64 and 32
    columns and 1 to ``MAX_SPLITS`` K ranges of a multiple of ``K_STEP``
    rows (never fewer than the activation slice needs, ``max_kc``), it
    takes the grid with the most blocks that stays within
    ``blocks_per_sm`` per SM, one wave; where every grid is larger (many
    row chunks), the one with the fewest. Ties go to wider blocks, then
    to fewer ranges. ``splits`` forces the number of ranges (at most
    ``ceil(k / K_STEP)`` come out)."""
    if (min(m, n, groups, sms, blocks_per_sm) < 1 or k < 0 or k % groups
            or kind not in KINDS or (kind in PACKED_KINDS and k % 2)
            or (splits is not None and not 1 <= splits <= MAX_SPLITS)):
        raise ValueError(f"no plan for m={m} n={n} k={k} groups={groups} "
                         f"kind={kind!r} sms={sms} splits={splits} "
                         f"blocks_per_sm={blocks_per_sm}")
    rows = next((r for r in DECODE_ROWS if r >= m), ROW_LIMIT)
    target = blocks_per_sm * sms
    steps = max(1, -(-k // K_STEP))
    plans = []
    for bn in DECODE_WIDTHS:
        least = max(1, -(-k // max_kc(rows, bn, kind)))
        counts = ([splits] if splits is not None
                  else range(least, min(MAX_SPLITS, steps) + 1))
        for want in counts:
            if want < least:
                continue
            kc = K_STEP * max(1, -(-k // (K_STEP * want)))
            plans.append(FusedPlan(rows, bn, max(1, -(-k // kc)), kc))
    if not plans:
        raise ValueError(f"no plan for m={m} k={k} {kind}: its activation "
                         f"slice needs more K ranges than "
                         f"{splits or MAX_SPLITS}")
    fits = [p for p in plans if p.blocks(m, n) <= target]
    if fits:
        return max(fits, key=lambda p: p.blocks(m, n))   # first on ties
    return min(plans, key=lambda p: p.blocks(m, n))


def max_launch_k(rows: int, kind: str) -> int:
    """The deepest K one launch takes at ``rows`` register rows:
    ``MAX_SPLITS`` K ranges, each within its activation slice at the
    block width that allows the longest."""
    return MAX_SPLITS * max(max_kc(rows, bn, kind) for bn in DECODE_WIDTHS)


@functools.lru_cache(maxsize=4096)
def k_slices(m: int, k: int, groups: int, kind: str) -> List[Tuple[int, int]]:
    """Consecutive K slices [k0, k1) that ``fused_dequant_mm`` launches
    its kernel on, one launch each, their f32 partials added in slice
    order: one slice where one launch takes K (``max_launch_k``), else
    the fewest slices of equal length that each fit it. With per-group
    scales every bound falls on a scale-group boundary (K / ``groups``
    k-rows a group), so a slice takes its own rows of the scales; for
    the packed kinds every bound is even, so a slice takes whole stored
    rows."""
    if min(m, groups) < 1 or k < 0 or k % groups or kind not in KINDS:
        raise ValueError(f"no K slices for m={m} k={k} groups={groups} "
                         f"kind={kind!r}")
    rows = next((r for r in DECODE_ROWS if r >= m), ROW_LIMIT)
    cap = max_launch_k(rows, kind)
    if k <= cap:
        return [(0, k)]
    # per-channel scales (one group) hold for any slice
    step = math.lcm(k // groups if groups > 1 else 1,
                    2 if kind in PACKED_KINDS else 1)
    if step > cap:
        raise ValueError(f"a scale group of {k // groups} k-rows is deeper "
                         f"than one launch takes ({cap})")
    count = -(-k // (cap // step * step))
    per = -(-k // (step * count)) * step
    return [(lo, min(k, lo + per)) for lo in range(0, k, per)]


@functools.lru_cache(maxsize=None)
def _fused_dequant_library():
    """``csrc/fused_dequant.cu``'s library, looked up once (built at the
    first launch, never at import)."""
    return _build.library("fused_dequant")


def _stored_k(w: torch.Tensor, kind: str) -> int:
    return w.shape[0] * (2 if kind in PACKED_KINDS else 1)


def _scalar(sa, x: torch.Tensor) -> torch.Tensor:
    """The act scale as a 0-d f32 tensor on x's device (a Python number
    is copied over once; a tensor already there passes through)."""
    sa = torch.as_tensor(sa, dtype=torch.float32, device=x.device)
    if sa.numel() != 1:
        raise ValueError(f"sa must be a scalar, got shape {tuple(sa.shape)}")
    return sa.reshape(())


def _scales(sw: torch.Tensor) -> torch.Tensor:
    if sw.dtype != torch.float32:
        raise TypeError(f"sw: want torch.float32, got {sw.dtype}")
    return sw.reshape(1, -1) if sw.dim() == 1 else sw


def fused_qmm(x: torch.Tensor, w: torch.Tensor, sw: torch.Tensor, sa, *,
              kind: str = "int8",
              plan: Optional[IntTcPlan] = None) -> torch.Tensor:
    """Exact fused int matmul: (M, K) f32 acts x stored int8 rows
    (``int8``/``int4``) or (K//2, N) packed int4 bytes -> (M, N) f32.
    ``sw`` holds (N,) or (1, N) per-channel scales. ``plan`` replaces the
    launch plan (default :func:`~repro_torch.kernels.qmm.plan_int_tc`);
    the kernel refuses one that does not cover K."""
    if kind not in ("int8", "int4", "int4_packed"):
        raise ValueError(f"fused_qmm takes int kinds, got {kind!r}")
    expect(x, "x", torch.float32)
    expect(w, "w", torch.int8)
    sw = _scales(sw)
    m, k = x.shape
    n = w.shape[1]
    if k != _stored_k(w, kind):
        raise ValueError(f"x {tuple(x.shape)} does not match stored "
                         f"{kind} weight {tuple(w.shape)}")
    if sw.shape != (1, n):
        raise ValueError(f"fused_qmm needs per-channel scales (1, {n}), "
                         f"got {tuple(sw.shape)}")
    if not (isinstance(sa, torch.Tensor) and sa.dim() == 0
            and sa.dtype == torch.float32 and sa.device == x.device):
        sa = _scalar(sa, x)
    if on_cpu(x, w, sw, sa):
        return ref.fused_qmm_ref(x, w, sw, sa, kind=kind)
    return launch_int_tc(x, w, sw.contiguous(), sa, kind == "int4_packed",
                         plan, LAUNCHES, "fused_qmm")


def fused_dequant_mm(x: torch.Tensor, w: torch.Tensor, sw: torch.Tensor,
                     sa=None, *, kind: str = "int8", act: str = "none",
                     plan: Optional[FusedPlan] = None) -> torch.Tensor:
    """General fused dequant matmul: (M, K) f32 acts x ANY stored kind ->
    (M, N) f32. ``sw``: (G, N) scales (G == 1 per-channel, G > 1 equal
    K-groups); ``sa``: scalar static act scale, used per ``act`` —
    'none' (ignored), 'qdq' (fake-quant grid) or 'quant' (int-valued
    acts, ``sa`` folded in at the end). ``plan`` replaces the launch
    plan (default :func:`plan_fused_dequant`); the kernel refuses one
    that does not cover K. Without a plan, a K deeper than one launch
    takes runs as one launch per :func:`k_slices` slice, the f32
    partials added in slice order."""
    if kind not in KINDS:
        raise ValueError(f"unknown storage kind {kind!r}")
    if act not in ACTS:
        raise ValueError(f"unknown act step {act!r}")
    expect(x, "x", torch.float32)
    expect(w, "w", _STORAGE_DTYPE[kind])
    sw = _scales(sw)
    m, k = x.shape
    n = w.shape[1]
    if k != _stored_k(w, kind):
        raise ValueError(f"x {tuple(x.shape)} does not match stored "
                         f"{kind} weight {tuple(w.shape)}")
    groups = sw.shape[0]
    if sw.dim() != 2 or sw.shape[1] != n or groups < 1 or k % groups:
        raise ValueError(f"scales {tuple(sw.shape)} do not split K={k} "
                         f"into equal groups over N={n}")
    if act != "none":
        if sa is None:
            raise ValueError(f"act={act!r} needs the static scale sa")
        if not (isinstance(sa, torch.Tensor) and sa.dim() == 0
                and sa.dtype == torch.float32 and sa.device == x.device):
            sa = _scalar(sa, x)
    operands = (x, w, sw) if act == "none" else (x, w, sw, sa)
    if on_cpu(*operands):
        return ref.fused_dequant_mm_ref(x, w, sw, sa, kind=kind, act=act)
    sw = sw.contiguous()
    if m == 0 or n == 0:              # an empty grid is not a launch
        return torch.empty((m, n), dtype=torch.float32, device=x.device)
    if plan is not None:
        return _launch_fused_dequant(x, w, sw, sa, kind, act, plan)
    slices = k_slices(m, k, groups, kind)
    if len(slices) == 1:
        return _launch_fused_dequant(x, w, sw, sa, kind, act, None)
    # deeper K than one launch takes: a launch per slice, the partials
    # added in slice order
    pk = 2 if kind in PACKED_KINDS else 1
    gs = k // groups
    out = None
    for k0, k1 in slices:
        part = _launch_fused_dequant(
            x[:, k0:k1].contiguous(), w[k0 // pk:k1 // pk],
            sw if groups == 1 else sw[k0 // gs:k1 // gs], sa, kind, act,
            None)
        out = part if out is None else out.add_(part)
    return out


def _launch_fused_dequant(x, w, sw, sa, kind, act, plan):
    """One launch of ``csrc/fused_dequant.cu`` on checked CUDA operands."""
    m, k = x.shape
    n = w.shape[1]
    groups = sw.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if plan is None:
        plan = plan_fused_dequant(m, n, k, groups, kind,
                                  _sm_count(x.device))
    lib = _fused_dequant_library()
    args = (x.data_ptr(), w.data_ptr(), sw.data_ptr(),
            sa.data_ptr() if act != "none" else None, out.data_ptr(),
            m, n, k, groups, KINDS.index(kind), ACTS.index(act), *plan,
            alignment(w), stream_handle(x))
    err = call_on(x.device, lib.fused_dequant_launch, *args)
    _build.check(err, "fused_dequant_mm")
    LAUNCHES["fused_dequant_mm"] += 1
    return out
