"""Wrappers of the exact int kernels (``csrc/qmm.cu``).

``qmm`` replaces ``repro/kernels/qmm.py::_qmm_kernel`` and
``qmm_packed`` replaces ``::_qmm_packed_kernel``. On a CPU tensor each
wrapper runs its plain version (``kernels.ref``); on a CUDA tensor it
launches the kernel on the current stream or raises. ``LAUNCHES`` counts
kernel launches, and nothing else.

All three run on the int8 tensor cores. ``qmm``'s kernel takes a launch
plan chosen here by :func:`plan_qmm`; ``qmm_packed`` and ``fused_qmm``
(``kernels.fused``) share a second kernel whose plan :func:`plan_int_tc`
chooses. Both planners are pure functions the CPU tests reach.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ref

LAUNCHES = {"qmm": 0, "qmm_packed": 0}


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; raises on a mix of
    devices or a device the kernels do not take."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) > 1:
            raise ValueError("operands lie on different CUDA devices")
        return False
    raise ValueError(f"operands must all lie on the CPU or all on one CUDA "
                     f"device, got {sorted(kinds)}")


def expect(t: torch.Tensor, name: str, dtype, ndim: int = 2):
    if t.dtype != dtype:
        raise TypeError(f"{name}: want {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: want {ndim}-d, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes contiguous tensors")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# the kernel's k-rows per pipeline stage (csrc/qmm.cu, tc::BK)
STAGE_K = 64
BLOCK_WIDTHS = (128, 64, 32)      # columns per block, one warp per 32
# the grid the planner aims for; one block per SM took less time in
# total than two or four over qwen2-0.5b's projections at 8 and 256
# rows on an H100 (chip_smoke.py phase 2, "qmm_plans_us")
BLOCKS_PER_SM = 1


class QmmPlan(NamedTuple):
    """Launch plan of ``qmm``'s kernel: ``mt`` m8-tiles per warp (a block
    covers 8 * mt rows), ``bn`` columns per block, and ``splits`` ranges
    of ``kc`` k-rows each (the last one ragged) that add into a zeroed
    output when there is more than one."""
    mt: int
    bn: int
    splits: int
    kc: int

    def grid(self, m: int, n: int):
        rows = 8 * self.mt
        return (-(-n // self.bn), -(-m // rows), self.splits)

    def blocks(self, m: int, n: int) -> int:
        x, y, z = self.grid(m, n)
        return x * y * z

    def k_ranges(self, k: int):
        return [(s * self.kc, min(k, (s + 1) * self.kc))
                for s in range(self.splits)]


def plan_qmm(m: int, n: int, k: int, sms: int,
             splits: Optional[int] = None,
             blocks_per_sm: int = BLOCKS_PER_SM) -> QmmPlan:
    """The plan for an (m, k) x (k, n) product on a card of ``sms`` SMs.

    ``mt`` is the fewest m8-tiles that hold m rows, up to 4 (a grid axis
    over m takes the rest). The block is the widest of 128, 64 and 32
    columns that still gives ``blocks_per_sm`` blocks per SM once K is
    split into stages of 64 rows; then K is split into ranges of a
    multiple of 32 rows until the grid reaches that count. ``splits``
    forces the number of ranges (at most ``ceil(k / 32)`` come out)."""
    if min(m, n) < 1 or k < 0 or sms < 1 or blocks_per_sm < 1:
        raise ValueError(f"no plan for m={m} n={n} k={k} sms={sms} "
                         f"blocks_per_sm={blocks_per_sm}")
    mt = 1 if m <= 8 else 2 if m <= 16 else 4
    m_blocks = -(-m // (8 * mt))
    target = blocks_per_sm * sms
    stages = max(1, -(-k // STAGE_K))
    for bn in BLOCK_WIDTHS:
        tiles = -(-n // bn) * m_blocks
        if tiles * stages >= target:
            break
    if splits is None:
        splits = min(-(-target // tiles), stages)
    if splits < 1:
        raise ValueError(f"splits must be at least 1, got {splits}")
    kc = 32 * max(1, -(-k // (32 * splits)))
    return QmmPlan(mt, bn, max(1, -(-k // kc)), kc)


def alignment(t: torch.Tensor) -> int:
    """The widest copy (16, 4 or 1 bytes) that every row of a contiguous
    2-d tensor allows: its pointer and its row stride in bytes both
    aligned."""
    row = t.shape[1] * t.element_size()
    for v in (16, 4):
        if t.data_ptr() % v == 0 and row % v == 0:
            return v
    return 1


# csrc/qmm.cu's int_tc_kernel (qmm_packed, fused_qmm): columns per block,
# and the K ranges of one output tile, one thread block cluster
TC_WIDTH = 128
TC_MAX_SPLITS = 8
# the grid plan_int_tc aims for: at most this many blocks per SM. Two
# took the least time of the plans tried, or within 0.8 us of it, at
# each of qwen2-0.5b's projection shapes at 8 and 256 rows for both
# kernels on an H100 (chip_smoke.py phase 2, "fused_qmm_plans_us" and
# "qmm_packed_plans_us")
INT_TC_BLOCKS_PER_SM = 2


class IntTcPlan(NamedTuple):
    """Launch plan of the kernel of ``qmm_packed`` and ``fused_qmm``:
    ``mt`` m8-tiles per warp (a block covers 8 * mt rows and
    ``TC_WIDTH`` columns), and ``splits`` ranges of ``kc`` k-rows each
    (the last one ragged); the splits of one tile form a thread block
    cluster that adds their int32 partial sums before the epilogue."""
    mt: int
    splits: int
    kc: int

    def grid(self, m: int, n: int):
        return (-(-n // TC_WIDTH), -(-m // (8 * self.mt)), self.splits)

    def blocks(self, m: int, n: int) -> int:
        x, y, z = self.grid(m, n)
        return x * y * z

    def k_ranges(self, k: int):
        return [(s * self.kc, min(k, (s + 1) * self.kc))
                for s in range(self.splits)]


@functools.lru_cache(maxsize=4096)
def plan_int_tc(m: int, n: int, k: int, packed: bool, sms: int,
                splits: Optional[int] = None,
                blocks_per_sm: int = INT_TC_BLOCKS_PER_SM) -> IntTcPlan:
    """The plan for an (m, k) x (k, n) product (``packed``: the weight
    holds (k/2, n) packed bytes, k even) on a card of ``sms`` SMs.

    ``mt`` is the fewest m8-tiles that hold m rows, up to 4 (a grid axis
    over m takes the rest). K is split into as many ranges of a multiple
    of 32 rows (at most ``TC_MAX_SPLITS``) as keep the grid of
    ``TC_WIDTH``-column blocks within ``blocks_per_sm`` blocks per SM,
    at least one: a block quantizes the activations of its K range for
    all its columns, so short ranges keep each block's chain of stages
    short. ``splits`` forces the number of ranges (at most
    ``ceil(k / 32)`` come out)."""
    if (min(m, n, sms, blocks_per_sm) < 1 or k < 0 or (packed and k % 2)
            or (splits is not None and not 1 <= splits <= TC_MAX_SPLITS)):
        raise ValueError(f"no plan for m={m} n={n} k={k} packed={packed} "
                         f"sms={sms} splits={splits} "
                         f"blocks_per_sm={blocks_per_sm}")
    mt = 1 if m <= 8 else 2 if m <= 16 else 4
    if splits is None:
        tiles = -(-n // TC_WIDTH) * -(-m // (8 * mt))
        splits = max(1, min(TC_MAX_SPLITS, blocks_per_sm * sms // tiles))
    kc = 32 * max(1, -(-k // (32 * splits)))
    return IntTcPlan(mt, max(1, -(-k // kc)), kc)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library():
    """``csrc/qmm.cu``'s library, looked up once (built at the first
    launch, never at import)."""
    from repro_torch.kernels import _build
    return _build.library("qmm")


def call_on(device: torch.device, fn, *args) -> int:
    """``fn(*args)``, a kernel's C entry, with ``device`` current (no
    context is entered when it already is)."""
    if device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


def _launch_qmm(a, b, plan: Optional[QmmPlan] = None):
    from repro_torch.kernels import _build
    m, k = a.shape
    n = b.shape[1]
    if m == 0 or n == 0:              # an empty grid is not a launch
        return torch.empty((m, n), dtype=torch.int32, device=a.device)
    plan = plan or plan_qmm(m, n, k, _sm_count(a.device))
    # split ranges add into the output with atomics: it starts at zero
    alloc = torch.zeros if plan.splits > 1 else torch.empty
    out = alloc((m, n), dtype=torch.int32, device=a.device)
    err = call_on(a.device, _library().qmm_launch, a.data_ptr(), b.data_ptr(),
                out.data_ptr(), m, n, k, *plan, alignment(a), alignment(b),
                stream_handle(a))
    _build.check(err, "qmm")
    LAUNCHES["qmm"] += 1
    return out


def launch_int_tc(x, w, sw, sa, packed: bool, plan: Optional[IntTcPlan],
                  counts: dict, name: str) -> torch.Tensor:
    """One launch of ``int_tc_kernel`` on checked CUDA operands: x (M, K)
    f32 with ``sw`` and ``sa`` (``fused_qmm``, an f32 output) or int8
    with both None (``qmm_packed``, an int32 output); w int8 rows or
    packed bytes. Adds one to ``counts[name]`` when it launches."""
    from repro_torch.kernels import _build
    fused = sw is not None
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), device=x.device,
                      dtype=torch.float32 if fused else torch.int32)
    if m == 0 or n == 0:              # an empty grid is not a launch
        return out
    if plan is None:
        plan = plan_int_tc(m, n, k, packed, _sm_count(x.device))
    err = call_on(x.device, _library().int_tc_launch, x.data_ptr(),
                w.data_ptr(), sw.data_ptr() if fused else None,
                sa.data_ptr() if fused else None, out.data_ptr(), m, n, k,
                int(fused), int(packed), *plan, alignment(x), alignment(w),
                stream_handle(x))
    _build.check(err, name)
    counts[name] += 1
    return out


def qmm(a: torch.Tensor, b: torch.Tensor, *,
        plan: Optional[QmmPlan] = None) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact. ``plan``
    replaces the kernel's launch plan (default :func:`plan_qmm`); the
    kernel refuses one that does not cover K."""
    expect(a, "a", torch.int8)
    expect(b, "b", torch.int8)
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if on_cpu(a, b):
        return ref.qmm_ref(a, b)
    return _launch_qmm(a, b, plan=plan)


def qmm_packed(a: torch.Tensor, b_packed: torch.Tensor, *,
               plan: Optional[IntTcPlan] = None) -> torch.Tensor:
    """(M, K) int8 activations x (K//2, N) packed int4 bytes -> int32.
    ``plan`` replaces the kernel's launch plan (default
    :func:`plan_int_tc`); the kernel refuses one that does not cover K."""
    expect(a, "a", torch.int8)
    expect(b_packed, "b_packed", torch.int8)
    if a.shape[1] != 2 * b_packed.shape[0]:
        raise ValueError(f"packed contraction mismatch {tuple(a.shape)} x "
                         f"{tuple(b_packed.shape)} (want K == 2 * K/2)")
    if on_cpu(a, b_packed):
        return ref.qmm_ref(a, ref.unpack_int4_ref(b_packed))
    return launch_int_tc(a, b_packed, None, None, True, plan, LAUNCHES,
                         "qmm_packed")
