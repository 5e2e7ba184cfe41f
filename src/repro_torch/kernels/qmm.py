"""Wrappers of the exact int kernels (``csrc/qmm.cu``).

``qmm`` replaces ``repro/kernels/qmm.py::_qmm_kernel`` and
``qmm_packed`` replaces ``::_qmm_packed_kernel``. On a CPU tensor each
wrapper runs its plain version (``kernels.ref``); on a CUDA tensor it
launches the kernel on the current stream or raises. ``LAUNCHES`` counts
kernel launches, and nothing else.

``qmm``'s kernel runs on the int8 tensor cores with a launch plan chosen
here by :func:`plan_qmm`, a pure function the CPU tests reach.
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
    2-d int8 tensor allows: its pointer and its row stride both
    aligned."""
    for v in (16, 4):
        if t.data_ptr() % v == 0 and t.shape[1] % v == 0:
            return v
    return 1


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_qmm(a, b, packed: bool, plan: Optional[QmmPlan] = None):
    from repro_torch.kernels import _build
    m, k = a.shape
    n = b.shape[1]
    if m == 0 or n == 0:              # an empty grid is not a launch
        return torch.empty((m, n), dtype=torch.int32, device=a.device)
    if packed:
        plan, vecs = QmmPlan(0, 0, 0, 0), (0, 0)
    else:
        plan = plan or plan_qmm(m, n, k, _sm_count(a.device))
        vecs = (alignment(a), alignment(b))
    # split ranges add into the output with atomics: it starts at zero
    alloc = torch.zeros if plan.splits > 1 else torch.empty
    out = alloc((m, n), dtype=torch.int32, device=a.device)
    lib = _build.library("qmm")
    with torch.cuda.device(a.device):
        err = lib.qmm_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                             m, n, k, int(packed), *plan, *vecs,
                             stream_handle(a))
    _build.check(err, "qmm_packed" if packed else "qmm")
    LAUNCHES["qmm_packed" if packed else "qmm"] += 1
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
    return _launch_qmm(a, b, packed=False, plan=plan)


def qmm_packed(a: torch.Tensor, b_packed: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 activations x (K//2, N) packed int4 bytes -> int32."""
    expect(a, "a", torch.int8)
    expect(b_packed, "b_packed", torch.int8)
    if a.shape[1] != 2 * b_packed.shape[0]:
        raise ValueError(f"packed contraction mismatch {tuple(a.shape)} x "
                         f"{tuple(b_packed.shape)} (want K == 2 * K/2)")
    if on_cpu(a, b_packed):
        return ref.qmm_ref(a, ref.unpack_int4_ref(b_packed))
    return _launch_qmm(a, b_packed, packed=True)
