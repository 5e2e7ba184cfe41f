"""``qmm``'s launch planner (``kernels.qmm.plan_qmm``) on the CPU.

The tensor-core kernel of ``csrc/qmm.cu`` runs only on the card
(``tests/test_torch_cuda.py`` holds it against its plain version there);
what surrounds it is plain Python, checked here: the plan covers [0, M),
[0, N) and [0, K) exactly once, with K ranges of a multiple of 32 rows
but the ragged last one; it reaches about two blocks per SM at the
decode shapes; and split-K is exact: the int32 sum of ``qmm_ref`` over
the plan's K ranges equals ``qmm_ref`` and the JAX reference (its
``xla`` route, and its Pallas kernel in interpret mode at two small
shapes). Integer results are compared bit for bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.kernels import qmm as tqmm
from repro_torch.kernels import ref as tref

SMS = 132                              # an H100 SXM
# qwen2-0.5b's projections, (K, N)
LAYER = {"wq": (896, 896), "wk": (896, 128), "wv": (896, 128),
         "wo": (896, 896), "w_gate": (896, 4864), "w_up": (896, 4864),
         "w_down": (4864, 896)}
ROWS = (1, 8, 16, 17, 256)
RAGGED = [(5, 200, 72), (33, 128, 130), (17, 100, 30), (1, 32, 7),
          (3, 7, 2), (4, 0, 8)]
SHAPES = [(m, k, n) for m in ROWS for k, n in LAYER.values()] + RAGGED


def _covers(ranges, total):
    """Consecutive, non-empty half-open ranges from 0 to ``total``."""
    assert ranges[0][0] == 0 and ranges[-1][1] == total
    for (_, e), (b, _) in zip(ranges, ranges[1:]):
        assert e == b
    return all(e > b for b, e in ranges) or total == 0


@pytest.mark.parametrize("splits", [None, 1, 3], ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_partitions_m_n_and_k_once(shape, splits):
    m, k, n = shape
    plan = tqmm.plan_qmm(m, n, k, SMS, splits)
    assert plan.mt in (1, 2, 4) and plan.bn in tqmm.BLOCK_WIDTHS
    assert plan.mt == (1 if m <= 8 else 2 if m <= 16 else 4)
    gx, gy, gz = plan.grid(m, n)
    assert gz == plan.splits
    n_ranges = [(i * plan.bn, min(n, (i + 1) * plan.bn)) for i in range(gx)]
    m_ranges = [(i * 8 * plan.mt, min(m, (i + 1) * 8 * plan.mt))
                for i in range(gy)]
    assert _covers(n_ranges, n) and _covers(m_ranges, m)
    k_ranges = plan.k_ranges(k)
    assert _covers(k_ranges, k)
    assert plan.kc % 32 == 0
    for b, e in k_ranges[:-1]:
        assert e - b == plan.kc
    if splits == 1:
        assert plan.splits == 1
    elif splits is not None:
        assert 1 <= plan.splits <= splits


@pytest.mark.parametrize("per_sm", [tqmm.BLOCKS_PER_SM, 2], ids=str)
@pytest.mark.parametrize("name", sorted(LAYER))
def test_plan_reaches_the_intended_blocks_at_decode(name, per_sm):
    """At M = 8 the grid reaches ``per_sm`` blocks per SM (the default
    ``BLOCKS_PER_SM``, and two), or, where the shape has fewer tiles of
    32 columns x 64 k-rows than that (``wk``, ``wv``: N = 128), every
    such tile is a block; and it overshoots by less than half the SMs."""
    k, n = LAYER[name]
    plan = tqmm.plan_qmm(8, n, k, SMS, blocks_per_sm=per_sm)
    tiles = -(-n // 32) * -(-k // tqmm.STAGE_K)
    want = min(per_sm * SMS, tiles)
    assert want <= plan.blocks(8, n) < want + SMS // 2
    if n >= 896:
        assert plan.blocks(8, n) >= per_sm * SMS


def test_plan_refuses_what_has_no_plan():
    with pytest.raises(ValueError):
        tqmm.plan_qmm(0, 8, 8, SMS)
    with pytest.raises(ValueError):
        tqmm.plan_qmm(8, 8, 8, SMS, splits=0)
    with pytest.raises(ValueError):
        tqmm.plan_qmm(8, 8, 8, SMS, blocks_per_sm=0)


@pytest.mark.parametrize("splits", [None, 1, 4], ids=str)
@pytest.mark.parametrize("shape", [(8, 896, 128), (17, 4864, 96),
                                   (256, 896, 128)] + RAGGED[:3], ids=str)
def test_split_k_sum_equals_qmm_ref_and_jax(shape, splits):
    """The kernel's split-K adds int32 partial sums in any order; their
    int32 sum over the plan's K ranges equals the whole product, the
    JAX reference's ``xla`` route included. All -128 rows and columns
    give the largest products."""
    m, k, n = shape
    rng = np.random.default_rng(m * 1009 + k * 7 + n)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    a[0] = -128
    b[:, -1] = -128
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    plan = tqmm.plan_qmm(m, n, k, SMS, splits)
    total = torch.zeros((m, n), dtype=torch.int32)
    for lo, hi in reversed(plan.k_ranges(k)):
        total += tref.qmm_ref(at[:, lo:hi].contiguous(),
                              bt[lo:hi].contiguous())
    whole = tref.qmm_ref(at, bt)
    assert torch.equal(total, whole)
    j = jops.int8_matmul(jnp.asarray(a), jnp.asarray(b), backend="xla")
    np.testing.assert_array_equal(whole.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tqmm.qmm(at, bt, plan=plan).numpy(),
                                  np.asarray(j))


@pytest.mark.parametrize("shape", [(8, 96, 40), (17, 100, 30)], ids=str)
def test_split_k_sum_equals_pallas_interpret(shape):
    m, k, n = shape
    rng = np.random.default_rng(k + n)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    plan = tqmm.plan_qmm(m, n, k, SMS, splits=3)
    assert plan.splits > 1
    total = sum(tref.qmm_ref(at[:, lo:hi].contiguous(),
                             bt[lo:hi].contiguous())
                for lo, hi in plan.k_ranges(k))
    j = jops.int8_matmul(jnp.asarray(a), jnp.asarray(b), backend="pallas")
    np.testing.assert_array_equal(total.numpy(), np.asarray(j))


@pytest.mark.parametrize("offset,width,want", [
    (0, 896, 16), (0, 72, 4), (0, 130, 1), (1, 896, 1), (4, 896, 4),
    (8, 64, 4), (16, 48, 16), (0, 30, 1)], ids=str)
def test_alignment_flag(offset, width, want):
    """The copy width the wrapper passes: 16 or 4 bytes where both the
    data pointer and the row stride allow it, else bytes."""
    buf = torch.zeros(2 * width + offset + 16, dtype=torch.int8)
    base = (-buf.data_ptr()) % 16          # first 16-byte boundary
    t = buf[base + offset: base + offset + 2 * width].view(2, width)
    assert t.data_ptr() % 16 == offset % 16
    assert tqmm.alignment(t) == want
