"""``mp_matmul``'s launch planner (``kernels.mpmm.plan_mpmm``) and the
decomposition its CUDA kernel computes, on the CPU.

The kernel (``csrc/mpmm.cu``) runs the K-groups of one output in
parallel: the prefix max E_g of the group maxima, then each group's
contribution c_g (which depends on its own data and on E_g alone), then
an ordered fold that truncates only where E rises (a "record"). It runs
only on the card (``tests/test_torch_cuda.py`` holds it against its
plain version there). What is checked here:

* the plan covers [0, M), [0, N) and the K-groups exactly once, with
  cluster sizes the card allows (1 to 8 blocks);
* the decomposition, written as plain torch
  (``ref.mp_matmul_rounds_ref``: prefix max, per-group contributions,
  record segments summed last to first, per-range lists over the plan's
  rounds, the ordered fold), is bit-equal to ``ref.mp_matmul_blocked_ref``
  for n in {8, 16}, w in {12, 16, 28}, trunc and floor, faithful and
  fused, fp32, fp16 and bf16 accumulators; and, on a subset, to the JAX
  reference's Pallas kernel in interpret mode and to its ``core.ipu``
  oracle.

Operands: wide random, ascending exponents (every group a record),
descending, all-zero groups, subnormal rows, and fp16 accumulation that
overflows to inf. Tolerance: bit equality on the output's bit patterns.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import ipu as jipu
from repro.kernels import mpmm as jmpmm
from repro.kernels import ref as jref
from _torch_parity import one_intra_op_thread  # noqa: F401 (autouse)
from repro_torch.core.ipu import IPUConfig
from repro_torch.kernels import mpmm as tmpmm
from repro_torch.kernels import ref as tref

SMS = 132                              # an H100 SXM
# qwen2-0.5b's projections, (K, N)
LAYER = {"wq": (896, 896), "wk": (896, 128), "wv": (896, 128),
         "wo": (896, 896), "w_gate": (896, 4864), "w_up": (896, 4864),
         "w_down": (4864, 896)}
RAGGED = [(5, 200, 72), (33, 128, 130), (17, 100, 30), (1, 7, 1),
          (3, 0, 2), (9, 4096 * 16 + 3, 40)]
SHAPES = ([(m, k, n) for m in (1, 8, 9, 256) for k, n in LAYER.values()]
          + RAGGED)


def _covers(ranges, total):
    """Consecutive half-open ranges from 0 to ``total``."""
    assert ranges[0][0] == 0 and ranges[-1][1] == total
    for (_, e), (b, _) in zip(ranges, ranges[1:]):
        assert e == b


@pytest.mark.parametrize("force", [{}, {"splits": 1}, {"splits": 8},
                                   {"bn": 256}, {"splits": 3, "bn": 64},
                                   {"rows": 1}],
                         ids=str)
@pytest.mark.parametrize("g", [8, 16])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_covers_rows_columns_and_groups_once(shape, g, force):
    m, k, n = shape
    plan = tmpmm.plan_mpmm(m, n, k, g, SMS, **force)
    assert plan.rows in tmpmm.MPMM_ROWS
    assert plan.rows <= min(8, 1 << (m - 1).bit_length())
    assert plan.bn in tmpmm.MPMM_WIDTHS
    assert plan.lanes * plan.bn == tmpmm.THREADS
    assert 1 <= plan.splits <= tmpmm.MAX_SPLITS     # a portable cluster
    for key, v in force.items():
        assert getattr(plan, key) == v
    gx, gy, gz = plan.grid(m, n)
    assert gy == plan.splits and gz <= 65535
    _covers([(i * plan.rows, min(m, (i + 1) * plan.rows))
             for i in range(gz)], m)
    _covers([(i * plan.bn, min(n, (i + 1) * plan.bn)) for i in range(gx)], n)
    groups = -(-k // g)
    ranges = [r for rnd in plan.ranges(k, g) for r in rnd]
    assert len(ranges) == plan.rounds(k, g) * plan.splits
    # in K order, every group once, no range longer than the lanes
    assert sum(e - b for b, e in ranges) == groups
    flat = [gi for b, e in ranges for gi in range(b, e)]
    assert flat == list(range(groups))
    assert all(0 <= e - b <= plan.lanes for b, e in ranges)


def test_plan_at_the_decode_shapes():
    """At M = 8 every projection of qwen2-0.5b fits one wave of two
    blocks an SM; the deep w_down takes a full cluster of 8 K ranges;
    at 256 rows (the prefill wave) the row chunks fill the card, and no
    projection needs more than one K range but the narrow wk/wv."""
    for name, (k, n) in LAYER.items():
        plan = tmpmm.plan_mpmm(8, n, k, 16, SMS)
        assert plan.blocks(8, n) <= tmpmm.BLOCKS_PER_SM * SMS, name
        cost = tmpmm.plan_cost(plan, 8, n, k, 16, SMS)
        for rows in tmpmm.MPMM_ROWS:
            for c in range(1, tmpmm.MAX_SPLITS + 1):
                other = tmpmm.plan_mpmm(8, n, k, 16, SMS, splits=c,
                                        rows=rows)
                assert cost <= tmpmm.plan_cost(other, 8, n, k, 16, SMS)
    down = tmpmm.plan_mpmm(8, 896, 4864, 16, SMS)
    assert (down.rows, down.splits, down.rounds(4864, 16)) == (8, 8, 5)
    for name, (k, n) in LAYER.items():
        plan = tmpmm.plan_mpmm(256, n, k, 16, SMS)
        assert plan.splits == 1 or n <= 128, name
        assert plan.blocks(256, n) >= SMS


def test_plan_refuses_what_it_cannot_plan():
    plan = tmpmm.plan_mpmm
    for args in ((0, 8, 64, 16, SMS), (8, 0, 64, 16, SMS),
                 (8, 8, -1, 16, SMS), (8, 8, 64, 0, SMS), (8, 8, 64, 16, 0)):
        with pytest.raises(ValueError):
            plan(*args)
    for force in ({"splits": 0}, {"splits": tmpmm.MAX_SPLITS + 1},
                  {"bn": 16}, {"bn": 96}, {"rows": 3}, {"rows": 16}):
        with pytest.raises(ValueError):
            plan(8, 8, 64, 16, SMS, **force)


# ------------------------------------------- the decomposition

def _cfg(n, w, accum, rounding):
    return IPUConfig(n=n, w=w, accum=accum, rounding=rounding,
                     sw_precision=12 if accum == "bf16" else None)


CFGS = [_cfg(n, w, accum, rounding)
        for n, w, accum, rounding in itertools.product(
            (8, 16), (12, 16, 28), ("fp32", "fp16", "bf16"),
            ("trunc", "floor"))]
OPERANDS = ("wide", "ascending", "descending", "zero_groups", "subnormal",
            "overflow")
M, K, N = 3, 80, 5                     # 5 or 10 groups, a ragged last one


def _id(c):
    return f"n{c.n}w{c.w}{c.accum}{c.rounding}"


def jcfg(cfg: IPUConfig) -> jipu.IPUConfig:
    return jipu.IPUConfig(**dataclasses.asdict(cfg))


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view({2: torch.int16, 4: torch.int32}[
            x.element_size()]).numpy().astype(np.int64)
    x = np.asarray(x)
    return x.view({2: np.int16, 4: np.int32}[x.dtype.itemsize]).astype(
        np.int64)


def _f16(x):
    x = np.asarray(x, np.float16)
    x[~np.isfinite(x)] = 0
    return x


def operands(kind, g, seed):
    """(a (M, K), b (K - 3, N)) f16 numpy: K - 3 leaves a ragged group."""
    rng = np.random.default_rng(seed)
    k = K - 3
    mant = rng.uniform(1, 2, (M, k)) * rng.choice([-1, 1], (M, k))
    a = _f16(rng.normal(0, 1, (M, k)) * np.exp2(rng.integers(-10, 12, (M, k))))
    b = _f16(rng.normal(0, 1, (k, N)) * np.exp2(rng.integers(-10, 12, (k, N))))
    grp = np.arange(k) // g
    if kind in ("ascending", "descending"):
        # a's exponent constant in a group and 2 higher (lower) each
        # group, b's exponent 0: every group's max rises past the last
        # (ascending), or only the first group is a record (descending)
        step = 2 if kind == "ascending" else -2
        e = -12 + step * grp if step > 0 else 6 + step * grp
        a = _f16(mant * np.exp2(e)[None])
        b = _f16(rng.uniform(1, 2, (k, N)) * rng.choice([-1, 1], (k, N)))
    elif kind == "zero_groups":
        a[:, grp == 0] = 0                         # the first group
        b[grp == 2, :] = -0.0
        a[1, grp == grp[-1]] = 0                   # the ragged last one
    elif kind == "subnormal":
        a[0] = rng.integers(-1023, 1024, k) * 2.0 ** -24
        a[2, ::2] = rng.integers(-1023, 1024, (k + 1) // 2) * 2.0 ** -24
        b[:, 1] = rng.integers(-1023, 1024, k) * 2.0 ** -24
    elif kind == "overflow":
        # same-sign products of ~4e4: an fp16 accumulator overflows to inf
        a = _f16(rng.uniform(180, 250, (M, k)))
        b = _f16(rng.uniform(180, 250, (k, N)))
        b[:, 1] *= -1
    return a, b


PLANS = [dict(splits=2, bn=128), dict(splits=1, bn=256),
         dict(splits=3, bn=64)]


def _rounds(a, b, cfg, fused, force):
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    plan = tmpmm.plan_mpmm(M, N, a.shape[1], cfg.n, SMS, **force)
    return tref.mp_matmul_rounds_ref(at, bt, cfg, fused=fused, plan=plan)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("cfg", CFGS, ids=_id)
def test_rounds_equal_the_blocked_plain_version(cfg, fused):
    for i, kind in enumerate(OPERANDS):
        a, b = operands(kind, cfg.n, [i, cfg.n, cfg.w])
        plain = tref.mp_matmul_blocked_ref(
            torch.from_numpy(a), torch.from_numpy(b), cfg, fused=fused)
        if kind == "overflow" and cfg.accum == "fp16":
            assert torch.all(torch.isinf(plain))
        want = bits(plain)
        for force in PLANS:
            got = bits(_rounds(a, b, cfg, fused, force))
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{kind} {force}")


def test_ascending_operands_make_every_group_a_record():
    """The ascending case is the fold's worst: E rises at every group of
    every output."""
    for g in (8, 16):
        a, b = operands("ascending", g, [1, g])
        ea = np.frexp(a.astype(np.float32))[1] - 1
        eb = np.frexp(b.astype(np.float32))[1] - 1
        c = ea[:, :, None] + eb[None]                   # (M, k, N)
        mx = [c[:, s:s + g].max(axis=1) for s in range(0, a.shape[1], g)]
        assert len(mx) > 4
        assert all(np.all(hi > lo) for lo, hi in zip(mx, mx[1:]))


# a subset against the JAX reference: every n, w, rounding and accum
JAX_CFGS = [_cfg(n, w, accum, rounding)
            for (n, w), accum, rounding in zip(
                itertools.product((8, 16), (12, 16, 28)),
                ("fp32", "fp16", "bf16", "fp16", "fp32", "bf16"),
                ("trunc", "floor", "trunc", "trunc", "floor", "floor"))]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("cfg", JAX_CFGS, ids=_id)
def test_rounds_equal_pallas_interpret(cfg, fused):
    for i, kind in enumerate(("wide", "ascending", "zero_groups",
                              "overflow")):
        a, b = operands(kind, cfg.n, [i, cfg.n, cfg.w, 7])
        want = jmpmm.mp_matmul(jnp.asarray(a), jnp.asarray(b), jcfg(cfg),
                               bm=8, bn=8, fused=fused, interpret=True)
        got = _rounds(a, b, cfg, fused, PLANS[i % len(PLANS)])
        np.testing.assert_array_equal(bits(got), bits(want), err_msg=kind)


@pytest.mark.parametrize("cfg", JAX_CFGS, ids=_id)
def test_rounds_equal_the_core_ipu_oracle(cfg):
    for i, kind in enumerate(("descending", "ascending", "subnormal")):
        a, b = operands(kind, cfg.n, [i, cfg.n, cfg.w, 11])
        want = jref.mp_matmul_ref(jnp.asarray(a), jnp.asarray(b), jcfg(cfg))
        got = _rounds(a, b, cfg, False, PLANS[i % len(PLANS)])
        np.testing.assert_array_equal(bits(got), bits(want), err_msg=kind)


def test_wrapper_takes_the_plain_version_on_cpu_with_any_plan():
    """On CPU tensors ``mp_matmul`` runs ``ref.mp_matmul_blocked_ref`` and
    counts no launch, whatever plan it is handed."""
    a, b = operands("wide", 16, [5])
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    before = tmpmm.LAUNCHES["mp_matmul"]
    want = tref.mp_matmul_blocked_ref(at, bt)
    for plan in (None, tmpmm.MpmmPlan(8, 256, 1),
                 tmpmm.plan_mpmm(M, N, a.shape[1], 16, SMS, splits=8)):
        assert torch.equal(tmpmm.mp_matmul(at, bt, plan=plan), want)
    assert tmpmm.LAUNCHES["mp_matmul"] == before
