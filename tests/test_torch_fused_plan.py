"""``fused_dequant_mm``'s launch planner (``kernels.fused.plan_fused_dequant``)
on the CPU.

The decode kernel of ``csrc/fused_dequant.cu`` runs only on the card
(``tests/test_torch_cuda.py`` holds it against its plain version there);
what surrounds it is plain Python, checked here: the plan covers [0, M),
[0, N) and [0, K) exactly once, with K ranges of a multiple of
``K_STEP`` rows but the ragged last one and no empty range; its grid has
the most blocks that fit ``FD_BLOCKS_PER_SM`` per SM (one wave) at
qwen2-0.5b's decode shapes; it refuses what it cannot plan; and
the kernel's summation (a f32 partial per K range, the partials added in
split order, ``quant``'s x sa after) stays within 2 gamma_K (|x'| @ |w'|)
elementwise of ``ref.fused_dequant_mm_ref``, of the JAX reference's
``fused_dequant_matmul`` (its ``xla`` route) and of its Pallas kernel in
interpret mode, on the numpy inputs of ``tests/test_torch_kernels.py``
(gamma_K = K u / (1 - K u), u = 2^-24: the most two f32 summation orders
of the same products can differ by).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.quant import quantize as jq
from repro_torch.kernels import fused as tfused
from repro_torch.kernels import ref as tref

SMS = 132                              # an H100 SXM
# qwen2-0.5b's projections, (K, N)
LAYER = {"wq": (896, 896), "wk": (896, 128), "wv": (896, 128),
         "wo": (896, 896), "w_gate": (896, 4864), "w_up": (896, 4864),
         "w_down": (4864, 896)}
ROWS = (1, 8, 16, 17, 256)
RAGGED = [(5, 200, 72), (33, 128, 130), (17, 100, 30), (1, 32, 7),
          (3, 6, 2), (4, 0, 8)]
SHAPES = [(m, k, n) for m in ROWS for k, n in LAYER.values()] + RAGGED
ALL_KINDS = list(tfused.KINDS)
U = 2.0 ** -24


def _covers(ranges, total):
    """Consecutive, non-empty half-open ranges from 0 to ``total``."""
    assert ranges[0][0] == 0 and ranges[-1][1] == total
    for (_, e), (b, _) in zip(ranges, ranges[1:]):
        assert e == b
    return all(e > b for b, e in ranges) or total == 0


def _rows(m):
    return min(tfused.ROW_LIMIT, 1 << (m - 1).bit_length())


def _fits(m, k, kind, splits):
    """Whether ``splits`` K ranges give every range an activation slice
    that fits, at some block width."""
    return any(k <= splits * tfused.max_kc(_rows(m), bn, kind)
               for bn in tfused.DECODE_WIDTHS)


@pytest.mark.parametrize("kind", ["int8", "int4_packed"])
@pytest.mark.parametrize("splits", [None, 1, 3, 8], ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_covers_rows_columns_and_k_once(shape, splits, kind):
    m, k, n = shape
    if splits is not None and not _fits(m, k, kind, splits):
        # a range's activation slice would not fit: refused
        with pytest.raises(ValueError):
            tfused.plan_fused_dequant(m, n, k, 1, kind, SMS, splits)
        return
    plan = tfused.plan_fused_dequant(m, n, k, 1, kind, SMS, splits)
    assert plan.rows == _rows(m) and plan.bn in tfused.DECODE_WIDTHS
    gx, gy, gz = plan.grid(m, n)
    assert gy == plan.splits <= tfused.MAX_SPLITS
    m_ranges = [(i * plan.rows, min(m, (i + 1) * plan.rows))
                for i in range(gz)]
    n_ranges = [(i * plan.bn, min(n, (i + 1) * plan.bn)) for i in range(gx)]
    assert _covers(m_ranges, m) and _covers(n_ranges, n)
    k_ranges = plan.k_ranges(k)
    assert _covers(k_ranges, k)                 # no K range is empty
    assert plan.kc % tfused.K_STEP == 0
    assert plan.kc <= tfused.max_kc(plan.rows, plan.bn, kind)
    for b, e in k_ranges[:-1]:
        assert e - b == plan.kc
    if splits is not None:
        assert 1 <= plan.splits <= splits


def _candidates(m, n, k, kind):
    """Every plan the kernel takes for the shape, by brute force."""
    rows = _rows(m)
    for bn in tfused.DECODE_WIDTHS:
        for kc in range(tfused.K_STEP, max(k, 1) + tfused.K_STEP,
                        tfused.K_STEP):
            splits = max(1, -(-k // kc))
            if (splits <= tfused.MAX_SPLITS
                    and kc <= tfused.max_kc(rows, bn, kind)):
                yield tfused.FusedPlan(rows, bn, splits, kc)


@pytest.mark.parametrize("per_sm", [tfused.FD_BLOCKS_PER_SM, 2, 4], ids=str)
@pytest.mark.parametrize("m", [1, 8, 16, 256])
@pytest.mark.parametrize("name", sorted(LAYER))
def test_plan_fills_one_wave_at_most(name, m, per_sm):
    """The grid has the most blocks of any plan the kernel takes that
    stays within ``per_sm`` blocks per SM (one wave); where none does
    (256 rows: 16 row chunks), the fewest."""
    k, n = LAYER[name]
    for kind in ALL_KINDS:
        plan = tfused.plan_fused_dequant(m, n, k, 1, kind, SMS,
                                         blocks_per_sm=per_sm)
        counts = {p.blocks(m, n) for p in _candidates(m, n, k, kind)}
        fit = [c for c in counts if c <= per_sm * SMS]
        want = max(fit) if fit else min(counts)
        assert plan.blocks(m, n) == want, (kind, plan)


def test_plan_at_the_decode_shapes():
    """qwen2-0.5b's projections at 8 rows on an H100 (at most two blocks
    per SM): the grids chip_smoke.py times."""
    plans = {name: tfused.plan_fused_dequant(8, n, k, 1, "int4_packed", SMS)
             for name, (k, n) in LAYER.items()}
    assert {name: tuple(p) for name, p in plans.items()} == {
        "wq": (8, 32, 7, 128), "wk": (8, 32, 7, 128), "wv": (8, 32, 7, 128),
        "wo": (8, 32, 7, 128), "w_gate": (8, 128, 6, 160),
        "w_up": (8, 128, 6, 160), "w_down": (8, 32, 8, 608)}
    assert {name: p.blocks(8, LAYER[name][1])
            for name, p in plans.items()} == {
        "wq": 196, "wk": 28, "wv": 28, "wo": 196, "w_gate": 228,
        "w_up": 228, "w_down": 224}


def test_plan_refuses_what_it_cannot_plan():
    plan = tfused.plan_fused_dequant
    for args in ((0, 8, 64, 1, "int8", SMS), (8, 0, 64, 1, "int8", SMS),
                 (8, 8, 64, 3, "int8", SMS), (8, 8, 64, 0, "int8", SMS),
                 (8, 8, 64, 1, "int5", SMS), (8, 8, 64, 1, "int8", 0),
                 (8, 8, -2, 1, "int8", SMS)):
        with pytest.raises(ValueError):
            plan(*args)
    for splits in (0, tfused.MAX_SPLITS + 1):
        with pytest.raises(ValueError):
            plan(8, 8, 64, 1, "int8", SMS, splits=splits)
    with pytest.raises(ValueError):
        plan(8, 8, 64, 1, "int8", SMS, blocks_per_sm=0)
    # 16 rows of 4864 k-rows do not fit one block's activation slice
    with pytest.raises(ValueError):
        plan(16, 896, 4864, 1, "int8", SMS, splits=1)
    # nor do 8 ranges of a K this deep
    with pytest.raises(ValueError):
        plan(16, 896, 8 * 2304 + 32, 1, "int8", SMS)
    assert plan(16, 896, 8 * 2304, 1, "int8", SMS).splits == 8


@pytest.mark.parametrize("m", [1, 2, 3, 8, 9, 16, 17, 256])
def test_plan_row_limit(m):
    """Up to ROW_LIMIT rows the kernel holds the fewest register rows
    that take m, in one chunk; above, chunks of ROW_LIMIT rows cover
    every row once."""
    plan = tfused.plan_fused_dequant(m, 896, 896, 1, "int4_packed", SMS)
    gz = plan.grid(m, 896)[2]
    if m <= tfused.ROW_LIMIT:
        assert plan.rows == next(r for r in tfused.DECODE_ROWS if r >= m)
        assert gz == 1
    else:
        assert plan.rows == tfused.ROW_LIMIT
        assert (gz - 1) * plan.rows < m <= gz * plan.rows


# ------------------------------------------- the plan's summation order

def _stored(rng, k, n, kind, groups=1):
    """(stored operand, (G, N) scales) as numpy, made by the reference."""
    w = jnp.asarray(rng.normal(0, 1, (k, n)), jnp.float32)
    wg = w.reshape(groups, k // groups, n) if groups > 1 else w
    if kind in ("fp8", "fp4", "fp4_packed"):
        fmt = jq.FP8_E4M3 if kind == "fp8" else jq.FP4_E2M1
        q, s = jq.fp_quantize(wg, fmt, axis=-2)
    else:
        q, s = jq.quantize_symmetric(wg, 8 if kind == "int8" else 4,
                                     axis=-2)
    q = q.reshape(k, n)
    s = s.reshape(groups, n)
    if kind == "int4_packed":
        q = jops.pack_int4(q)
    elif kind == "fp4_packed":
        q = jops.pack_u4(q)
    return np.array(q), np.array(s)


def _operands(x, w, sw, sa, kind, act):
    """The act-stepped x' and the decoded, scaled w' the kernel
    multiplies, as torch f32."""
    xt = torch.from_numpy(x)
    if act != "none":
        xt = tref.quantize_act_ref(xt, torch.tensor(sa))
        if act == "qdq":
            xt = xt * sa
    wf = tref.decode_weight_ref(torch.from_numpy(w), kind)
    k, n = wf.shape
    g = sw.shape[0]
    wf = (wf.reshape(g, k // g, n)
          * torch.from_numpy(sw)[:, None, :]).reshape(k, n)
    return xt, wf


def _plan_sum(x, w, sw, sa, kind, act, plan):
    """The kernel's summation: a f32 partial per K range of the plan,
    added in split order, then quant's x sa."""
    xt, wf = _operands(x, w, sw, sa, kind, act)
    total = None
    for lo, hi in plan.k_ranges(xt.shape[1]):
        part = xt[:, lo:hi] @ wf[lo:hi]
        total = part if total is None else total + part
    return total * sa if act == "quant" else total


def _bound(x, w, sw, sa, kind, act):
    xt, wf = _operands(x, w, sw, sa, kind, act)
    absdot = (xt.abs().double() @ wf.abs().double()).numpy()
    if act == "quant":
        absdot = absdot * sa
    k = wf.shape[0]
    return 2 * (k * U / (1 - k * U)) * absdot


@pytest.mark.parametrize("groups", [1, 7])
@pytest.mark.parametrize("act", list(tfused.ACTS))
@pytest.mark.parametrize("kind", ALL_KINDS)
def test_plan_sum_within_bound_of_ref_and_jax(kind, act, groups):
    for m, k, n in ((8, 224, 40), (5, 448, 72), (16, 896, 24)):
        rng = np.random.default_rng([ALL_KINDS.index(kind), len(act),
                                     groups, m])
        w, sw = _stored(rng, k, n, kind, groups=groups)
        x = rng.normal(0, 2, (m, k)).astype(np.float32)
        sa = np.float32(0.17)
        bound = _bound(x, w, sw, sa, kind, act)
        want = tref.fused_dequant_mm_ref(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(sw),
            torch.tensor(sa), kind=kind, act=act).numpy()
        j = np.asarray(jops.fused_dequant_matmul(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(sw), jnp.asarray(sa),
            kind=kind, act=act, backend="xla"))
        for splits in (None, 3):
            plan = tfused.plan_fused_dequant(m, n, k, groups, kind, SMS,
                                             splits)
            assert plan.splits > 1
            got = _plan_sum(x, w, sw, sa, kind, act, plan).numpy()
            for ref_out in (want, j):
                assert np.all(np.abs(got - ref_out) <= bound), (
                    kind, act, groups, (m, k, n), plan,
                    float(np.max(np.abs(got - ref_out))))


@pytest.mark.parametrize("case", [("int4_packed", "qdq", 1),
                                  ("fp4_packed", "none", 7),
                                  ("int8", "quant", 7)], ids=str)
def test_plan_sum_within_bound_of_pallas_interpret(case):
    kind, act, groups = case
    m, k, n = 8, 224, 24
    rng = np.random.default_rng(len(kind) + groups)
    w, sw = _stored(rng, k, n, kind, groups=groups)
    x = rng.normal(0, 2, (m, k)).astype(np.float32)
    sa = np.float32(0.13)
    plan = tfused.plan_fused_dequant(m, n, k, groups, kind, SMS, splits=4)
    assert plan.splits == 4
    got = _plan_sum(x, w, sw, sa, kind, act, plan).numpy()
    j = np.asarray(jops.fused_dequant_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(sw), jnp.asarray(sa),
        kind=kind, act=act, backend="pallas"))
    assert np.all(np.abs(got - j) <= _bound(x, w, sw, sa, kind, act))


def test_wrapper_takes_the_plain_version_on_cpu_with_any_plan():
    """On CPU tensors the wrapper runs ``ref.fused_dequant_mm_ref`` and
    counts no launch, whatever plan it is handed."""
    rng = np.random.default_rng(3)
    w, sw = _stored(rng, 64, 24, "int4_packed")
    x = torch.from_numpy(rng.normal(0, 2, (8, 64)).astype(np.float32))
    sa = torch.tensor(0.2)
    before = tfused.LAUNCHES["fused_dequant_mm"]
    want = tref.fused_dequant_mm_ref(x, torch.from_numpy(w),
                                     torch.from_numpy(sw), sa,
                                     kind="int4_packed", act="qdq")
    for plan in (None, tfused.FusedPlan(16, 32, 1, 64),
                 tfused.plan_fused_dequant(8, 24, 64, 1, "int4_packed", SMS,
                                           splits=2)):
        got = tfused.fused_dequant_mm(x, torch.from_numpy(w),
                                      torch.from_numpy(sw), sa,
                                      kind="int4_packed", act="qdq",
                                      plan=plan)
        assert torch.equal(got, want)
    assert tfused.LAUNCHES["fused_dequant_mm"] == before


# ------------------------------------------- K deeper than one launch

# (m, k): one launch's edge and one scale group past it, at 16 and at 8
# register rows
DEEP = [(16, 18432), (16, 18464), (8, 36864), (8, 36896)]


@pytest.mark.parametrize("kind", ["int8", "int4_packed", "fp4_packed"])
@pytest.mark.parametrize("groups", [1, 4, 577])
@pytest.mark.parametrize("mk", DEEP, ids=str)
def test_k_slices_cover_k_on_group_bounds(mk, groups, kind):
    m, k = mk
    if k % groups:
        return
    slices = tfused.k_slices(m, k, groups, kind)
    assert _covers(slices, k)
    cap = tfused.max_launch_k(_rows(m), kind)
    assert (len(slices) == 1) == (k <= cap)
    assert len(slices) == max(1, -(-k // cap)) or groups > 1
    gs = k // groups if groups > 1 else 1
    for lo, hi in slices:
        assert hi - lo <= cap and lo % gs == 0 and hi % gs == 0
        if kind in tfused.PACKED_KINDS:
            assert lo % 2 == 0 and hi % 2 == 0
        # every slice has a launch plan of its own
        tfused.plan_fused_dequant(m, 24, hi - lo,
                                  (hi - lo) // gs if groups > 1 else 1,
                                  kind, SMS)
    with pytest.raises(ValueError):
        tfused.plan_fused_dequant(m, 24, k, groups, kind, SMS) \
            if len(slices) > 1 else tfused.k_slices(m, k, 0, kind)


def test_k_slices_refuse_a_group_deeper_than_a_launch():
    with pytest.raises(ValueError):
        tfused.k_slices(16, 2 * 18464, 2, "int8")
    with pytest.raises(ValueError):
        tfused.k_slices(16, 64, 1, "int5")


def _slice_sum(x, w, sw, sa, kind, act, slices):
    """The wrapper's summation past one launch: per slice, the kernel's
    summation under that slice's own plan (quant's x sa included), the
    slice partials added in slice order."""
    xt, wf = _operands(x, w, sw, sa, kind, act)
    m, k = xt.shape
    groups = sw.shape[0]
    total = None
    for lo, hi in slices:
        plan = tfused.plan_fused_dequant(
            m, wf.shape[1], hi - lo,
            (hi - lo) // (k // groups) if groups > 1 else 1, kind, SMS)
        part = None
        for a, b in plan.k_ranges(hi - lo):
            p = xt[:, lo + a:lo + b] @ wf[lo + a:lo + b]
            part = p if part is None else part + p
        part = part * sa if act == "quant" else part
        total = part if total is None else total + part
    return total


@pytest.mark.parametrize("case", [("int8", "none", 1, (16, 18464)),
                                  ("int4_packed", "qdq", 1, (16, 18464)),
                                  ("fp4_packed", "none", 4, (8, 36896)),
                                  ("int8", "quant", 4, (16, 18464))],
                         ids=str)
def test_k_slices_sum_within_bound_of_ref_and_jax(case):
    kind, act, groups, (m, k) = case
    n = 16
    rng = np.random.default_rng([k, groups, len(act)])
    w, sw = _stored(rng, k, n, kind, groups=groups)
    x = rng.normal(0, 2, (m, k)).astype(np.float32)
    sa = np.float32(0.17)
    slices = tfused.k_slices(m, k, groups, kind)
    assert len(slices) == 2
    got = _slice_sum(x, w, sw, sa, kind, act, slices).numpy()
    bound = _bound(x, w, sw, sa, kind, act)
    want = tref.fused_dequant_mm_ref(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(sw),
        torch.tensor(sa), kind=kind, act=act).numpy()
    j = np.asarray(jops.fused_dequant_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(sw), jnp.asarray(sa),
        kind=kind, act=act, backend="xla"))
    for ref_out in (want, j):
        assert np.all(np.abs(got - ref_out) <= bound), (
            case, float(np.max(np.abs(got - ref_out))))
