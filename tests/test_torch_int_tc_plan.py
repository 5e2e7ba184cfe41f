"""The kernel of ``fused_qmm`` and ``qmm_packed`` (``csrc/qmm.cu``,
``int_tc_kernel``) as far as the CPU reaches it.

The kernel runs only on the card (``tests/test_torch_cuda.py -k int_tc``
holds it against its plain versions there). What surrounds it is plain
Python or integer arithmetic, checked here against the JAX reference:

* its launch planner, ``kernels.qmm.plan_int_tc``: the plan covers M, N
  and K once, with K ranges of a multiple of 32 rows but the ragged last
  one and at most one thread block cluster of them; it reaches its
  intended block counts at qwen2-0.5b's decode shapes; it refuses what
  it cannot plan;
* the kernel's arithmetic in plain torch: each planned K range's int32
  partial sum, the partials added by the cluster's owner (own first,
  then the others, for every owner), then the epilogue
  ``((float)acc * sa) * sw[n]``. Bit-equal to ``ref.fused_qmm_ref``, to
  the JAX ``fused_quantized_matmul`` (``xla`` route) and to the
  reference's Pallas ``_fused_qmm_kernel`` in interpret mode, for
  ``int8``, ``int4`` and ``int4_packed`` at ragged M, N and K, with
  activations at quantize ties (x = (j + 1/2) sa) and past the clamp;
  the same for ``qmm_packed`` against ``int4_matmul_packed``;
* a model of the kernel's in-register steps on 32-bit words: the nibble
  expansion of packed bytes (per byte lane, no borrow across lanes), the
  4x4 byte transpose into A fragments, and the packing of four
  quantized activations into one word, over all 256 byte values.

Integer results and the exact epilogue are compared bit for bit. Inputs
come from numpy seeds.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.quant import quantize as jq
from repro_torch.kernels import fused as tfused
from repro_torch.kernels import qmm as tqmm
from repro_torch.kernels import ref as tref

SMS = 132                              # an H100 SXM
# qwen2-0.5b's projections, (K, N)
LAYER = {"wq": (896, 896), "wk": (896, 128), "wv": (896, 128),
         "wo": (896, 896), "w_gate": (896, 4864), "w_up": (896, 4864),
         "w_down": (4864, 896)}
ROWS = (1, 8, 16, 17, 256)
RAGGED = [(5, 200, 72), (33, 128, 130), (17, 100, 30), (1, 32, 7),
          (3, 7, 2), (4, 0, 8), (40, 4864, 36)]
SHAPES = [(m, k, n) for m in ROWS for k, n in LAYER.values()] + RAGGED
INT_KINDS = ["int8", "int4", "int4_packed"]


def _covers(ranges, total):
    """Consecutive, non-empty half-open ranges from 0 to ``total``."""
    assert ranges[0][0] == 0 and ranges[-1][1] == total
    for (_, e), (b, _) in zip(ranges, ranges[1:]):
        assert e == b
    return all(e > b for b, e in ranges) or total == 0


# ------------------------------------------------------------- planner

@pytest.mark.parametrize("splits", [None, 1, 3, 8], ids=str)
@pytest.mark.parametrize("packed", [False, True], ids=["rows", "packed"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_partitions_m_n_and_k_once(shape, packed, splits):
    m, k, n = shape
    if packed and k % 2:
        with pytest.raises(ValueError):
            tqmm.plan_int_tc(m, n, k, packed, SMS, splits)
        return
    plan = tqmm.plan_int_tc(m, n, k, packed, SMS, splits)
    assert plan.mt == (1 if m <= 8 else 2 if m <= 16 else 4)
    assert 1 <= plan.splits <= tqmm.TC_MAX_SPLITS
    gx, gy, gz = plan.grid(m, n)
    assert gz == plan.splits and gy <= 65535
    bn = tqmm.TC_WIDTH
    n_ranges = [(i * bn, min(n, (i + 1) * bn)) for i in range(gx)]
    m_ranges = [(i * 8 * plan.mt, min(m, (i + 1) * 8 * plan.mt))
                for i in range(gy)]
    assert _covers(n_ranges, n) and _covers(m_ranges, m)
    k_ranges = plan.k_ranges(k)
    assert _covers(k_ranges, k)
    assert plan.kc > 0 and plan.kc % 32 == 0
    for b, e in k_ranges[:-1]:
        assert e - b == plan.kc
    if packed:                        # whole stored rows in every range
        assert all(b % 2 == 0 and e % 2 == 0 for b, e in k_ranges)
    assert plan.splits == max(1, -(-k // plan.kc))
    if splits is not None:
        assert plan.splits <= splits


# the plans at M = 8 on 132 SMs: (splits, blocks) at one and at two
# blocks per SM (the default). Blocks are 128 columns wide; K takes the
# most ranges (at most 8, a multiple of 32 rows each) within that many
# blocks per SM: K = 896 comes out as 7 ranges of 128.
DECODE_PLANS = {
    1: {"wq": (7, 49), "wk": (7, 7), "wv": (7, 7), "wo": (7, 49),
        "w_gate": (3, 114), "w_up": (3, 114), "w_down": (8, 56)},
    2: {"wq": (7, 49), "wk": (7, 7), "wv": (7, 7), "wo": (7, 49),
        "w_gate": (6, 228), "w_up": (6, 228), "w_down": (8, 56)},
}


def _most_ranges_within(plan, m, n, k, per_sm):
    """No more K ranges fit: the cluster is full, K has no more ranges
    of 32 rows, or one more range would pass ``per_sm`` blocks per SM;
    and the grid stays within it unless K is not split at all."""
    tiles = plan.blocks(m, n) // plan.splits
    more = tqmm.plan_int_tc(m, n, k, False, SMS, min(
        tqmm.TC_MAX_SPLITS, plan.splits + 1))
    full = more.splits == plan.splits
    assert full or tiles * (plan.splits + 1) > per_sm * SMS
    assert plan.splits == 1 or plan.blocks(m, n) <= per_sm * SMS


@pytest.mark.parametrize("packed", [False, True], ids=["rows", "packed"])
@pytest.mark.parametrize("per_sm", [1, 2], ids=str)
@pytest.mark.parametrize("name", sorted(LAYER))
def test_plan_reaches_the_intended_blocks_at_decode(name, per_sm, packed):
    k, n = LAYER[name]
    plan = tqmm.plan_int_tc(8, n, k, packed, SMS, blocks_per_sm=per_sm)
    assert (plan.splits, plan.blocks(8, n)) == DECODE_PLANS[per_sm][name]
    _most_ranges_within(plan, 8, n, k, per_sm)
    if per_sm == tqmm.INT_TC_BLOCKS_PER_SM:
        assert plan == tqmm.plan_int_tc(8, n, k, packed, SMS)


@pytest.mark.parametrize("m", [16, 17, 256])
@pytest.mark.parametrize("name", sorted(LAYER))
def test_plan_at_more_rows_splits_k_within_the_target(name, m):
    """At 16, 17 and 256 rows (a prefill wave: 8 row tiles of 32) the
    grid keeps the most K ranges within two blocks per SM; where the
    tiles alone fill more (``w_gate``/``w_up`` at 256 rows), K is not
    split."""
    k, n = LAYER[name]
    plan = tqmm.plan_int_tc(m, n, k, False, SMS)
    _most_ranges_within(plan, m, n, k, tqmm.INT_TC_BLOCKS_PER_SM)
    if m == 256 and n == 4864:
        assert plan.splits == 1 and plan.blocks(m, n) == 304


@pytest.mark.parametrize("bad", [
    dict(m=0), dict(n=0), dict(k=-1), dict(k=7, packed=True),
    dict(splits=0), dict(splits=tqmm.TC_MAX_SPLITS + 1), dict(sms=0),
    dict(blocks_per_sm=0)], ids=str)
def test_plan_refuses_what_has_no_plan(bad):
    args = dict(m=8, n=8, k=64, packed=False, sms=SMS, splits=None,
                blocks_per_sm=1)
    args.update(bad)
    with pytest.raises(ValueError):
        tqmm.plan_int_tc(args["m"], args["n"], args["k"], args["packed"],
                         args["sms"], args["splits"],
                         blocks_per_sm=args["blocks_per_sm"])


# ----------------------------------------------- the kernel's arithmetic

def _acts(rng, m, k, sa):
    """f32 activations: normal values, quantize ties x = (j + 1/2) sa,
    and values past the clamp (|x / sa| > 127.5)."""
    x = rng.normal(0, 2, (m, k)).astype(np.float32)
    j = rng.integers(-140, 140, (m, k))
    ties = ((j + 0.5) * np.float32(sa)).astype(np.float32)
    pick = rng.random((m, k))
    x = np.where(pick < 0.4, ties, x)
    x = np.where(pick > 0.95, np.float32(300 * sa) * np.sign(x), x)
    return x.astype(np.float32)


def _stored(rng, k, n, kind):
    """(stored int weight, (1, N) scales) as numpy, by the reference."""
    w = jnp.asarray(rng.normal(0, 1, (k, n)), jnp.float32)
    q, s = jq.quantize_symmetric(w, 8 if kind == "int8" else 4, axis=-2)
    if kind == "int4_packed":
        q = jops.pack_int4(q)
    return np.array(q), np.array(s).reshape(1, n)


def _plan_sum(a, w, plan, k):
    """The kernel's int32 sum of ``a @ w`` over the plan's K ranges: each
    range's partial, added by the cluster's owner in its order (its own
    partial, then the others by rank), the same for every owner."""
    parts = [tref.qmm_ref(a[:, lo:hi].contiguous(), w[lo:hi].contiguous())
             for lo, hi in plan.k_ranges(k)]
    sums = []
    for owner in range(len(parts)):
        total = parts[owner].clone()
        for s, p in enumerate(parts):
            if s != owner:
                total += p
        sums.append(total)
    assert all(torch.equal(sums[0], t) for t in sums[1:])
    return sums[0]


def _kernel_model(x, w, sw, sa, kind, plan):
    """What int_tc_kernel computes for fused_qmm, in plain torch."""
    k = x.shape[1]
    a = tref.quantize_act_ref(x, sa).to(torch.int8)
    wq = tref.unpack_int4_ref(w) if kind == "int4_packed" else w
    acc = _plan_sum(a, wq, plan, k)
    return (acc.to(torch.float32) * sa) * sw.reshape(1, -1)


ARITH_SHAPES = [(8, 896, 128), (17, 200, 72), (5, 66, 30), (1, 32, 7),
                (33, 130, 9), (256, 64, 40)]


@pytest.mark.parametrize("sa", [0.125, 0.1], ids=str)
@pytest.mark.parametrize("splits", [None, 1, 3, 8], ids=str)
@pytest.mark.parametrize("shape", ARITH_SHAPES, ids=str)
@pytest.mark.parametrize("kind", INT_KINDS)
def test_fused_split_k_arithmetic_equals_plain_and_jax(kind, shape, splits,
                                                       sa):
    m, k, n = shape
    rng = np.random.default_rng(m * 1009 + k * 7 + n)
    w, sw = _stored(rng, k, n, kind)
    x = _acts(rng, m, k, sa)
    xt, wt, swt = (torch.from_numpy(v) for v in (x, w, sw))
    sat = torch.tensor(sa, dtype=torch.float32)
    plan = tqmm.plan_int_tc(m, n, k, kind == "int4_packed", SMS, splits)
    got = _kernel_model(xt, wt, swt, sat, kind, plan)
    want = tref.fused_qmm_ref(xt, wt, swt, sat, kind=kind)
    assert torch.equal(got, want)
    j = jops.fused_quantized_matmul(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(sw), jnp.float32(sa),
                                    kind=kind, backend="xla")
    np.testing.assert_array_equal(got.numpy(), np.asarray(j))
    # the port's wrapper on CPU tensors (its plain version)
    np.testing.assert_array_equal(
        tfused.fused_qmm(xt, wt, swt, sat, kind=kind).numpy(), np.asarray(j))


@pytest.mark.parametrize("shape", [(7, 64, 24), (9, 96, 40)], ids=str)
@pytest.mark.parametrize("kind", INT_KINDS)
def test_fused_split_k_arithmetic_equals_pallas_interpret(kind, shape):
    m, k, n = shape
    rng = np.random.default_rng(k + n + len(kind))
    sa = 0.125
    w, sw = _stored(rng, k, n, kind)
    x = _acts(rng, m, k, sa)
    plan = tqmm.plan_int_tc(m, n, k, kind == "int4_packed", SMS, splits=3)
    assert plan.splits > 1
    got = _kernel_model(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(sw), torch.tensor(sa), kind, plan)
    j = jops.fused_quantized_matmul(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(sw), jnp.float32(sa),
                                    kind=kind, backend="pallas")
    np.testing.assert_array_equal(got.numpy(), np.asarray(j))


@pytest.mark.parametrize("splits", [None, 1, 3, 8], ids=str)
@pytest.mark.parametrize("shape", ARITH_SHAPES, ids=str)
def test_packed_split_k_sum_equals_plain_and_jax(shape, splits):
    """qmm_packed: int8 activations (all -128 in row 0) x random packed
    bytes (column 0 all 0x88: both nibbles -8), summed over the plan's
    K ranges."""
    m, k, n = shape
    rng = np.random.default_rng(m * 13 + k * 5 + n)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    bp = rng.integers(-128, 128, (k // 2, n)).astype(np.int8)
    a[0] = -128
    bp[:, 0] = np.int8(-120)           # 0x88
    at, bt = torch.from_numpy(a), torch.from_numpy(bp)
    plan = tqmm.plan_int_tc(m, n, k, True, SMS, splits)
    got = _plan_sum(at, tref.unpack_int4_ref(bt), plan, k)
    j = jops.int4_matmul_packed(jnp.asarray(a), jnp.asarray(bp),
                                backend="xla")
    np.testing.assert_array_equal(got.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tqmm.qmm_packed(at, bt).numpy(),
                                  np.asarray(j))


@pytest.mark.parametrize("shape", [(8, 96, 40), (17, 100, 30)], ids=str)
def test_packed_split_k_sum_equals_pallas_interpret(shape):
    m, k, n = shape
    rng = np.random.default_rng(k * n)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    bp = rng.integers(-128, 128, (k // 2, n)).astype(np.int8)
    plan = tqmm.plan_int_tc(m, n, k, True, SMS, splits=3)
    assert plan.splits > 1
    got = _plan_sum(torch.from_numpy(a),
                    tref.unpack_int4_ref(torch.from_numpy(bp)), plan, k)
    j = jops.int4_matmul_packed(jnp.asarray(a), jnp.asarray(bp),
                                backend="pallas")
    np.testing.assert_array_equal(got.numpy(), np.asarray(j))


# ------------------------------------ the kernel's in-register word steps

MASK = 0xFFFFFFFF


def _bytes(v):
    """The four byte lanes of 32-bit words (int64 tensors), low first."""
    return [(v >> (8 * i)) & 0xFF for i in range(4)]


def _word(lanes):
    return sum((b & 0xFF) << (8 * i) for i, b in enumerate(lanes))


def _vsub4(a, b):
    """CUDA's __vsub4: per byte lane, a - b mod 256, no borrow across."""
    return _word([x - y for x, y in zip(_bytes(a), _bytes(b))])


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm(x, y, sel) for selectors 0..7: byte i of the
    result is byte ((sel >> 4i) & 7) of the 8 bytes {y, x}."""
    src = _bytes(x) + _bytes(y)
    return _word([src[(sel >> (4 * i)) & 7] for i in range(4)])


def _nibbles_lo(p):
    """int_tc_kernel's nibbles_lo: the low nibbles, sign-extended."""
    return _vsub4((p & 0x0F0F0F0F) ^ 0x08080808,
                  torch.full_like(p, 0x08080808))


def _nibbles_hi(p):
    """int_tc_kernel's nibbles_hi: the high nibbles, sign-extended."""
    return _vsub4(((p >> 4) & 0x0F0F0F0F) ^ 0x08080808,
                  torch.full_like(p, 0x08080808))


def _transpose4x4(w):
    """csrc/qmm.cu's transpose4x4: w[j] holds bytes (r_j, c0..c3), the
    result's word i bytes (r0..r3, c_i)."""
    t0 = _byte_perm(w[0], w[1], 0x5140)
    t1 = _byte_perm(w[0], w[1], 0x7362)
    t2 = _byte_perm(w[2], w[3], 0x5140)
    t3 = _byte_perm(w[2], w[3], 0x7362)
    return [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]


def _signed(b):
    return torch.where(b >= 128, b - 256, b)


@pytest.mark.parametrize("shift", [0, 37, 101, 211], ids=str)
def test_packed_fragment_words_equal_unpack_int4_ref(shift):
    """Two packed k2-rows x 4 columns, every byte value in every one of
    the 8 positions: the expanded, transposed words hold, in column c,
    the four k-rows of column c that ``unpack_int4_ref`` gives, each a
    sign-extended byte."""
    v = torch.arange(256, dtype=torch.int64)
    # byte (d, c) of case v: every position sees all 256 values
    pos = [[(v + shift * (4 * d + c) + 7 * d) % 256 for c in range(4)]
           for d in range(2)]
    p0, p1 = _word(pos[0]), _word(pos[1])
    frag = _transpose4x4([_nibbles_lo(p0), _nibbles_hi(p0),
                          _nibbles_lo(p1), _nibbles_hi(p1)])
    packed = torch.stack([torch.stack(pos[d], dim=-1) for d in range(2)],
                         dim=1).to(torch.uint8).view(torch.int8)
    want = tref.unpack_int4_ref(packed).to(torch.int64)   # (256, 4, 4)
    for c in range(4):
        got = torch.stack([_signed(b) for b in _bytes(frag[c])], dim=-1)
        assert torch.equal(got, want[:, :, c]), c
    assert all(bool(((w >= 0) & (w <= MASK)).all()) for w in frag)


def test_nibble_expansion_of_every_byte():
    """Per byte lane, the low and high nibble of each of the 256 byte
    values, sign-extended, without a borrow into the next lane: equal
    to ``unpack_int4_ref``."""
    v = torch.arange(256, dtype=torch.int64)
    for lanes in ([v, v, v, v], [v, 255 - v, (v * 7) % 256, 0 * v + 0x80]):
        p = _word(lanes)
        lo, hi = _bytes(_nibbles_lo(p)), _bytes(_nibbles_hi(p))
        for i, b in enumerate(lanes):
            want = tref.unpack_int4_ref(
                b.to(torch.uint8).view(torch.int8).reshape(-1, 1, 1))
            assert torch.equal(_signed(lo[i]), want[:, 0, 0].to(torch.int64))
            assert torch.equal(_signed(hi[i]), want[:, 1, 0].to(torch.int64))


def test_quantized_words_pack_four_codes():
    """int_tc_kernel's quantize4: four codes in [-128, 127], each masked
    to a byte and shifted into its lane, read back as signed bytes."""
    q = torch.arange(-128, 128, dtype=torch.int64)
    lanes = [q, q.flip(0), (q * 5) % 256 - 128, torch.full_like(q, -128)]
    word = ((lanes[0] & 0xFF) | (lanes[1] & 0xFF) << 8
            | (lanes[2] & 0xFF) << 16 | (lanes[3] << 24) & (0xFF << 24))
    for i, b in enumerate(_bytes(word)):
        assert torch.equal(_signed(b), lanes[i])
