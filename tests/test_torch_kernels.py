"""The port's four kernel functions against the JAX reference's.

On the CPU each port wrapper (``backend='kernel'``) runs its plain
PyTorch version, because the tensors lie on the CPU; the reference runs
its pure-jnp path (``backend='xla'``) for the sweeps and its Pallas
kernels in interpret mode for one case each, as ``tests/test_fused.py``
runs them. Tolerances:

* ``qmm``, ``qmm_packed`` and ``fused_qmm`` are integer datapaths with
  an exact f32 epilogue: bit-equal (``assert_array_equal``).
* ``fused_dequant_mm`` decodes, scales and applies the act step with the
  same single-rounded f32 operations; only the order of the f32 sum
  differs, so the two agree within 2 * gamma_K * (|x| @ |w|) elementwise
  (gamma_K = K u / (1 - K u), u = 2^-24): the classical bound on the
  difference of two summation orders.

The CUDA kernels themselves run only on the card:
``tests/test_torch_cuda.py`` holds them against the plain versions there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.quant import quantize as jq
from repro_torch.core.ipu import IPUConfig
from repro_torch.kernels import fused as tfused
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qmm as tqmm
from repro_torch.kernels import ref as tref

INT_KINDS = ["int8", "int4", "int4_packed"]
ALL_KINDS = INT_KINDS + ["fp8", "fp4", "fp4_packed"]
# (M, K, N): decode-like, ragged M/N, a 1-wide edge, a wider ragged tile
SHAPES = [(8, 64, 48), (5, 96, 72), (1, 32, 7), (33, 128, 130)]
U = 2.0 ** -24


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


def _x(rng, m, k):
    return rng.normal(0, 2, (m, k)).astype(np.float32)


def _sum_bound(x, w, sw, sa, kind, act):
    """2 gamma_K (|x'| @ |w'|) for the act-processed x' and decoded,
    scaled w' the kernel multiplies (computed with the port's pieces)."""
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
    absdot = (xt.abs().double() @ wf.abs().double()).numpy()
    if act == "quant":
        absdot = absdot * sa
    gamma = k * U / (1 - k * U)
    return 2 * gamma * absdot


# ------------------------------------------------------------ exact int

@pytest.mark.parametrize("shape", SHAPES)
def test_qmm_bit_equal(shape):
    m, k, n = shape
    rng = np.random.default_rng(m * 1000 + n)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    j = jops.int8_matmul(jnp.asarray(a), jnp.asarray(b), backend="xla")
    t = tops.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("shape", SHAPES)
def test_qmm_packed_bit_equal(shape):
    m, k, n = shape
    rng = np.random.default_rng(m * 1000 + n + 1)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-8, 8, (k, n)).astype(np.int8)
    bp = np.array(jops.pack_int4(jnp.asarray(w)))
    j = jops.int4_matmul_packed(jnp.asarray(a), jnp.asarray(bp),
                                backend="xla")
    t = tops.int4_matmul_packed(torch.from_numpy(a), torch.from_numpy(bp))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", INT_KINDS)
def test_fused_qmm_bit_equal(shape, kind):
    m, k, n = shape
    rng = np.random.default_rng(m * 1000 + n + len(kind))
    w, sw = _stored(rng, k, n, kind)
    x = _x(rng, m, k)
    sa = np.float32(0.11)
    j = jops.fused_quantized_matmul(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(sw), jnp.asarray(sa),
                                    kind=kind, backend="xla")
    t = tops.fused_quantized_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(sw), torch.tensor(sa),
                                    kind=kind)
    np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                  np.asarray(j).view(np.uint32))


def test_scale_epilogue_per_row_and_static():
    rng = np.random.default_rng(9)
    acc = rng.integers(-5000, 5000, (4, 6)).astype(np.int32)
    sb = rng.uniform(0.01, 1, 6).astype(np.float32)
    for sa in (rng.uniform(0.01, 1, 4).astype(np.float32), np.float32(0.3)):
        j = jops._scale_epilogue(jnp.asarray(acc), jnp.asarray(sa),
                                 jnp.asarray(sb))
        t = tops._scale_epilogue(torch.from_numpy(acc), torch.tensor(sa),
                                 torch.from_numpy(sb))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# --------------------------------------------------------- fused dequant

@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("act", ["none", "qdq", "quant"])
@pytest.mark.parametrize("kind", ALL_KINDS)
def test_fused_dequant_sweep(kind, act, groups):
    for m, k, n in SHAPES:
        rng = np.random.default_rng(
            [ALL_KINDS.index(kind), len(act), groups, m])
        w, sw = _stored(rng, k, n, kind, groups=groups)
        x = _x(rng, m, k)
        sa = np.float32(0.17)
        j = np.asarray(jops.fused_dequant_matmul(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(sw),
            jnp.asarray(sa), kind=kind, act=act, backend="xla"))
        t = tops.fused_dequant_matmul(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(sw),
            torch.tensor(sa), kind=kind, act=act).numpy()
        bound = _sum_bound(x, w, sw, sa, kind, act)
        assert np.all(np.abs(t - j) <= bound), (
            kind, act, groups, (m, k, n), float(np.max(np.abs(t - j))))


# ------------------------------------------- reference Pallas, interpret

def test_pallas_interpret_qmm_and_packed():
    rng = np.random.default_rng(21)
    a = rng.integers(-128, 128, (9, 64)).astype(np.int8)
    b = rng.integers(-128, 128, (64, 20)).astype(np.int8)
    w = rng.integers(-8, 8, (64, 20)).astype(np.int8)
    bp = np.array(jops.pack_int4(jnp.asarray(w)))
    j = jops.int8_matmul(jnp.asarray(a), jnp.asarray(b), backend="pallas")
    t = tops.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    jp = jops.int4_matmul_packed(jnp.asarray(a), jnp.asarray(bp),
                                 backend="pallas")
    tp = tops.int4_matmul_packed(torch.from_numpy(a), torch.from_numpy(bp))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_pallas_interpret_fused_qmm():
    rng = np.random.default_rng(22)
    w, sw = _stored(rng, 64, 24, "int4_packed")
    x = _x(rng, 7, 64)
    j = jops.fused_quantized_matmul(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(sw), jnp.float32(0.2),
                                    kind="int4_packed", backend="pallas")
    t = tops.fused_quantized_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(sw), torch.tensor(0.2),
                                    kind="int4_packed")
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_pallas_interpret_fused_dequant():
    rng = np.random.default_rng(23)
    w, sw = _stored(rng, 64, 24, "fp4_packed", groups=4)
    x = _x(rng, 7, 64)
    sa = np.float32(0.13)
    j = np.asarray(jops.fused_dequant_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(sw), jnp.asarray(sa),
        kind="fp4_packed", act="qdq", backend="pallas"))
    t = tops.fused_dequant_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(sw), torch.tensor(sa),
                                  kind="fp4_packed", act="qdq").numpy()
    assert np.all(np.abs(t - j) <= _sum_bound(x, w, sw, sa, "fp4_packed",
                                              "qdq"))


# ------------------------------------------------------------- wrappers

def test_wrappers_take_plain_version_on_cpu_and_count_no_launch():
    tops.reset_launch_counts()
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.integers(-128, 128, (3, 8)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, (8, 5)).astype(np.int8))
    np.testing.assert_array_equal(
        tops.int8_matmul(a, b).numpy(),
        tops.int8_matmul(a, b, backend="ref").numpy())
    assert all(v == 0 for v in tops.launch_counts().values())
    assert set(tops.launch_counts()) == {"qmm", "qmm_packed", "fused_qmm",
                                         "fused_dequant_mm", "mp_matmul"}


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((4, 8))
    with pytest.raises(TypeError):
        tqmm.qmm(torch.zeros((4, 8)), torch.zeros((8, 3), dtype=torch.int8))
    with pytest.raises(ValueError):
        tqmm.qmm(torch.zeros((4, 8), dtype=torch.int8),
                 torch.zeros((7, 3), dtype=torch.int8))
    with pytest.raises(ValueError):
        tqmm.qmm(torch.zeros((8, 4), dtype=torch.int8).T,
                 torch.zeros((8, 3), dtype=torch.int8))
    with pytest.raises(ValueError):      # per-group scales need K % G == 0
        tfused.fused_dequant_mm(x, torch.zeros((8, 3), dtype=torch.int8),
                                torch.ones((3, 3)), kind="int8")
    with pytest.raises(ValueError):      # an act step needs sa
        tfused.fused_dequant_mm(x, torch.zeros((8, 3), dtype=torch.int8),
                                torch.ones((1, 3)), kind="int8", act="qdq")
    with pytest.raises(TypeError):       # fp codes are uint8 storage
        tfused.fused_dequant_mm(x, torch.zeros((8, 3), dtype=torch.int8),
                                torch.ones((1, 3)), kind="fp8")
    with pytest.raises(ValueError):
        tops.fused_dequant_matmul(x, torch.zeros((8, 3), dtype=torch.int8),
                                  torch.ones((1, 3)), backend="xla")
    with pytest.raises(NotImplementedError):    # the kernel is plain IPU(w)
        tops.mp_matmul(x, x.T, IPUConfig(multi_cycle=True))
