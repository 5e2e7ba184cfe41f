"""The port's FP-IP matmul (``mp_matmul``) against the JAX reference's, on
the CPU.

On CPU tensors the port's wrapper runs its plain version
(``kernels.ref.mp_matmul_blocked_ref``); the reference runs its Pallas
kernel in interpret mode (as ``tests/test_kernels.py`` runs it), its
``backend='xla'`` route (``ref.mp_matmul_xla``) and its Python-int oracle
``exact_ref.approx_fp_ip`` on single output elements. Tolerance: bit
equality everywhere, on the output's bit patterns (the datapath is
integer arithmetic with one RNE rounding at the end). The CUDA kernel
itself runs only on the card: ``tests/test_torch_cuda.py`` holds it
against the same plain version there.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import exact_ref
from repro.core import ipu as jipu
from repro.kernels import mpmm as jmpmm
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from _torch_parity import one_intra_op_thread  # noqa: F401 (autouse)
from repro_torch.core.ipu import IPUConfig
from repro_torch.kernels import _build
from repro_torch.kernels import mpmm as tmpmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# the kernel test configs of tests/test_kernels.py
MP_CFGS = [
    IPUConfig(n=16, w=16, accum="fp32"),
    IPUConfig(n=16, w=28, accum="fp32"),
    IPUConfig(n=8, w=12, accum="fp16"),
]
SHAPES = [(8, 16, 8), (16, 48, 24), (5, 33, 7)]


def _id(c):
    return f"n{c.n}w{c.w}{c.accum}"


def jcfg(cfg: IPUConfig) -> jipu.IPUConfig:
    return jipu.IPUConfig(**dataclasses.asdict(cfg))


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view({2: torch.int16, 4: torch.int32}[
            x.element_size()]).numpy().astype(np.int64)
    x = np.asarray(x)
    return x.view({2: np.int16, 4: np.int32}[x.dtype.itemsize]).astype(
        np.int64)


def assert_same(got, want, what=""):
    np.testing.assert_array_equal(bits(got), bits(want), err_msg=what)


def rand_f16(rng, shape, dist="normal"):
    if dist == "wide":
        x = rng.normal(0, 1, shape) * np.exp2(rng.integers(-10, 12, shape))
    else:
        x = rng.normal(0, 1, shape)
    x = np.asarray(x, np.float16)
    x[~np.isfinite(x)] = 0
    return x


def edge_operands(rng, m, k, n):
    """Wide values plus zeros, -0, subnormals and an all-zero K-group."""
    a = rand_f16(rng, (m, k), "wide")
    b = rand_f16(rng, (k, n), "wide")
    a[0] = 0
    a[1, ::3] = -0.0
    a[2] = (rng.integers(-1023, 1024, k) * 2.0 ** -24).astype(np.float16)
    b[:, 0] = (rng.integers(-1023, 1024, k) * 2.0 ** -24).astype(np.float16)
    b[:16, 1] = 0                                  # the first group of col 1
    a[3, 16:32] = 0                                # the second group of row 3
    return a, b


def port(a, b, cfg, fused=False, backend="kernel"):
    return tops.mp_matmul(torch.from_numpy(a), torch.from_numpy(b), cfg,
                          fused=fused, backend=backend)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dist", ["normal", "wide"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cfg", MP_CFGS, ids=_id)
def test_plain_matches_pallas_kernel(cfg, shape, dist, fused):
    m, k, n = shape
    rng = np.random.default_rng(abs(hash((shape, cfg.w, dist))) % 2 ** 32)
    a = rand_f16(rng, (m, k), dist)
    b = rand_f16(rng, (k, n), dist)
    got = port(a, b, cfg, fused)
    want = jmpmm.mp_matmul(jnp.asarray(a), jnp.asarray(b), jcfg(cfg), bm=8,
                           bn=8, fused=fused, interpret=True)
    assert got.dtype == (torch.float16 if cfg.accum == "fp16"
                         else torch.float32)
    assert got.shape == (m, n)
    assert_same(got, want)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("cfg", MP_CFGS + [
    IPUConfig(n=16, w=16, accum="fp32", rounding="floor"),
    IPUConfig(n=16, w=20, accum="fp32", iter_order="desc"),
    IPUConfig(n=16, w=16, accum="bf16", sw_precision=12),
    IPUConfig(n=8, w=24, accum="fp16", sw_precision=30)],
    ids=lambda c: f"{_id(c)}{c.rounding[:2]}{c.iter_order[:1]}"
                  f"p{c.precision}")
def test_plain_matches_xla_backend(cfg, fused):
    rng = np.random.default_rng(cfg.w * 31 + cfg.n)
    for m, k, n in ((12, 40, 9), (20, 70, 33)):
        a, b = edge_operands(rng, m, k, n)
        got = port(a, b, cfg, fused, backend="ref")
        want = jops.mp_matmul(jnp.asarray(a), jnp.asarray(b), jcfg(cfg),
                              fused=fused, backend="xla")
        assert_same(got, want, f"{(m, k, n)}")
        assert_same(port(a, b, cfg, fused), got)   # the CPU wrapper


@pytest.mark.parametrize("cfg", MP_CFGS, ids=_id)
def test_edge_operands_match_pallas_kernel(cfg):
    rng = np.random.default_rng(cfg.w)
    a, b = edge_operands(rng, 9, 50, 11)
    for fused in (False, True):
        want = jmpmm.mp_matmul(jnp.asarray(a), jnp.asarray(b), jcfg(cfg),
                               bm=8, bn=8, fused=fused, interpret=True)
        assert_same(port(a, b, cfg, fused), want)


def test_fp16_accumulation_overflows_to_inf_as_the_reference():
    """fp16 outputs past 65504 round to +-inf (round_to_fp's overflow
    path), and tiny ones to subnormals or signed zeros."""
    cfg = IPUConfig(n=8, w=12, accum="fp16")
    a = np.full((3, 16), 200.0, np.float16)
    a[1] = -200.0
    a[2] = 2.0 ** -12
    b = np.full((16, 4), 300.0, np.float16)
    b[:, 1] = 2.0 ** -13
    b[:, 2] = -(2.0 ** -14)
    got = port(a, b, cfg)
    want = jops.mp_matmul(jnp.asarray(a), jnp.asarray(b), jcfg(cfg),
                          backend="xla")
    assert_same(got, want)
    assert torch.isinf(got[0, 0]) and torch.isinf(got[1, 0])
    assert got[1, 0] < 0


def test_faithful_matches_core_and_python_oracle():
    cfg = IPUConfig(n=16, w=16, accum="fp32")
    rng = np.random.default_rng(13)
    a = rand_f16(rng, (3, 40), "wide")
    b = rand_f16(rng, (40, 2), "wide")
    got = port(a, b, cfg)
    assert_same(tref.mp_matmul_ref(torch.from_numpy(a), torch.from_numpy(b),
                                   cfg), got)
    assert_same(jref.mp_matmul_ref(jnp.asarray(a), jnp.asarray(b),
                                   jcfg(cfg)), got)
    for i in range(3):
        for j in range(2):
            want = exact_ref.approx_fp_ip(a[i], b[:, j], jcfg(cfg))
            assert_same(got[i, j], np.asarray(want))


def test_fused_alias_and_accuracy():
    """``mp_matmul_fused_ref`` is the fused mode, and the fused datapath
    (one truncation instead of nine) is no less accurate in aggregate."""
    cfg = IPUConfig(n=16, w=16, accum="fp32")
    rng = np.random.default_rng(17)
    a = rand_f16(rng, (16, 64), "wide")
    b = rand_f16(rng, (64, 16), "wide")
    fused = port(a, b, cfg, fused=True)
    assert_same(tref.mp_matmul_fused_ref(torch.from_numpy(a),
                                         torch.from_numpy(b), cfg), fused)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    faithful = port(a, b, cfg).double().numpy()
    assert np.abs(fused.double().numpy() - exact).sum() <= \
        np.abs(faithful - exact).sum() * 1.05


def test_ops_casts_operands_to_f16_as_the_reference():
    cfg = IPUConfig(n=16, w=16)
    rng = np.random.default_rng(21)
    a = rng.normal(0, 3, (6, 35)).astype(np.float32)
    b = rng.normal(0, 3, (35, 10)).astype(np.float32)
    got = tops.mp_matmul(torch.from_numpy(a), torch.from_numpy(b), cfg)
    want = jops.mp_matmul(jnp.asarray(a), jnp.asarray(b), jcfg(cfg),
                          backend="xla")
    assert_same(got, want)


# ------------------------------------------------------------- wrappers

def test_cpu_tensors_take_the_plain_version_and_count_no_launch(monkeypatch):
    def refuse(name):
        raise AssertionError(f"loader called for {name} on CPU tensors")
    monkeypatch.setattr(_build, "library", refuse)
    before = tops.launch_counts()
    assert before["mp_matmul"] == tmpmm.LAUNCHES["mp_matmul"]
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rand_f16(rng, (4, 20)))
    b = torch.from_numpy(rand_f16(rng, (20, 6)))
    for fused in (False, True):
        assert torch.equal(tmpmm.mp_matmul(a, b, fused=fused),
                           tref.mp_matmul_blocked_ref(a, b, fused=fused))
    assert tops.launch_counts() == before
    tops.reset_launch_counts()
    assert tops.launch_counts()["mp_matmul"] == 0


def test_wrapper_refuses_what_the_kernel_does_not_take():
    a = torch.zeros((4, 16), dtype=torch.float16)
    b = torch.zeros((16, 3), dtype=torch.float16)
    for cfg in (IPUConfig(multi_cycle=True), IPUConfig(operand="bf16"),
                IPUConfig(operand="tf32")):
        with pytest.raises(NotImplementedError):
            tmpmm.mp_matmul(a, b, cfg)
        with pytest.raises(NotImplementedError):
            tops.mp_matmul(a, b, cfg)
    # the plain route takes any config, as the reference's backend='xla'
    mc = IPUConfig(n=8, w=12, multi_cycle=True)
    assert_same(tops.mp_matmul(a, b, mc, backend="ref"),
                jops.mp_matmul(jnp.zeros((4, 16), jnp.float16),
                               jnp.zeros((16, 3), jnp.float16), jcfg(mc),
                               backend="xla"))
    with pytest.raises(TypeError):
        tmpmm.mp_matmul(a.float(), b)
    with pytest.raises(ValueError):
        tmpmm.mp_matmul(a, b[:15])
    with pytest.raises(ValueError):
        tmpmm.mp_matmul(a.T.contiguous().T, b[:4].T.contiguous().T)
    with pytest.raises(ValueError):
        tmpmm.mp_matmul(a, torch.zeros((16, 3), dtype=torch.float16,
                                       device="meta"))
    with pytest.raises(ValueError):
        tops.mp_matmul(a, b, backend="xla")


# -------------------------------------------------- the fp16_ipu executor

def test_exact_fp16_ipu_executor_matches_reference():
    """``mp_linear`` under an exact fp16_ipu spec: leading dims flattened,
    the bf16 activation cast to f16, the kernel's f32 output reshaped,
    bias added and cast to the compute dtype — as the reference does."""
    from repro.core.policy import PrecisionSpec as JSpec
    from repro.layers.mplinear import mp_linear as jlinear
    from repro.quant.prepare import prepare_weight as jprepare
    from repro_torch.core.policy import PrecisionSpec
    from repro_torch.layers.mplinear import mp_linear
    from repro_torch.quant.prepare import prepare_weight
    rng = np.random.default_rng(5)
    w = (rng.normal(0, 1, (48, 20)) / 7).astype(np.float32)
    bias = rng.normal(0, 1, 20).astype(np.float32)
    x = rng.normal(0, 2, (2, 3, 48)).astype(np.float32)
    for cfg in (IPUConfig(n=16, w=16, accum="fp32"),
                IPUConfig(n=8, w=12, accum="fp16")):
        spec = PrecisionSpec("fp16_ipu", exact=True, ipu=cfg)
        jspec = JSpec("fp16_ipu", exact=True, ipu=jcfg(cfg))
        pw = prepare_weight(torch.from_numpy(w), spec)
        jw = jprepare(jnp.asarray(w), jspec)
        assert pw.kind == jw.kind == "fp16"
        assert_same(pw.data, np.asarray(jw.data))
        xt = torch.from_numpy(x).to(torch.bfloat16)
        got = mp_linear({"w": pw, "b": torch.from_numpy(bias)}, xt, spec)
        want = jlinear({"w": jw, "b": jnp.asarray(bias)},
                       jnp.asarray(x).astype(jnp.bfloat16), jspec)
        assert got.shape == (2, 3, 20) and got.dtype == torch.bfloat16
        assert_same(got, np.asarray(want))
