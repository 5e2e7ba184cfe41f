"""The port's paper numerics (``repro_torch.core``) against the JAX
reference's (``repro.core``) and its Python-int oracle
(``repro.core.exact_ref``), on the CPU.

Every comparison is bit equality (``assert_array_equal`` on values, or
on bit patterns for floats): the IPU datapath is integer arithmetic, and
the port repeats the reference's int32 ops step by step. Inputs are made
with numpy from fixed seeds and handed to both packages. The cases mirror
``tests/test_core_numerics.py``: codecs over every finite f16 and bf16
bit pattern, the two-limb fixed-point ops, nibble planes, the EHU, the
FP-IP for every configuration there (MC-IPU, both roundings, both accum
formats, ``iter_order='desc'``, bf16 and tf32 operands), INT mode, and
the Theorem 1 bound.
"""
import dataclasses
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _hypothesis_compat import given, settings, st
from repro.core import ehu as jehu
from repro.core import error_bounds as jbounds
from repro.core import exact_ref
from repro.core import fixedpoint as jfx
from repro.core import fp16 as jfp
from repro.core import ipu as jipu
from repro.core import nibble as jnib
from _torch_parity import one_intra_op_thread  # noqa: F401 (autouse)
from repro_torch.core import ehu as tehu
from repro_torch.core import error_bounds as tbounds
from repro_torch.core import fixedpoint as tfx
from repro_torch.core import fp16 as tfp
from repro_torch.core import ipu as tipu
from repro_torch.core import nibble as tnib
from repro_torch.core.ipu import IPUConfig

# ---------------------------------------------------------------- helpers


def bits(x) -> np.ndarray:
    """Values of an int array, or the bit patterns of a float one (so that
    -0, subnormals, inf and NaN compare exactly), as int64 numpy."""
    if isinstance(x, torch.Tensor):
        if x.is_floating_point():
            x = x.contiguous().view({2: torch.int16,
                                     4: torch.int32}[x.element_size()])
        return x.numpy().astype(np.int64)
    x = np.asarray(x)
    if x.dtype.kind == "f" or x.dtype == jnp.bfloat16:
        x = x.view({2: np.int16, 4: np.int32}[x.dtype.itemsize])
    return x.astype(np.int64)


def assert_same(got, want, what=""):
    np.testing.assert_array_equal(bits(got), bits(want), err_msg=what)


def t(x, dtype=None) -> torch.Tensor:
    x = torch.from_numpy(np.array(x))
    return x if dtype is None else x.to(dtype)


def jcfg(cfg: IPUConfig) -> jipu.IPUConfig:
    return jipu.IPUConfig(**dataclasses.asdict(cfg))


def rand_fp16(rng, n, scale=1.0, dist="normal"):
    if dist == "normal":
        x = rng.normal(0, scale, n)
    elif dist == "wide":
        x = rng.normal(0, 1, n) * np.exp2(rng.integers(-12, 14, n))
    else:
        raise ValueError(dist)
    x = np.asarray(x, np.float16)
    x[~np.isfinite(x)] = 0.0
    return x


def all_f16(finite=True) -> np.ndarray:
    x = np.arange(1 << 16, dtype=np.uint16).view(np.float16)
    return x[np.isfinite(x)] if finite else x


def all_bf16_bits(finite=True) -> np.ndarray:
    b = np.arange(1 << 16, dtype=np.uint16)
    if finite:
        b = b[((b >> 7) & 0xFF) != 0xFF]
    return b


def jbf16(b16: np.ndarray):
    return jax.lax.bitcast_convert_type(jnp.asarray(b16), jnp.bfloat16)


def tbf16(b16: np.ndarray) -> torch.Tensor:
    return t(b16.view(np.int16)).view(torch.bfloat16)


# ------------------------------------------------------------- fp16 codec


class TestCodec:
    def test_decompose_every_finite_fp16(self):
        x = all_f16()
        for got, want in zip(tfp.decompose(t(x), tfp.FP16),
                             jfp.decompose(jnp.asarray(x), jfp.FP16)):
            assert_same(got, want)

    def test_compose_roundtrip_every_finite_fp16(self):
        x = all_f16()
        s, e, m = jfp.decompose(jnp.asarray(x), jfp.FP16)
        got = tfp.compose(t(s), t(e), t(m), tfp.FP16)
        assert got.dtype == torch.float16
        assert_same(got, jfp.compose(s, e, m, jfp.FP16))

    def test_decompose_compose_every_finite_bf16(self):
        b = all_bf16_bits()
        tout = tfp.decompose(tbf16(b), tfp.BF16)
        jout = jfp.decompose(jbf16(b), jfp.BF16)
        for got, want in zip(tout, jout):
            assert_same(got, want)
        back = tfp.compose(*tout, tfp.BF16)
        assert back.dtype == torch.bfloat16
        assert_same(back, jfp.compose(*jout, jfp.BF16))

    def test_fp32_fields(self):
        rng = np.random.default_rng(0)
        x = np.concatenate([
            rng.normal(0, 1e3, 256), rng.normal(0, 1, 64) * 1e-40,
            [0.0, -0.0, 1.0, -1.0, 3.4e38, -1.2e-38]]).astype(np.float32)
        tout = tfp.decompose(t(x), tfp.FP32)
        jout = jfp.decompose(jnp.asarray(x), jfp.FP32)
        for got, want in zip(tout, jout):
            assert_same(got, want)
        assert_same(tfp.compose(*tout, tfp.FP32), jfp.compose(*jout,
                                                               jfp.FP32))

    @pytest.mark.parametrize("fmt", ["fp16", "bf16", "fp32"])
    def test_make_inf_and_is_finite(self, fmt):
        sign = np.array([1, -1, -3, 0], np.int32)
        assert_same(tfp.make_inf(t(sign), tfp.FORMATS[fmt]),
                    jfp.make_inf(jnp.asarray(sign), jfp.FORMATS[fmt]))
        if fmt == "fp16":
            x = all_f16(finite=False)
            got = tfp.is_finite(t(x), tfp.FP16)
            want = jfp.is_finite(jnp.asarray(x), jfp.FP16)
        elif fmt == "bf16":
            b = all_bf16_bits(finite=False)
            got = tfp.is_finite(tbf16(b), tfp.BF16)
            want = jfp.is_finite(jbf16(b), jfp.BF16)
        else:
            x = np.array([1.0, np.inf, -np.inf, np.nan, 0.0], np.float32)
            got = tfp.is_finite(t(x), tfp.FP32)
            want = jfp.is_finite(jnp.asarray(x), jfp.FP32)
        assert_same(got, want)

    def test_ranges_and_floor_log2(self):
        for name in ("fp16", "bf16", "fp32", "tf32"):
            tf, jf = tfp.FORMATS[name], jfp.FORMATS[name]
            assert tuple(tf) == tuple(jf)
            assert (tf.bias, tf.mag_bits, tf.min_exp, tf.max_exp) == \
                (jf.bias, jf.mag_bits, jf.min_exp, jf.max_exp)
            assert tfp.product_exponent_range(tf) == \
                jfp.product_exponent_range(jf)
            assert tfp.max_alignment(tf) == jfp.max_alignment(jf)
        assert tfp.max_alignment(tfp.FP16) == 58  # paper §2.2
        rng = np.random.default_rng(1)
        x = np.concatenate([np.arange(1, 4097), rng.integers(1, 1 << 24, 4096),
                            [(1 << 24) - 1]]).astype(np.int32)
        assert_same(tfp.floor_log2(t(x)), jfp.floor_log2(jnp.asarray(x)))


# ------------------------------------------------------------ fixedpoint

FX_OPS = ["canon", "add", "neg", "abs_", "mul_sign", "_shr_unsigned",
          "_dropped_nonzero", "shr_trunc", "shr_floor", "shl", "shl_dyn",
          "select", "msb_index", "_bit_at", "round_to_fp"]


def _fx_values(rng, size=512):
    """Signed values of |v| <= 2**47 (the accumulator's range) with edges,
    as canonical (hi, lo) limbs and as Python ints."""
    v = rng.integers(-(2 ** 47), 2 ** 47, size, dtype=np.int64)
    v[: size // 4] >>= rng.integers(0, 47, size // 4)   # every magnitude
    edges = [0, 1, -1, 2 ** 24, -(2 ** 24), 2 ** 24 - 1, 2 ** 47,
             -(2 ** 47), 2 ** 30, -(2 ** 30) - 5]
    v = np.concatenate([v, np.array(edges, np.int64)])
    hi = (v >> 24).astype(np.int32)
    lo = (v & ((1 << 24) - 1)).astype(np.int32)
    return v, hi, lo


def _apply(mod, op, hi, lo, hi2, lo2, s, pred, sign, exp, fmt_name):
    """One fixed-point op of ``mod`` (the JAX or the torch module) on the
    given limbs; returns the result's arrays."""
    conv = jnp.asarray if mod is jfx else t
    a = mod.FX(conv(hi), conv(lo))
    b = mod.FX(conv(hi2), conv(lo2))
    pos = mod.abs_(a)[1]
    if op == "canon":
        # a non-canonical lo (any int32 up to 2**28 either way)
        return list(mod.canon(conv(hi), conv(lo2 * 7 - (1 << 26))))
    if op == "add":
        return list(mod.add(a, b))
    if op == "neg":
        return list(mod.neg(a))
    if op == "abs_":
        sgn, mag = mod.abs_(a)
        return [sgn, *mag]
    if op == "mul_sign":
        return list(mod.mul_sign(conv(sign), a))
    if op == "_shr_unsigned":
        return list(mod._shr_unsigned(pos, conv(s)))
    if op == "_dropped_nonzero":
        return [mod._dropped_nonzero(pos, conv(s))]
    if op == "shr_trunc":
        return list(mod.shr_trunc(a, conv(s)))
    if op == "shr_floor":
        return list(mod.shr_floor(a, conv(s)))
    if op == "shl":
        small = mod.canon(conv(hi % 64), conv(lo))       # |V| < 2**30
        return [x for k in (0, 1, 7, 21, 23) for x in mod.shl(small, k)]
    if op == "shl_dyn":
        small = mod.canon(conv(hi % 64 - 32), conv(lo))
        return list(mod.shl_dyn(small, conv(s % 24), max_s=23))
    if op == "select":
        return list(mod.select(conv(pred), a, b))
    if op == "msb_index":
        return [mod.msb_index(pos)]
    if op == "_bit_at":
        return [mod._bit_at(pos, conv(s % 48))]
    if op == "round_to_fp":
        fmt = (jfp if mod is jfx else tfp).FORMATS[fmt_name]
        return [mod.round_to_fp(a, conv(exp), fmt)]
    raise ValueError(op)


@pytest.mark.parametrize("op", FX_OPS)
def test_fixedpoint_op_matches_reference(op):
    rng = np.random.default_rng(abs(hash(op)) % 2 ** 32)
    _, hi, lo = _fx_values(rng)
    _, hi2, lo2 = _fx_values(rng)
    n = hi.size
    s = rng.integers(0, 61, n).astype(np.int32)
    pred = rng.integers(0, 2, n).astype(bool)
    sign = rng.choice(np.array([-1, 1], np.int32), n)
    exp = rng.integers(-40, 21, n).astype(np.int32)
    for fmt_name in (("fp16", "fp32", "bf16") if op == "round_to_fp"
                     else ("fp32",)):
        got = _apply(tfx, op, hi, lo, hi2, lo2, s, pred, sign, exp, fmt_name)
        want = _apply(jfx, op, hi, lo, hi2, lo2, s, pred, sign, exp,
                      fmt_name)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{op} {fmt_name} output {i}")


def _value(a) -> np.ndarray:
    """The exact value hi * 2**24 + lo of a two-limb FX, as int64."""
    return a.hi.numpy().astype(np.int64) * (1 << 24) + a.lo.numpy()


class TestFixedPointValues:
    """The integer identities of ``tests/test_core_numerics.py``'s
    fixed-point cases, held on the port (the values there are hypothesis
    draws; here they are numpy draws over the same ranges)."""

    def test_add_and_shifts(self):
        rng = np.random.default_rng(2)
        v, hi, lo = _fx_values(rng)
        w, hi2, lo2 = _fx_values(rng)
        a = tfx.FX(t(hi), t(lo))
        r = tfx.add(a, tfx.FX(t(hi2), t(lo2)))
        np.testing.assert_array_equal(_value(r), v + w)
        s = rng.integers(0, 61, v.size)
        got = _value(tfx.shr_trunc(a, t(s.astype(np.int32))))
        want = [(abs(int(x)) >> int(k)) * (1 if x >= 0 else -1)
                for x, k in zip(v, s)]
        np.testing.assert_array_equal(got, want)
        got = _value(tfx.shr_floor(a, t(s.astype(np.int32))))
        np.testing.assert_array_equal(got, [int(x) >> int(k)
                                            for x, k in zip(v, s)])

    def test_shl(self):
        rng = np.random.default_rng(3)
        v = rng.integers(0, 2 ** 30, 256)
        a = tfx.canon(t((v >> 24).astype(np.int32)),
                      t((v & 0xFFFFFF).astype(np.int32)))
        for s in range(22):
            np.testing.assert_array_equal(_value(tfx.shl(a, s)), v << s)

    def test_round_to_fp_matches_python_oracle(self):
        rng = np.random.default_rng(4)
        v, hi, lo = _fx_values(rng, 300)
        v = v >> 1                                  # |v| <= 2**46
        exps = rng.integers(-40, 21, v.size)
        a = tfx.canon(t((v >> 24).astype(np.int32)),
                      t((v & 0xFFFFFF).astype(np.int32)))
        for name in ("fp16", "fp32"):
            got = tfx.round_to_fp(a, t(exps.astype(np.int32)),
                                  tfp.FORMATS[name]).numpy()
            for g, mag, e in zip(got, v, exps):
                want = exact_ref.round_value_to_fp(
                    -1 if mag < 0 else 1, abs(int(mag)), int(e) - 30, name)
                assert bits(np.asarray(g)) == bits(np.asarray(want)), \
                    (name, int(mag), int(e))


# --------------------------------------------------------------- nibbles


class TestNibble:
    def test_fp16_planes_every_finite_fp16(self):
        x = all_f16()
        s, _, m = jfp.decompose(jnp.asarray(x), jfp.FP16)
        got = tnib.fp16_planes(t(s), t(m))
        want = jnib.fp16_planes(s, m)
        for g, w in zip(got, want):
            assert_same(g, w)
        recon = got[2].double() * 2 ** 7 + got[1].double() * 2 ** 3 \
            + got[0].double() * 0.5
        np.testing.assert_array_equal(recon.numpy(),
                                      np.asarray(s * m, np.float64))

    def test_bf16_planes(self):
        mag = np.arange(256, dtype=np.int32)
        sign = np.where(mag % 3 == 0, -1, 1).astype(np.int32)
        for g, w in zip(tnib.bf16_planes(t(sign), t(mag)),
                        jnib.bf16_planes(jnp.asarray(sign), jnp.asarray(mag))):
            assert_same(g, w)

    @pytest.mark.parametrize("nbits", [4, 8, 12])
    def test_int_planes(self, nbits):
        x = np.arange(-(1 << (nbits - 1)), 1 << (nbits - 1), dtype=np.int32)
        got = tnib.int_planes(t(x), nbits)
        want = jnib.int_planes(jnp.asarray(x), nbits)
        assert len(got) == len(want) == nbits // 4
        for g, w in zip(got, want):
            assert_same(g, w)
        with pytest.raises(ValueError):
            tnib.int_planes(t(x), 6)

    def test_iteration_shifts_and_counts(self):
        for i in range(3):
            for j in range(3):
                assert tnib.fp16_iteration_shift(i, j) == \
                    jnib.fp16_iteration_shift(i, j)
                assert tnib.int_iteration_shift(i, j, 3, 3) == \
                    jnib.int_iteration_shift(i, j, 3, 3)
        for i in range(2):
            for j in range(2):
                assert tnib.bf16_iteration_shift(i, j) == \
                    jnib.bf16_iteration_shift(i, j)
        assert tnib.num_nibble_iterations(8, 12) == 6
        assert tnib.num_nibble_iterations(12, 12) == 9
        assert (tnib.FP16_GAMMA, tnib.BF16_GAMMA) == (jnib.FP16_GAMMA,
                                                      jnib.BF16_GAMMA)


# ------------------------------------------------------------------ EHU


class TestEHU:
    def test_run_with_padding(self):
        rng = np.random.default_rng(5)
        ea = rng.integers(-14, 16, (6, 4, 16)).astype(np.int32)
        eb = rng.integers(-14, 16, (6, 4, 16)).astype(np.int32)
        valid = rng.random((6, 4, 16)) < 0.8
        valid[0, 0] = False                       # an all-padding group
        for v in (None, valid):
            for p in (8, 16, 28):
                got = tehu.run(t(ea), t(eb), p,
                               None if v is None else t(v))
                want = jehu.run(jnp.asarray(ea), jnp.asarray(eb), p,
                                None if v is None else jnp.asarray(v))
                for g, w in zip(got, want):
                    assert_same(g, w)
        assert tehu.NEG_INF_EXP == jehu.NEG_INF_EXP

    def test_walkthrough_fig4(self):
        shift = t(np.array([0, 8, 7, 2], np.int32))
        active = torch.ones(4, dtype=torch.bool)
        assert int(tehu.num_cycles(shift, active, sp=5)) == 2
        cyc, local = tehu.service_schedule(shift, active, sp=5)
        np.testing.assert_array_equal(cyc.numpy(), [0, 1, 1, 0])
        np.testing.assert_array_equal(local.numpy(), [0, 3, 2, 2])

    def test_skip_empty_keeps_the_reference_count(self):
        """The reference's ``skip_empty`` count reduces the partition axis,
        so it counts active products (3 here), not the distinct occupied
        partitions (2): the port keeps its value."""
        shift = np.array([0, 1, 40], np.int32)
        active = np.ones(3, bool)
        got = tehu.num_cycles(t(shift), t(active), sp=5, skip_empty=True)
        want = jehu.num_cycles(jnp.asarray(shift), jnp.asarray(active),
                               sp=5, skip_empty=True)
        assert int(got) == int(want) == 3

    @pytest.mark.parametrize("skip_empty", [False, True])
    @pytest.mark.parametrize("sp", [1, 3, 5, 7, 19])
    def test_num_cycles_and_schedule(self, sp, skip_empty):
        rng = np.random.default_rng(sp)
        shift = rng.integers(0, 59, (5, 7, 16)).astype(np.int32)
        active = rng.random((5, 7, 16)) < 0.7
        active[0, 0] = False                      # nothing active: 1 cycle
        got = tehu.num_cycles(t(shift), t(active), sp, skip_empty=skip_empty)
        want = jehu.num_cycles(jnp.asarray(shift), jnp.asarray(active), sp,
                               skip_empty=skip_empty)
        assert_same(got, want)
        for g, w in zip(tehu.service_schedule(t(shift), t(active), sp),
                        jehu.service_schedule(jnp.asarray(shift),
                                              jnp.asarray(active), sp)):
            assert_same(g, w)
        assert_same(tehu.partition_index(t(shift), sp),
                    jehu.partition_index(jnp.asarray(shift), sp))


# ------------------------------------------------------------ IPUConfig


def test_ipu_config_properties_match_reference():
    for cfg in CONFIGS + [IPUConfig(operand="bf16"), IPUConfig(operand="tf32"),
                          IPUConfig(accum="bf16", sw_precision=12)]:
        ref = jcfg(cfg)
        for prop in ("precision", "sp", "mask_threshold",
                     "num_cycles_static", "num_planes"):
            assert getattr(cfg, prop) == getattr(ref, prop), prop
        assert tuple(cfg.accum_format) == tuple(ref.accum_format)
        assert tuple(cfg.operand_format) == tuple(ref.operand_format)
        assert cfg.iteration_pairs() == ref.iteration_pairs()
        assert [cfg.pre_shift(i, j) for i, j in cfg.iteration_pairs()] == \
            [ref.pre_shift(i, j) for i, j in ref.iteration_pairs()]
        assert cfg.plane_fn().__name__ == ref.plane_fn().__name__
    for bad in (dict(w=9), dict(accum="fp8"), dict(operand="int8"),
                dict(accum="bf16"), dict(rounding="even"),
                dict(n=64, w=28), dict(n=64, acc_l=20)):
        with pytest.raises(ValueError):
            IPUConfig(**bad)
        with pytest.raises(ValueError):
            jipu.IPUConfig(**bad)


def test_policy_takes_the_one_ipu_config():
    from repro_torch.core import policy
    import repro_torch.core as core
    assert policy.IPUConfig is tipu.IPUConfig is core.IPUConfig
    spec = policy.get_policy("fidelity_fp16_ipu").default
    assert spec.exact and spec.ipu == IPUConfig(n=16, w=16, accum="fp32")


# ----------------------------------------------- FP-IP vs JAX and oracle

CONFIGS = [
    IPUConfig(n=16, w=16, accum="fp16"),
    IPUConfig(n=16, w=16, accum="fp32"),
    IPUConfig(n=16, w=28, accum="fp32"),
    IPUConfig(n=8, w=12, accum="fp32"),
    IPUConfig(n=8, w=12, accum="fp32", multi_cycle=True),
    IPUConfig(n=16, w=16, accum="fp32", multi_cycle=True),
    IPUConfig(n=16, w=12, accum="fp16", multi_cycle=True),
    IPUConfig(n=16, w=16, accum="fp32", rounding="floor"),
    IPUConfig(n=16, w=20, accum="fp32", iter_order="desc"),
]


def _cfg_id(c):
    return (f"n{c.n}w{c.w}{c.accum}{'mc' if c.multi_cycle else ''}"
            f"{c.rounding[:2]}{c.iter_order[:1]}")


@pytest.mark.parametrize("cfg", CONFIGS, ids=_cfg_id)
@pytest.mark.parametrize("dist", ["normal", "wide"])
def test_fp_ip_matches_reference_and_oracle(cfg, dist):
    rng = np.random.default_rng(abs(hash((cfg.w, cfg.n, dist))) % 2 ** 32)
    # a batch of rows of 33 (three groups, the last one ragged) with a
    # row of zeros, one with subnormals and one with an all-zero group
    a = rand_fp16(rng, 8 * 33, dist=dist).reshape(8, 33)
    b = rand_fp16(rng, 8 * 33, dist=dist).reshape(8, 33)
    a[1] = 0
    a[2] = (rng.integers(-1023, 1024, 33) * 2.0 ** -24).astype(np.float16)
    b[3, :16] = 0
    a[4, :5] = -0.0
    got = tipu.fp16_inner_product(t(a), t(b), cfg)
    want = jipu.fp16_inner_product(jnp.asarray(a), jnp.asarray(b), jcfg(cfg))
    assert got.dtype == (torch.float16 if cfg.accum == "fp16"
                         else torch.float32)
    assert_same(got, want)
    for row in (0, 2, 3, 5):
        oracle = exact_ref.approx_fp_ip(a[row], b[row], jcfg(cfg))
        assert_same(got[row], np.asarray(oracle))
    # the raw accumulator (limbs and exponent) too
    acc, e = tipu.fp16_inner_product_raw(t(a[:, :5]), t(b[:, :5]), cfg)
    jacc, je = jipu.fp16_inner_product_raw(jnp.asarray(a[:, :5]),
                                           jnp.asarray(b[:, :5]), jcfg(cfg))
    for g, w in ((acc.hi, jacc.hi), (acc.lo, jacc.lo), (e, je)):
        assert_same(g, w)


def test_fp_ip_broadcast_and_batched_shapes():
    rng = np.random.default_rng(7)
    cfg = IPUConfig(n=16, w=16, accum="fp32")
    a = rand_fp16(rng, 4 * 3 * 40).reshape(4, 3, 40)
    b = rand_fp16(rng, 40)
    got = tipu.fp16_inner_product(t(a), t(b), cfg)
    assert got.shape == (4, 3)
    assert_same(got, jipu.fp16_inner_product(jnp.asarray(a), jnp.asarray(b),
                                             jcfg(cfg)))
    with pytest.raises(ValueError):
        tipu.fp16_inner_product(t(a[..., :0]), t(a[..., :0]), cfg)


@pytest.mark.parametrize("w", [12, 16, 28])
@pytest.mark.parametrize("dist", ["normal", "wide"])
def test_bf16_operands(w, dist):
    cfg = IPUConfig(n=16, w=w, accum="fp32", operand="bf16")
    rng = np.random.default_rng(abs(hash((w, dist))) % 2 ** 32)
    raw = [rand_fp16(rng, 6 * 33, dist=dist).astype(np.float32)
           for _ in range(2)]
    a, b = (np.asarray(jnp.asarray(r, jnp.bfloat16)).reshape(6, 33)
            for r in raw)
    ta, tb = (t(x.view(np.int16)).view(torch.bfloat16) for x in (a, b))
    got = tipu.fp16_inner_product(ta, tb, cfg)
    want = jipu.fp16_inner_product(jnp.asarray(a), jnp.asarray(b), jcfg(cfg))
    assert_same(got, want)
    for row in (0, 3):
        oracle = exact_ref.approx_fp_ip(a[row].astype(np.float32),
                                        b[row].astype(np.float32), jcfg(cfg))
        assert_same(got[row], np.asarray(oracle, np.float32))
    assert len(cfg.iteration_pairs()) == 4 and cfg.num_planes == 2


@pytest.mark.parametrize("w", [12, 16, 28])
def test_tf32_operands(w):
    cfg = IPUConfig(n=16, w=w, accum="fp32", operand="tf32")
    rng = np.random.default_rng(w)
    a, b = ((rng.normal(0, 1, (6, 33))
             * np.exp2(rng.integers(-20, 20, (6, 33)))).astype(np.float32)
            for _ in range(2))
    got = tipu.fp16_inner_product(t(a), t(b), cfg)
    want = jipu.fp16_inner_product(jnp.asarray(a), jnp.asarray(b), jcfg(cfg))
    assert_same(got, want)
    for row in (0, 4):
        oracle = exact_ref.approx_fp_ip(a[row], b[row], jcfg(cfg))
        assert_same(got[row], np.asarray(oracle, np.float32))
    for g, wt in zip(tipu._decompose_tf32(t(a)),
                     jipu._decompose_tf32(jnp.asarray(a))):
        assert_same(g, wt)


@pytest.mark.parametrize("a_bits,b_bits", [(4, 4), (8, 4), (8, 8), (8, 12),
                                           (12, 12)])
def test_int_inner_product(a_bits, b_bits):
    rng = np.random.default_rng(a_bits * 16 + b_bits)
    a = rng.integers(-(1 << (a_bits - 1)), 1 << (a_bits - 1),
                     (16, 64)).astype(np.int32)
    b = rng.integers(-(1 << (b_bits - 1)), 1 << (b_bits - 1),
                     (16, 64)).astype(np.int32)
    a[0, :3] = -(1 << (a_bits - 1))               # the extremes
    b[0, :3] = (1 << (b_bits - 1)) - 1
    got = tipu.int_inner_product(t(a), t(b), a_bits, b_bits)
    assert_same(got, jipu.int_inner_product(jnp.asarray(a), jnp.asarray(b),
                                            a_bits, b_bits))
    np.testing.assert_array_equal(got.numpy(),
                                  (a.astype(np.int64) * b).sum(-1))


def test_exact_fp32_baseline_on_exact_sums():
    """The f32 baseline on integer-valued inputs, whose f32 sums are exact
    in any order (so the two frameworks agree bit for bit)."""
    rng = np.random.default_rng(9)
    a = rng.integers(-64, 65, (5, 40)).astype(np.float16)
    b = rng.integers(-64, 65, (5, 40)).astype(np.float16)
    got = tipu.fp16_inner_product_exact_fp32(t(a), t(b))
    assert_same(got, jipu.fp16_inner_product_exact_fp32(jnp.asarray(a),
                                                        jnp.asarray(b)))


def test_accumulate_step_matches_reference():
    """One accumulator update over random states, both roundings, the
    fused matmul mode's negative pre-shift included."""
    rng = np.random.default_rng(10)
    v, hi, lo = _fx_values(rng, 400)
    hi, lo = hi >> 2, lo                          # |acc| < 2**46
    exp_acc = rng.integers(-40, 30, hi.size).astype(np.int32)
    exp_acc[:8] = jehu.NEG_INF_EXP
    max_c = rng.integers(-28, 31, hi.size).astype(np.int32)
    s_tree = rng.integers(-(2 ** 29), 2 ** 29, hi.size).astype(np.int32)
    for cfg in (IPUConfig(w=16), IPUConfig(w=28, rounding="floor"),
                IPUConfig(n=8, w=12)):
        for pre in (-1, 0, 4, 16):
            extra = rng.integers(0, 3, hi.size).astype(np.int32) * cfg.sp
            got = tipu.accumulate(tfx.FX(t(hi), t(lo)), t(exp_acc),
                                  t(s_tree), t(max_c), pre, t(extra), cfg)
            want = jipu.accumulate(jfx.FX(jnp.asarray(hi), jnp.asarray(lo)),
                                   jnp.asarray(exp_acc),
                                   jnp.asarray(s_tree), jnp.asarray(max_c),
                                   pre, jnp.asarray(extra), jcfg(cfg))
            for g, w in zip((*got[0], got[1]), (*want[0], want[1])):
                assert_same(g, w, f"{cfg} pre={pre}")


# ------------------------------------------------------------ Theorem 1


def test_error_bounds_match_reference():
    assert (tbounds.PAPER_CONSTANT, tbounds.TIGHT_CONSTANT) == \
        (jbounds.PAPER_CONSTANT, jbounds.TIGHT_CONSTANT)
    for i in range(3):
        for j in range(3):
            for p in (12, 28):
                for n in (1, 8, 16):
                    assert tbounds.iteration_bound(i, j, p, 10, n) == \
                        jbounds.iteration_bound(i, j, p, 10, n)
                    assert tbounds.tight_iteration_bound(i, j, p, -3, n) == \
                        jbounds.tight_iteration_bound(i, j, p, -3, n)
    assert tbounds.fp_ip_bound(16, 5, 16, acc_granularity_updates=9) == \
        jbounds.fp_ip_bound(16, 5, 16, acc_granularity_updates=9)
    assert tbounds.remark1_weights() == jbounds.remark1_weights()


finite_f16 = st.integers(min_value=0, max_value=0xFFFF).map(
    lambda b: np.uint16(b).view(np.float16)
).filter(lambda v: np.isfinite(v))


@given(st.lists(finite_f16, min_size=2, max_size=16),
       st.lists(finite_f16, min_size=2, max_size=16),
       st.sampled_from([12, 16, 20, 28]))
@settings(max_examples=80, deadline=None)
def test_theorem1_tight_bound_property(xs, ys, w):
    """Measured |approx - exact| <= the tight iteration bounds plus the
    accumulator-granularity slack, on the port's FP-IP."""
    n = min(len(xs), len(ys))
    a = np.zeros(16, np.float16)
    b = np.zeros(16, np.float16)
    a[:n] = xs[:n]
    b[:n] = ys[:n]
    cfg = IPUConfig(n=16, w=w, accum="fp32", sw_precision=w)
    got = Fraction(float(tipu.fp16_inner_product(t(a), t(b), cfg)))
    exact = exact_ref.exact_dot(a, b)
    max_exp = max(exact_ref.decompose_fp16(x)[1]
                  + exact_ref.decompose_fp16(y)[1] for x, y in zip(a, b))
    bound = tbounds.fp_ip_bound(w, max_exp, 16,
                                constant=tbounds.TIGHT_CONSTANT,
                                acc_granularity_updates=16)
    out_ulp = Fraction(2) ** (max_exp + 10 - 23)
    assert abs(got - exact) <= bound + out_ulp, (
        f"err={float(abs(got - exact))} bound={float(bound)}")
