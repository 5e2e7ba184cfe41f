"""The port's quantization numerics against the JAX reference.

Every function here is integer or bit-field arithmetic (or a single
rounded f32 product), so the tolerance is zero: bit-equal to
``repro.quant.quantize`` / ``repro.kernels.ref`` on the same numpy
inputs, and the fp codecs bit-equal to the independent numpy oracle
``tools/fp_convert.py`` too.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.quant import quantize as jq
from repro_torch.kernels import ops as tops
from repro_torch.quant import quantize as tq

from _torch_parity import load_fp_convert

FORMATS = [("fp8", jq.FP8_E4M3, tq.FP8_E4M3),
           ("fp4", jq.FP4_E2M1, tq.FP4_E2M1)]


def _bits(a):
    """f32 array -> its uint32 bit patterns (so -0.0 != 0.0)."""
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_quantize_symmetric_bit_equal(bits, axis):
    rng = np.random.default_rng(bits * 10 + (axis or 0))
    x = rng.normal(0, 3, (17, 23)).astype(np.float32)
    jqv, js = jq.quantize_symmetric(jnp.asarray(x), bits, axis=axis)
    tqv, ts = tq.quantize_symmetric(torch.from_numpy(x), bits, axis=axis)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))


def test_quantize_symmetric_static_scale_ties():
    """A fixed scale puts exact .5 ties on the grid: both round half to
    even, and both saturate at [-128, 127]."""
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 1000.0, -1000.0, 0.0, -0.0],
                 np.float32)
    jqv, _ = jq.quantize_symmetric(jnp.asarray(x), 8, scale=1.0)
    tqv, _ = tq.quantize_symmetric(torch.from_numpy(x), 8, scale=1.0)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    assert tqv.tolist() == [0, 2, 2, 0, -2, 127, -128, 0, 0]


def test_calibrate_absmax_percentile():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (40, 9)).astype(np.float32)
    for pct, axis in [(1.0, None), (0.9, None), (0.99, 0)]:
        j = np.asarray(jq.calibrate_absmax(jnp.asarray(x), axis=axis,
                                           pct=pct))
        t = tq.calibrate_absmax(torch.from_numpy(x), axis=axis, pct=pct)
        # quantile interpolation may round differently by an ulp
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=0)


def test_fake_quant_forward_and_ste_gradient():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (6, 11)).astype(np.float32)
    w = rng.normal(0, 1, (6, 11)).astype(np.float32)
    for scale in (None, 0.013):
        jf = jq.fake_quant(jnp.asarray(x), 8, scale=scale)
        xt = torch.from_numpy(x.copy()).requires_grad_(True)
        tf = tq.fake_quant(xt, 8, scale=scale)
        np.testing.assert_array_equal(_bits(tf.detach().numpy()), _bits(jf))
        jg = jax.grad(lambda v: jnp.sum(
            jq.fake_quant(v, 8, scale=scale) * w))(jnp.asarray(x))
        (tf * torch.from_numpy(w)).sum().backward()
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(xt.grad.numpy(), w)   # identity STE


@pytest.mark.parametrize("name,jfmt,tfmt", FORMATS)
def test_fp_decode_every_code(name, jfmt, tfmt):
    fc = load_fp_convert()
    codes = np.arange(1 << tfmt.bits, dtype=np.uint8)
    t = tq.fp_decode(torch.from_numpy(codes), tfmt).numpy()
    j = np.asarray(jq.fp_decode(jnp.asarray(codes), jfmt))
    o = fc.decode(codes, fc.FORMATS[name])
    np.testing.assert_array_equal(_bits(t), _bits(j))
    np.testing.assert_array_equal(_bits(t), _bits(o))
    if name == "fp8":
        assert t[0x7F] == 480.0 and t[0xFF] == -480.0   # no NaN code


@pytest.mark.parametrize("name,jfmt,tfmt", FORMATS)
def test_fp_encode_edges_and_sweep(name, jfmt, tfmt):
    """-0.0, exact ties between grid points, saturation, subnormals and
    a random sweep: codes bit-equal to JAX and to the numpy oracle."""
    fc = load_fp_convert()
    grid = fc.decode_table(fc.FORMATS[name]).astype(np.float64)
    ties = ((grid[1:] + grid[:-1]) / 2).astype(np.float32)
    rng = np.random.default_rng(11)
    sweep = (rng.normal(0, 1, 4000) * np.exp2(rng.integers(-10, 10, 4000))
             ).astype(np.float32)
    x = np.concatenate([
        np.array([0.0, -0.0, tfmt.max, -tfmt.max, 10 * tfmt.max,
                  -10 * tfmt.max, 1e-30, -1e-30], np.float32),
        ties, -ties, grid.astype(np.float32), sweep])
    t = tq.fp_encode(torch.from_numpy(x), tfmt).numpy()
    j = np.asarray(jq.fp_encode(jnp.asarray(x), jfmt))
    o = fc.encode(x, fc.FORMATS[name])
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, o)
    assert t[1] == 1 << (tfmt.bits - 1)          # -0.0 keeps its sign bit


@pytest.mark.parametrize("name,jfmt,tfmt", FORMATS)
def test_fp_quantize_roundtrip(name, jfmt, tfmt):
    rng = np.random.default_rng(2)
    w = rng.normal(0, 1, (3, 32, 8)).astype(np.float32)
    jc, js = jq.fp_quantize(jnp.asarray(w), jfmt, axis=-2)
    tc, ts = tq.fp_quantize(torch.from_numpy(w), tfmt, axis=-2)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    np.testing.assert_array_equal(
        _bits(tq.fp_dequantize(tc, ts, tfmt).numpy()),
        _bits(jq.fp_dequantize(jc, js, jfmt)))


def test_int4_and_u4_pack_unpack():
    rng = np.random.default_rng(4)
    w = rng.integers(-8, 8, (2, 10, 7)).astype(np.int8)
    c = rng.integers(0, 16, (2, 10, 7)).astype(np.uint8)
    tp = tops.pack_int4(torch.from_numpy(w))
    jp = jops.pack_int4(jnp.asarray(w))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tops.unpack_int4(tp).numpy(), w)
    tu = tops.pack_u4(torch.from_numpy(c))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(
        jops.pack_u4(jnp.asarray(c))))
    # codes >= 8 survive the unsigned unpack (no sign extension)
    np.testing.assert_array_equal(tops.unpack_u4(tu).numpy(), c)
    np.testing.assert_array_equal(
        tops.unpack_int4(tp).numpy(),
        np.asarray(jops.unpack_int4(jp)))
    with pytest.raises(ValueError):
        tops.pack_int4(torch.zeros((3, 4), dtype=torch.int8))
