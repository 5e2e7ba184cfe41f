"""The port's block-FP codec (``repro_torch.parallel.blockfp``) against
the JAX reference's (``repro.parallel.blockfp``), in process on the CPU,
and ``TrainConfig.compression`` where the reference refuses it.

* ``blockfp_quantize``: mantissas, exponents and length bit-equal for
  w = 2..8 over lengths that are not multiples of 256, on values spread
  over the whole f32 range with zeros, -0.0, subnormals and +-f32 max
  among them.
* ``blockfp_dequantize``: the port's scale is the exact power of two,
  so its values are ``np.ldexp(mant, exp - (w - 2))`` bit for bit, on
  the reference's own mantissas and exponents. The reference's scale is
  ``jnp.exp2`` of an integer-valued f32, which XLA computes inexactly
  (off by up to 4.05e-6 relative, and 0 at 2^-126 and below;
  ``ROADMAP.md`` §3): the two agree within ``DEQ_RTOL`` wherever the
  reference's scale is at least 2^-125.
* The reference's three ``TestBlockFPQuant`` properties hold on the
  port (``tests/test_blockfp.py``, which skips here without
  hypothesis).

The pod exchange itself runs on 8 gloo ranks in
``tests/test_torch_multidevice.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import AbstractMesh

from _hypothesis_compat import given, settings, st
from repro.launch import train as ref_train
from repro.parallel import blockfp as ref
from repro_torch.configs import reduced
from repro_torch.launch import train
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import registry
from repro_torch.parallel import blockfp

# port against reference dequantize, elementwise relative (see above)
DEQ_RTOL = 4.1e-6
MIN_REF_SCALE_EXP = -125
F32_MAX = float(np.finfo(np.float32).max)
SPECIALS = np.array([0.0, -0.0, 1e-45, -1e-45, 1.1754942e-38, -3e-39,
                     F32_MAX, -F32_MAX, 2.0 ** -126, 1.0, -1.0, 2.0 ** 127],
                    np.float32)


def _values(n: int, seed: int) -> np.ndarray:
    """n f32 values: magnitudes 2^-149..2^127 (log-uniform, so blocks
    mix small and large exponents), random signs, with the specials
    planted and an all-zero run where there is room."""
    rng = np.random.default_rng(seed)
    e = rng.uniform(-149, 127.99, n)
    x = (np.sign(rng.standard_normal(n)) * np.exp2(e)).astype(np.float32)
    k = min(n, len(SPECIALS))
    x[rng.choice(n, k, replace=False)] = SPECIALS[:k]
    if n > 600:
        x[300:556] = 0.0
    return x


def _port_q(x, w):
    m, e, n = blockfp.blockfp_quantize(torch.from_numpy(x), w)
    return m.numpy(), e.numpy(), n


def _ref_q(x, w):
    m, e, n = ref.blockfp_quantize(jnp.asarray(x), w)
    return np.asarray(m), np.asarray(e), n


def _assert_quantize_equal(x, w):
    pm, pe, pn = _port_q(x, w)
    rm, re_, rn = _ref_q(x, w)
    assert pn == rn == x.size
    assert pm.dtype == rm.dtype == np.int8
    assert pe.dtype == re_.dtype == np.int8
    np.testing.assert_array_equal(pm, rm)
    np.testing.assert_array_equal(pe, re_)


@given(st.integers(2, 8), st.integers(1, 3000).filter(lambda n: n % 256),
       st.integers(0, 2 ** 31))
@settings(max_examples=25, deadline=None)
def test_quantize_bit_equal_to_reference(w, n, seed):
    _assert_quantize_equal(_values(n, seed), w)


@pytest.mark.parametrize("w", range(2, 9))
def test_quantize_specials_bit_equal_to_reference(w):
    """Blocks of only zeros and -0.0, only subnormals, f32 max beside
    tiny values, and a ragged tail."""
    sub = np.arange(1, 257, dtype=np.int32).view(np.float32)
    mixed = np.resize(SPECIALS, 256)
    x = np.concatenate([np.zeros(128, np.float32),
                        -np.zeros(128, np.float32), sub, -sub[::-1],
                        mixed, SPECIALS[:5]]).astype(np.float32)
    _assert_quantize_equal(x, w)


@pytest.mark.parametrize("w", range(2, 9))
def test_dequantize_is_exact_ldexp_and_near_reference(w):
    # blocks each of one magnitude, the blocks spread over the f32 range
    rng = np.random.default_rng(100 + w)
    levels = np.repeat(np.linspace(-148, 124, 12), 256)
    x = (rng.standard_normal(levels.size) * np.exp2(levels)).astype(
        np.float32)
    x = np.concatenate([x, _values(700, w)])
    rm, re_, n = _ref_q(x, w)
    got = blockfp.blockfp_dequantize(
        torch.from_numpy(rm.astype(np.int32)), torch.from_numpy(re_.copy()),
        n, w, x.shape).numpy()
    exps = re_.astype(np.int32) - (w - 2)
    want = np.ldexp(rm.astype(np.int32).reshape(len(re_), -1)
                    .astype(np.float32), exps[:, None]).astype(np.float32)
    want = want.reshape(-1)[:n]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    theirs = np.asarray(ref.blockfp_dequantize(
        jnp.asarray(rm, jnp.int32), jnp.asarray(re_), n, w, x.shape))
    scale_exp = np.repeat(exps, 256)[:n]
    keep = (scale_exp >= MIN_REF_SCALE_EXP) & (want != 0)
    assert keep.sum() > 100
    rel = np.abs(got - theirs)[keep] / np.abs(want)[keep]
    assert rel.max() <= DEQ_RTOL, rel.max()


def test_pow2_is_exact_over_the_f32_range():
    e = torch.arange(-149, 128, dtype=torch.int32)
    got = blockfp.pow2(e).numpy()
    want = np.ldexp(np.float32(1), e.numpy()).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# tests/test_blockfp.py::TestBlockFPQuant on the port

def test_roundtrip_error_bounded():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0, 1, 5000).astype(np.float32))
    m, e, n = blockfp.blockfp_quantize(x, 8)
    y = blockfp.blockfp_dequantize(m.to(torch.int32), e, n, 8, x.shape)
    # per-block error < 1 ULP of block scale = 2**(max_e - 6)
    blocks = x[: (5000 // 256) * 256].numpy().reshape(-1, 256)
    scale = 2.0 ** (e[:len(blocks)].numpy().astype(np.int32) - 6)
    err = np.abs(y.numpy()[: len(blocks) * 256].reshape(-1, 256) - blocks)
    assert (err <= scale[:, None] * 1.0001).all()


@given(st.integers(2, 8))
@settings(max_examples=7, deadline=None)
def test_width_sweep_monotone(w):
    rng = np.random.default_rng(w)
    x = torch.from_numpy(rng.normal(0, 1, 2048).astype(np.float32))
    m, e, n = blockfp.blockfp_quantize(x, w)
    y = blockfp.blockfp_dequantize(m.to(torch.int32), e, n, w, x.shape)
    err_w = float((y - x).abs().max())
    w2 = min(w + 1, 8)
    m2, e2, n2 = blockfp.blockfp_quantize(x, w2)
    y2 = blockfp.blockfp_dequantize(m2.to(torch.int32), e2, n2, w2, x.shape)
    assert float((y2 - x).abs().max()) <= err_w * 1.0001


def test_exact_on_powers_of_two():
    x = torch.tensor([1.0, 0.5, 2.0, -1.0] * 64, dtype=torch.float32)
    m, e, n = blockfp.blockfp_quantize(x, 8)
    y = blockfp.blockfp_dequantize(m.to(torch.int32), e, n, 8, x.shape)
    assert torch.equal(y, x)


@pytest.mark.parametrize("w", (1, 9))
def test_quantize_refuses_widths_outside_2_to_8(w):
    with pytest.raises(ValueError):
        blockfp.blockfp_quantize(torch.zeros(4), w)


# TrainConfig.compression

POD_MESH = ((2, 2, 2), ("pod", "data", "model"))


def test_compression_raises_on_a_pod_mesh_as_the_reference():
    api = registry.build(reduced("qwen2-0.5b"))
    with pytest.raises(NotImplementedError) as port:
        train.make_train_step(api, train.TrainConfig(compression="blockfp8"),
                              abstract_mesh(*POD_MESH))
    with pytest.raises(NotImplementedError) as theirs:
        ref_train.make_train_step(
            None, AbstractMesh(*POD_MESH),
            ref_train.TrainConfig(compression="blockfp8"))
    assert str(port.value) == str(theirs.value)


@pytest.mark.parametrize("mesh", (None, ((1, 1), ("data", "model")),
                                  ((2, 4), ("data", "model"))))
def test_compression_changes_nothing_off_a_pod_mesh(mesh):
    """Off a pod mesh (and without one) the field is read nowhere: the
    step builds, and on one device its loss and state equal the
    ``"none"`` step's bit for bit."""
    cfg = reduced("qwen2-0.5b")
    api = registry.build(cfg)
    tc = train.TrainConfig(compression="blockfp8")
    if mesh is not None:
        train.make_train_step(api, tc, abstract_mesh(*mesh))
        return
    state = train.init_state(api, seed=0, device="cpu")
    batch = registry.materialize_batch(
        cfg, registry.InputShape("t", 16, 2, "train"), device="cpu")
    a, ma = train.make_train_step(api, tc)(state, batch)
    b, mb = train.make_train_step(api, train.TrainConfig())(state, batch)
    assert float(ma["loss"]) == float(mb["loss"])
    from repro_torch.optim.tree import tree_leaves
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))
