"""Prepared storage of the port against the JAX reference, on converted
weights of ``reduced("qwen2-0.5b")``.

Preparation is quantize + pack: integer and bit-field work with single
rounded f32 scales, so everything is compared bit-equal — kinds, stored
data, scales, act-scale leaves, dequantized values, staged operands and
``weight_resident_bytes``.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from repro.configs import reduced as jreduced
from repro.core import policy as jpolicy
from repro.models import registry as jregistry
from repro.quant import prepare as jprepare
from repro_torch.configs import reduced as treduced
from repro_torch.core import policy as tpolicy
from repro_torch.models import registry as tregistry
from repro_torch.quant import prepare as tprepare

from _torch_parity import f32, to_torch

ARCH = "qwen2-0.5b"


def _policy_pair(name, spec_kwargs=None):
    if spec_kwargs is None:
        return jpolicy.get_policy(name), tpolicy.get_policy(name)
    return (jpolicy.PrecisionPolicy(name, default=jpolicy.PrecisionSpec(
                **spec_kwargs)),
            tpolicy.PrecisionPolicy(name, default=tpolicy.PrecisionSpec(
                **spec_kwargs)))


POLICIES = [
    ("int8_serving", None), ("int4_serving", None), ("fidelity_int8", None),
    ("fp8_pc", dict(mode="fp8")), ("fp4_g16", dict(mode="fp4", group_size=16)),
    ("int4_g32", dict(mode="int4", group_size=32)),
]


@pytest.fixture(scope="module")
def setup():
    cfg = jreduced(ARCH)
    api = jregistry.build(cfg)
    jparams = api.init(jax.random.PRNGKey(0))
    return cfg, api, jparams, to_torch(jparams)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("name,spec", POLICIES)
def test_prepare_params_bit_equal(setup, name, spec):
    cfg, japi, jparams, tparams = setup
    jpol, tpol = _policy_pair(name, spec)
    paths = jregistry.projection_paths(cfg)
    scales = {p: 0.01 * (i + 1) for i, p in enumerate(sorted(
        {paths(k) for k, _ in jprepare.iter_projection_weights(
            jparams, paths)}))}
    jp = jprepare.prepare_params(jparams, jpol, paths, act_scales=scales)
    tp = tprepare.prepare_params(
        tparams, tpol, tregistry.projection_paths(treduced(ARCH)),
        act_scales=scales)
    jw = dict(jprepare.iter_projection_weights(jp, paths))
    tw = dict(tprepare.iter_projection_weights(
        tp, tregistry.projection_paths(treduced(ARCH))))
    assert set(jw) == set(tw) and len(tw) == 7
    for path, j in jw.items():
        t = tw[path]
        assert isinstance(t, tprepare.PreparedWeight) == isinstance(
            j, jprepare.PreparedWeight), path
        if not isinstance(j, jprepare.PreparedWeight):
            continue
        assert t.kind == j.kind, path
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
        np.testing.assert_array_equal(_bits(t.scale.numpy()), _bits(j.scale))
        np.testing.assert_array_equal(_bits(t.act_scale.numpy()),
                                      _bits(j.act_scale))
        np.testing.assert_array_equal(_bits(t.dequant().numpy()),
                                      _bits(j.dequant()))
    jb = jprepare.weight_resident_bytes(jp, paths)
    tb = tprepare.weight_resident_bytes(
        tp, tregistry.projection_paths(treduced(ARCH)))
    assert tb == jb


@pytest.mark.parametrize("name", ["int8_serving", "int4_serving"])
def test_stage_params_bit_equal(setup, name):
    cfg, _, jparams, tparams = setup
    jpol, tpol = _policy_pair(name)
    paths = jregistry.projection_paths(cfg)
    tpaths = tregistry.projection_paths(treduced(ARCH))
    jp = jprepare.prepare_params(jparams, jpol, paths)
    tp = tprepare.prepare_params(tparams, tpol, tpaths)
    with jprepare.count_staged() as jn:
        js = jprepare.stage_params(jp, jpol, paths)
    with tprepare.count_staged() as tn:
        ts = tprepare.stage_params(tp, tpol, tpaths)
    assert tn[0] == jn[0] == 7
    jw = dict(jprepare.iter_projection_weights(js, paths))
    for path, t in tprepare.iter_projection_weights(ts, tpaths):
        assert t.kind == jw[path].kind
        assert t.data.dtype == torch.bfloat16
        np.testing.assert_array_equal(f32(t.data), f32(jw[path].data))


def test_resident_bytes_contract(setup):
    """int4 packed storage is <= 1/6 of the raw fp32 projections (the
    serving smoke's contract), int8 ~ 1/4."""
    cfg, _, _, tparams = setup
    tpaths = tregistry.projection_paths(treduced(ARCH))
    raw = tprepare.weight_resident_bytes(tparams, tpaths)["projections"]
    for name, cap in (("int4_serving", 1 / 6), ("int8_serving", 0.3)):
        tp = tprepare.prepare_params(tparams, tpolicy.get_policy(name),
                                     tpaths)
        got = tprepare.weight_resident_bytes(tp, tpaths)
        assert got["projections"] <= cap * raw, (name, got, raw)
        assert set(got["by_kind"]) == (
            {"int4_packed"} if name == "int4_serving" else {"int8"})


def test_prepare_weight_odd_k_and_passthrough():
    rng = np.random.default_rng(0)
    w = rng.normal(0, 1, (2, 7, 5)).astype(np.float32)
    for mode, kind in (("int4", "int4"), ("fp4", "fp4"), ("int8", "int8"),
                       ("fp8", "fp8")):
        spec_j = jpolicy.PrecisionSpec(mode)
        spec_t = tpolicy.PrecisionSpec(mode)
        j = jprepare.prepare_weight(jax.numpy.asarray(w), spec_j)
        t = tprepare.prepare_weight(torch.from_numpy(w), spec_t)
        assert t.kind == j.kind == kind
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    raw = torch.from_numpy(w)
    assert tprepare.prepare_weight(raw, tpolicy.PrecisionSpec("bf16")) is raw
    t = tprepare.prepare_weight(raw, tpolicy.PrecisionSpec("int8"))
    assert tprepare.prepare_weight(t, tpolicy.PrecisionSpec("int8")) is t
    fp16 = tprepare.prepare_weight(raw, tpolicy.PrecisionSpec("fp16_ipu"))
    assert fp16.kind == "fp16" and fp16.data.dtype == torch.float16


def test_policies_route_like_the_reference():
    paths = ["block/full/attn/wq", "block/mlp/w_down", "lm_head", "router",
             "block/full/attn/wo", "embed"]
    plan = "plan:" + os.path.join(os.path.dirname(__file__), "..", "results",
                                  "plans", "qwen2_0_5b.json")
    for name in list(jpolicy.POLICIES) + [plan]:
        jp, tp = jpolicy.get_policy(name), tpolicy.get_policy(name)
        for p in paths:
            js, ts = jp.spec_for(p), tp.spec_for(p)
            assert (ts.mode, ts.exact, ts.group_size, ts.weight_bits) == (
                js.mode, js.exact, js.group_size, js.weight_bits), (name, p)
            if js.ipu is not None:
                assert dataclasses.asdict(ts.ipu) == dataclasses.asdict(js.ipu)
