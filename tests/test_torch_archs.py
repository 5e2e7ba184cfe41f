"""The rest of the lm family against the JAX reference, on the CPU.

``gemma2-9b``, ``glm4-9b``, ``stablelm-12b``, ``mixtral-8x7b`` and
``qwen3-moe-30b-a3b``. Between them they exercise every dense branch
that qwen2-0.5b leaves out (local/global attention with its ring
buffer, softcaps, zero-centered RMSNorm, post norms, GeGLU, a query
scale, partial rotary, LayerNorm, QK-norm, untied heads) and the MoE
layer (``layers.moe``) inside the model.

* Configs: each ported ``get_config`` (and its ``reduced``) equals the
  reference's field for field.
* Forward: for ``reduced()`` of each arch under ``bf16``,
  ``int8_serving`` and ``int4_serving``, with both executor variants,
  the same checks as ``tests/test_torch_lm.py`` (prefill logits and
  caches, a chunked prefill into live caches, three decode steps) on
  the reference's converted weights and calibrated scales.
* Calibration: the port's scales equal the reference's computed op by
  op (``jax.disable_jit``). Jitted, the reference's can differ: for
  stablelm under ``int8_serving`` its ``block/mlp/w_gate`` and
  ``w_up`` scales are one bf16 ulp of the input absmax lower (XLA
  rewrites the LayerNorm's f32 arithmetic, and a last-ulp change flips
  the bf16 rounding of the largest input). The forward and serving
  checks take the jitted scales on both sides.
* Serving: the port's ``ServingEngine`` serves the bursty trace of
  ``tests/_jax_reference.py`` under ``int4_serving`` (calibrated,
  fused) with greedy streams EQUAL to the reference engine's, at
  decode_block 1 and 4, for mixtral, qwen3-moe and gemma2.

The reference runs once per arch, each in its own subprocess, all side
by side (``_torch_parity.references``).

Tolerances are those of ``tests/test_torch_lm.py``: logits 1e-5
absolute (|logit| < 5 here; the largest difference seen is 1e-6, f32
summation order), K and V caches within one bf16 ulp, calibrated scales
and streams exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.core.policy import get_policy
from repro_torch.models import registry
from repro_torch.quant.calibrate import calibrate_act_scales
from repro_torch.serving import EngineConfig, Request, SamplingParams
from repro_torch.serving.engine import ServingEngine

from _jax_reference import (ARCH_POLICIES, ARCHS, SERVED_ARCHS,
                            SERVED_BLOCKS, STOPS, calib_prompts,
                            drive_trace)
from _torch_parity import one_intra_op_thread  # noqa: F401 (autouse)
from _torch_parity import check_lm_case, references

LOGIT_ATOL = 1e-5
MOE_ARCHS = tuple(a for a in ARCHS if get_config(a).moe)


@pytest.fixture(scope="module")
def refs():
    out = references("arch", ARCHS)
    return {a: (o, params_from_numpy(o["params"], device="cpu"))
            for a, o in out.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_the_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        ref_get_config(arch))
    assert dataclasses.asdict(reduced(arch)) == dataclasses.asdict(
        ref_reduced(arch))


@pytest.mark.parametrize("variant", [None, "fused"])
@pytest.mark.parametrize("policy", ARCH_POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(refs, arch, policy, variant):
    out, params = refs[arch]
    case = out["cases"][(policy, variant)]
    cfg = dataclasses.replace(reduced(arch), precision_policy=policy)
    api = registry.build(cfg)
    prepared = api.prepare(params, get_policy(policy),
                           act_scales=case["scales"])
    check_lm_case(api, prepared, variant, case, LOGIT_ATOL)


@pytest.mark.parametrize("policy", ("int8_serving", "int4_serving"))
@pytest.mark.parametrize("arch", ARCHS)
def test_calibrated_scales_match_reference(refs, arch, policy):
    out, params = refs[arch]
    cfg = dataclasses.replace(reduced(arch), precision_policy=policy)
    got = calibrate_act_scales(cfg, registry.build(cfg), params,
                               prompts=calib_prompts(), device="cpu")
    assert got == out["eager_scales"][policy]
    # the experts ride bf16 einsums, not mp_linear: nothing calibrates
    # them, in the reference too
    assert "block/moe/experts" not in got


@pytest.mark.parametrize("arch", ARCHS)
def test_init_keeps_the_reference_tree(refs, arch):
    """``lm.init`` (MoE included) builds the reference's tree: the same
    paths, shapes and dtypes (the router in f32)."""
    out, _ = refs[arch]
    mine = _flatten(to_numpy(registry.init_params(reduced(arch), seed=1,
                                                  device="cpu")))
    theirs = _flatten(out["params"])
    assert mine.keys() == theirs.keys()
    for k, v in theirs.items():
        assert (mine[k].shape, mine[k].dtype) == (v.shape, v.dtype), k
    if get_config(arch).moe:
        assert mine["blocks/b0/moe/router/w"].dtype == np.float32
        assert "blocks/b0/mlp/w_up/w" not in mine


_RUNS = {}


def _greedy(rid, prompt, budget, stops):
    return Request(rid=rid, prompt=prompt, max_new_tokens=budget,
                   sampling=SamplingParams(stop_ids=stops))


def _serve(refs, arch, blk):
    if (arch, blk) not in _RUNS:
        out, params = refs[arch]
        cfg = dataclasses.replace(reduced(arch),
                                  precision_policy="int4_serving")
        config = EngineConfig(
            batch_slots=2, cache_len=64, prefill_chunk=4, decode_block=blk,
            act_calibration=out["cases"][("int4_serving", None)]["scales"])
        _RUNS[(arch, blk)] = drive_trace(
            lambda: ServingEngine(cfg, registry.build(cfg), params,
                                  config=config, device="cpu"),
            _greedy, STOPS)
    return _RUNS[(arch, blk)]


@pytest.mark.parametrize("blk", SERVED_BLOCKS)
@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_engine_streams_match_reference(refs, arch, blk):
    want = refs[arch][0]["serving"][blk]
    eng, streams = _serve(refs, arch, blk)
    assert streams == want["streams"]
    assert dict(eng.counters) == want["counters"]
    assert eng.counters["teacher_forced_tokens"] == 0    # chunked prefill
    assert eng.fused == want["fused"] is True
    assert eng.weight_quant_trace_count() == want["weight_quant"] == 0
    assert eng.act_quant_trace_count() == want["act_quant"] == 0


@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_engine_streams_invariant_to_decode_block(refs, arch):
    assert _serve(refs, arch, 1)[1] == _serve(refs, arch, 4)[1]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_blocked_allows_moe_experts_uncovered(refs, arch):
    """Mirror of ``tests/test_serving.py::
    test_blocked_allows_moe_experts_uncovered``: the expert stacks take
    no calibrated act scale (no ``mp_linear`` call reads one), and the
    blocked engine's dynamic-fake-quant guard exempts them."""
    _, params = refs[arch]
    cfg = dataclasses.replace(reduced(arch), precision_policy="int8_serving")
    api = registry.build(cfg)
    scales = calibrate_act_scales(cfg, api, params, device="cpu")
    assert "block/moe/experts" not in scales
    eng = ServingEngine(cfg, api, params, config=EngineConfig(
        batch_slots=2, cache_len=32, decode_block=4, act_calibration=scales),
        device="cpu")
    assert eng.act_quant_trace_count() == 0
    assert eng.weight_quant_trace_count() == 0
    # the uncalibrated dense projections are still refused
    with pytest.raises(ValueError, match="per-slot-independent"):
        ServingEngine(cfg, api, params, config=EngineConfig(
            batch_slots=2, cache_len=32, decode_block=4), device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prepared_expert_stacks_are_4d_per_expert(refs, arch):
    """Under the stacked group axis an expert stack is (n_groups, E, K,
    N): int4 packs K into K/2 and scales one per expert and out-channel;
    ``PreparedWeight.index`` takes one group's (E, K, N)."""
    _, params = refs[arch]
    cfg = reduced(arch)
    prepared = registry.build(cfg).prepare(params,
                                           get_policy("int4_serving"))
    w = prepared["blocks"]["b0"]["moe"]["w_gate"]["w"]
    raw = params["blocks"]["b0"]["moe"]["w_gate"]["w"]
    g, e, k, n = raw.shape
    assert w.kind == "int4_packed" and w.act_scale is None
    assert tuple(w.data.shape) == (g, e, k // 2, n)
    assert tuple(w.scale.shape) == (g, e, 1, n)
    assert torch.equal(w.index(g - 1).dequant(), w.dequant()[g - 1])


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, p))
        else:
            out[p] = np.asarray(v)
    return out
