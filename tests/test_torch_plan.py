"""``plan:`` policies in the port against the reference, on the CPU.

The committed plan (``results/plans/qwen2_0_5b.json``) and an fp plan
(fp8 with per-group scales, fp4) are read by both packages: the same
rules, the same (path, mode) for every projection path of
``reduced("qwen2-0.5b")`` and of the full model, and, served by each
package's engine with ``act_calibration="auto"`` over the bursty trace
of ``tests/_jax_reference.py``, the same act scales (the plan's own),
the same engine counters and EQUAL greedy streams (no tolerance: both
packages round to bf16 at the same places, as ``test_torch_serving.py``
holds for the preset policies).
"""
import dataclasses
import json
import os
import shutil

import pytest

from repro.autotune.plan import load_plan as ref_load_plan
from repro.core import policy as ref_policy_mod
from repro.models import registry as ref_registry
from repro.configs import get_config as ref_get_config
from repro_torch.autotune import plan as plan_mod
from repro_torch.autotune.plan import (PlanRule, PrecisionPlan,
                                       load_act_scales, load_plan)
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as policy_mod
from repro_torch.models import registry
from repro_torch.quant import calibrate
from repro_torch.serving import EngineConfig, Request, SamplingParams
from repro_torch.serving.engine import ServingEngine

from _jax_reference import (PLAN, PLAN_CONFIG, drive_trace, fp_plan_json)
from _torch_parity import one_intra_op_thread  # noqa: F401 (autouse)
from _torch_parity import reference

ARCH = "qwen2-0.5b"


@pytest.fixture(scope="module")
def ref():
    out = reference("plan")
    return out, params_from_numpy(out["params"], device="cpu")


def _greedy(rid, prompt, budget, stops):
    return Request(rid=rid, prompt=prompt, max_new_tokens=budget,
                   sampling=SamplingParams(stop_ids=stops))


def _plan_engine(params, path, **kw):
    cfg = dataclasses.replace(reduced(ARCH), precision_policy=f"plan:{path}")
    config = EngineConfig(**dict(PLAN_CONFIG, **kw))
    return ServingEngine(cfg, registry.build(cfg), params, config=config,
                         device="cpu")


def _fp_plan(tmp_path):
    groups = {g.name: g.pattern for g in registry.projection_groups(
        reduced(ARCH))}
    path = str(tmp_path / "fp_plan.json")
    with open(path, "w") as f:
        json.dump(fp_plan_json(groups), f)
    return path


def test_plan_reads_as_the_reference_reads_it(tmp_path):
    got, want = load_plan(PLAN), ref_load_plan(PLAN)
    assert got.to_json() == want.to_json()
    assert got.assignment() == want.assignment()
    assert load_act_scales(PLAN) == dict(want.act_scales)
    # both write the same file for the same plan
    a = got.save(str(tmp_path / "port.json"))
    b = want.save(str(tmp_path / "ref.json"))
    assert open(a, "rb").read() == open(b, "rb").read()
    assert PrecisionPlan.from_json(json.load(open(a))) == got


def test_plan_rules_give_the_reference_specs():
    rules = load_plan(PLAN).rules + (
        PlanRule("g", "x$", "fp16_ipu", w=12, sw_precision=20, exact=True),
        PlanRule("h", "y$", "fp8", group_size=32))
    for r in rules:
        ref_rule = type(ref_load_plan(PLAN).rules[0])(
            **dataclasses.asdict(r))
        got, want = r.spec(), ref_rule.spec()
        assert (got.mode, got.exact, got.group_size) \
            == (want.mode, want.exact, want.group_size)
        assert (None if got.ipu is None else dataclasses.asdict(got.ipu)) \
            == (None if want.ipu is None else dataclasses.asdict(want.ipu))
    with pytest.raises(ValueError, match="invalid plan mode"):
        PlanRule("g", "x", "int2")
    with pytest.raises(ValueError, match="group_size"):
        PlanRule("g", "x", "int8", group_size=0)
    with pytest.raises(ValueError, match="schema"):
        PrecisionPlan.from_json({"schema": "precision-plan-v0"})


@pytest.mark.parametrize("size", ["reduced", "full"])
def test_plan_routes_every_projection_path_as_the_reference(size):
    """Every container path of the model, through each package's
    ``projection_paths`` and its ``plan:`` policy, under
    ``trace_routing``: the same (path, mode) records in the same order.
    The plan's ``head`` rule matches no routed path of the tied head in
    either package."""
    cfg = get_config(ARCH) if size == "full" else reduced(ARCH)
    ref_cfg = ref_get_config(ARCH)
    if size == "reduced":
        from repro.configs import reduced as ref_reduced
        ref_cfg = ref_reduced(ARCH)
    containers = [f"blocks/b0/{p}" for p in (
        "attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/w_gate",
        "mlp/w_up", "mlp/w_down")] + ["embed", "final_norm"]
    name = f"plan:{PLAN}"
    pol = policy_mod.get_policy(name)
    ref_pol = ref_policy_mod.get_policy(name)
    got_paths = [registry.projection_paths(cfg)(c) for c in containers]
    want_paths = [ref_registry.projection_paths(ref_cfg)(c)
                  for c in containers]
    assert got_paths == want_paths
    with policy_mod.trace_routing() as got:
        for p in got_paths:
            if p is not None:
                pol.spec_for(p)
    with ref_policy_mod.trace_routing() as want:
        for p in want_paths:
            if p is not None:
                ref_pol.spec_for(p)
    assert got == want
    assert dict(got) == {
        "block/full/attn/wq": "int8", "block/full/attn/wk": "int8",
        "block/full/attn/wv": "int8", "block/full/attn/wo": "bf16",
        "block/mlp/w_gate": "int8", "block/mlp/w_up": "int8",
        "block/mlp/w_down": "int8"}


@pytest.mark.parametrize("case", ["committed", "fp"])
def test_plan_engine_matches_reference(ref, case, tmp_path):
    out, params = ref
    want = out["cases"][case]
    path = PLAN if case == "committed" else _fp_plan(tmp_path)
    eng, streams = drive_trace(lambda: _plan_engine(params, path),
                               _greedy, {})
    assert eng.routing_report() == want["routes"]
    assert eng.act_scales == want["scales"]
    assert eng.fused == want["fused"] is True
    assert eng.weight_bytes() == want["weight_bytes"]
    assert dict(eng.counters) == want["counters"]
    assert eng.counters["teacher_forced_tokens"] == 0    # chunked prefill
    assert streams == want["streams"]
    assert eng.staged_trace_count() == 0
    assert eng.weight_quant_trace_count() == 0


def test_fp_plan_prepares_fp_storage_without_act_scales(ref, tmp_path):
    """The fp plan resolves fused with no activation scales (the fp
    kernels need none): fp8 codes with per-group scales, packed fp4."""
    from repro_torch.quant.prepare import iter_projection_weights
    _, params = ref
    eng = _plan_engine(params, _fp_plan(tmp_path), act_calibration=None)
    assert eng.prepared and eng.fused and eng.act_scales is None
    kinds = {w.kind: w.scale_groups for _, w in iter_projection_weights(
        eng.params, registry.projection_paths(eng.cfg))
        if hasattr(w, "kind")}
    assert kinds == {"fp8": 64 // 8, "fp4_packed": 1}


def test_auto_takes_the_plans_scales_without_calibrating(ref, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a plan with scales ran a calibration pass")
    monkeypatch.setattr(calibrate, "calibrate_act_scales", refuse)
    _, params = ref
    eng = _plan_engine(params, PLAN)
    assert eng.act_scales == load_act_scales(PLAN)
    assert eng.metrics()["act_calibrated"]


def test_plan_without_scales_calibrates(ref, tmp_path, monkeypatch):
    calls = []
    real = calibrate.calibrate_act_scales

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(calibrate, "calibrate_act_scales", counted)
    _, params = ref
    bare = dataclasses.replace(load_plan(PLAN), act_scales={})
    path = bare.save(str(tmp_path / "bare.json"))
    eng = _plan_engine(params, path)
    assert len(calls) == 1
    assert set(eng.act_scales) == set(load_act_scales(PLAN))


def test_plan_policy_cached_on_path_and_mtime(tmp_path):
    path = str(tmp_path / "p.json")
    shutil.copy(PLAN, path)
    a = policy_mod.get_policy(f"plan:{path}")
    assert policy_mod.get_policy(f"plan:{path}") is a
    plan = dataclasses.replace(load_plan(path), default_mode="int4",
                               rules=())
    plan.save(path)
    os.utime(path, ns=(1, 10 ** 18))
    b = policy_mod.get_policy(f"plan:{path}")
    assert b is not a and b.default.mode == "int4"
    assert plan_mod.load_policy(path) is b


def test_running_engine_keeps_its_policy(ref, tmp_path):
    """A plan file rewritten, then deleted, after construction changes
    nothing the engine serves: it runs every forward under the policy it
    resolved (``core.policy.pinned_policy``)."""
    _, params = ref
    path = str(tmp_path / "p.json")
    shutil.copy(PLAN, path)
    base_eng, base = drive_trace(lambda: _plan_engine(params, PLAN),
                                 _greedy, {})
    eng = _plan_engine(params, path)
    routes = eng.routing_report()
    dataclasses.replace(load_plan(path), default_mode="int4",
                        rules=()).save(path)
    os.utime(path, ns=(1, 10 ** 18))
    assert eng.routing_report() == routes
    os.remove(path)
    assert eng.routing_report() == routes
    _, streams = drive_trace(lambda: eng, _greedy, {})
    assert streams == base
    with pytest.raises(FileNotFoundError):
        policy_mod.get_policy(f"plan:{path}")
