"""The port's multi-replica router against the reference, on the CPU.

Three replicas (the committed plan, ``bf16``, ``int4_serving``) built by
each package's ``build_replicas`` on the same converted weights: the
same static costs (``==``, weight bytes included), and one fixed request
sequence (``tests/_jax_reference.py::router_requests``, the router
stepped after every second submission) routed to the SAME replica,
request by request, under all three strategies, with EQUAL greedy
streams. Then the reference's router cases (``tests/test_serving.py``)
on the port: tags, round robin, draining, validation, online cost
correction under injected stats and under a fake clock, and
``replica_cost`` for every projection group of every family.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.core.policy import get_policy as ref_get_policy
from repro.serving.router import replica_cost as ref_replica_cost
from repro_torch.autotune.plan import PlanRule, PrecisionPlan
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import get_policy
from repro_torch.models.registry import projection_groups
from repro_torch.serving import EngineConfig, Request
from repro_torch.serving.router import (_CANDIDATE_PATHS, Replica, Router,
                                        build_replicas, replica_cost)

from _jax_reference import (PLAN, ROUTER_POLICIES, ROUTER_STRATEGIES,
                             drive_router)
from _torch_parity import one_intra_op_thread  # noqa: F401 (autouse)
from _torch_parity import ARCHS, port_config, reference

ARCH = "qwen2-0.5b"
CONFIG = EngineConfig(batch_slots=2, cache_len=64, prefill_chunk=4)


@pytest.fixture(scope="module")
def ref():
    out = reference("router")
    return out, params_from_numpy(out["params"], device="cpu")


def _fleet(params, policies=ROUTER_POLICIES, config=CONFIG):
    return build_replicas(reduced(ARCH), policies, params=params,
                          config=config, device="cpu")


@pytest.fixture(scope="module")
def two_replicas(ref):
    base = dataclasses.replace(reduced(ARCH), precision_policy="bf16")
    return build_replicas(base, ("int8_serving", "bf16"), params=ref[1],
                          config=EngineConfig(batch_slots=2, cache_len=32),
                          device="cpu")


def _request(rid, prompt, budget, tags):
    return Request(rid=rid, prompt=prompt, max_new_tokens=budget, tags=tags)


def test_replica_costs_equal_the_reference(ref):
    out, params = ref
    reps = _fleet(params)
    assert {r.name: r.cost for r in reps} == out["costs"]
    assert [r.name for r in reps] == ["plan:qwen2_0_5b", "bf16",
                                      "int4_serving"]


@pytest.mark.parametrize("strategy", ROUTER_STRATEGIES)
def test_fixed_sequence_routes_as_the_reference(ref, strategy):
    out, params = ref
    want = out["strategies"][strategy]
    router = Router(_fleet(params), strategy=strategy)
    chosen, streams = drive_router(router, _request)
    assert chosen == want["chosen"]
    assert router.routing_counters() == want["counters"]
    assert streams == want["streams"]
    if strategy == "plan_aware":
        tagged = [c for (i, c) in enumerate(chosen) if i % 3 == 0]
        assert set(tagged) == {"bf16"}


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("policy", ["int8_serving", "int4_serving", "bf16",
                                    "fp32", "fidelity_int8", f"plan:{PLAN}"])
def test_replica_cost_equals_the_reference(size, policy):
    cfg = (get_config if size == "full" else reduced)(ARCH)
    ref_cfg = (ref_get_config if size == "full" else ref_reduced)(ARCH)
    cfg = dataclasses.replace(cfg, precision_policy=policy)
    ref_cfg = dataclasses.replace(ref_cfg, precision_policy=policy)
    assert replica_cost(cfg, get_policy(policy)) \
        == ref_replica_cost(ref_cfg, ref_get_policy(policy))


def test_fp16_ipu_plan_cost_equals_the_reference(tmp_path):
    """An fp16_ipu plan rule carries its sw_precision into the spec, so
    the cost model scores it. The ``fidelity_fp16_ipu`` and
    ``paper_hybrid`` presets leave ``IPUConfig.sw_precision`` unset, and
    the reference's ``replica_cost`` raises TypeError on them; the port
    keeps that behaviour rather than score them differently."""
    groups = {g.name: g.pattern for g in projection_groups(get_config(ARCH))}
    plan = PrecisionPlan("ipu", ARCH, rules=(
        PlanRule("attn_qkv", groups["attn_qkv"], "fp16_ipu", w=12,
                 sw_precision=20),
        PlanRule("ffn_out", groups["ffn_out"], "int4", group_size=32)))
    path = plan.save(str(tmp_path / "ipu.json"))
    name = f"plan:{path}"
    cfg = dataclasses.replace(get_config(ARCH), precision_policy=name)
    ref_cfg = dataclasses.replace(ref_get_config(ARCH), precision_policy=name)
    assert replica_cost(cfg, get_policy(name)) \
        == ref_replica_cost(ref_cfg, ref_get_policy(name))
    for preset in ("fidelity_fp16_ipu", "paper_hybrid"):
        with pytest.raises(TypeError):
            ref_replica_cost(ref_cfg, ref_get_policy(preset))
        with pytest.raises(TypeError):
            replica_cost(cfg, get_policy(preset))


@pytest.mark.parametrize("arch", ARCHS)
def test_replica_cost_covers_every_group(arch):
    """Every projection group resolves to a policy mode, for every family
    (a pattern no candidate path matches would drop a group), and the
    costs equal the reference's."""
    ref_cfg = ref_reduced(arch)
    for g in projection_groups(port_config(ref_cfg)):
        assert any(re.search(g.pattern, p) for p in _CANDIDATE_PATHS), \
            (arch, g.name)
    for policy in ("int8_serving", "bf16", f"plan:{PLAN}"):
        assert replica_cost(port_config(ref_cfg), get_policy(policy)) \
            == ref_replica_cost(ref_cfg, ref_get_policy(policy))


class TestRouter:
    def test_cost_model_orders_replicas(self, two_replicas):
        int8, bf16 = two_replicas
        assert int8.cost["cycles_per_token"] < bf16.cost["cycles_per_token"]
        assert bf16.cost["acc_proxy"] < int8.cost["acc_proxy"]
        assert int8.cost["tops_per_w"] > 0 and bf16.cost["tops_per_w"] > 0
        assert int8.cost["weight_bytes"]["projections"] \
            < bf16.cost["weight_bytes"]["projections"]

    def test_plan_aware_routes_by_tag(self, two_replicas):
        router = Router(two_replicas, strategy="plan_aware")
        cheap = router.route(Request(rid=0, prompt=np.zeros(4, np.int32)))
        accurate = router.route(Request(rid=1, prompt=np.zeros(4, np.int32),
                                        tags=("accuracy",)))
        assert cheap.name == "int8_serving"
        assert accurate.name == "bf16"

    def test_round_robin_alternates(self, two_replicas):
        router = Router(two_replicas, strategy="round_robin")
        names = [router.route(Request(rid=i, prompt=np.zeros(4, np.int32)))
                 .name for i in range(4)]
        assert names == ["int8_serving", "bf16", "int8_serving", "bf16"]

    def test_mixed_workload_drains_and_counts(self, two_replicas):
        router = Router(two_replicas, strategy="plan_aware")
        rng = np.random.default_rng(1)
        reqs = [Request(rid=i, prompt=rng.integers(0, 512, 5, dtype=np.int32),
                        max_new_tokens=2,
                        tags=("accuracy",) if i % 2 else ())
                for i in range(6)]
        for r in reqs:
            router.submit(r)
        router.run_until_drained()
        assert len(router.completed) == 6
        counters = router.routing_counters()
        assert sum(counters.values()) >= 6
        assert all(n > 0 for n in counters.values()), counters
        rep = router.report()
        assert rep["strategy"] == "plan_aware"
        assert set(rep["replicas"]) == {"int8_serving", "bf16"}
        for r in rep["replicas"].values():
            assert r["metrics"]["device"] == "cpu"
            assert set(r["cost"]) >= {"cycles_per_token", "acc_proxy",
                                      "tops_per_w", "weight_bytes"}

    def test_invalid_strategy_and_empty(self, two_replicas):
        with pytest.raises(ValueError):
            Router(two_replicas, strategy="nope")
        with pytest.raises(ValueError):
            Router([])
        with pytest.raises(ValueError, match="cost_correction"):
            Router(two_replicas, cost_correction="maybe")
        with pytest.raises(ValueError, match="online_blend"):
            Router(two_replicas, online_blend=1.5)

    def test_online_cost_correction_shifts_routing(self, two_replicas):
        """A statically cheap replica that MEASURES slow loses traffic
        under online correction; static costing cannot see it."""
        int8, bf16 = two_replicas
        static = Router(two_replicas, cost_correction="static")
        online = Router(two_replicas, cost_correction="online")
        req = Request(rid=0, prompt=np.zeros(4, np.int32))
        saved = (int8.engine.stats.tok_per_s, bf16.engine.stats.tok_per_s)
        try:
            int8.engine.stats.tok_per_s = None
            bf16.engine.stats.tok_per_s = None
            assert static.route(req).name == "int8_serving"
            assert online.route(req).name == "int8_serving"
            int8.engine.stats.tok_per_s = 1.0     # became 100x slower
            bf16.engine.stats.tok_per_s = 100.0
            assert static.route(req).name == "int8_serving"
            assert online.route(req).name == "bf16"
            rep = online.routing_report()
            assert rep["cost_correction"] == "online"
            r8, rb = rep["replicas"]["int8_serving"], rep["replicas"]["bf16"]
            assert r8["static_cycles_per_token"] \
                < rb["static_cycles_per_token"]
            assert rb["effective_cost"] < r8["effective_cost"]
            assert r8["measured"]["tok_per_s"] == 1.0
        finally:
            int8.engine.stats.tok_per_s, bf16.engine.stats.tok_per_s = saved


def test_online_correction_under_a_fake_clock(ref):
    """Engines measure their own tok/s on a fake clock: the int8 replica
    is made to take 100x longer a tick, and once both have served, the
    router set up with ``cost_correction="online"`` on the engines
    routes untagged traffic to bf16, where static costing keeps int8."""
    _, params = ref
    base = dataclasses.replace(reduced(ARCH), precision_policy="bf16")
    reps = build_replicas(base, ("int8_serving", "bf16"), params=params,
                          config=EngineConfig(batch_slots=2, cache_len=32,
                                              cost_correction="online"),
                          device="cpu")
    for rep, tick in zip(reps, (1.0, 0.01)):
        now = [0.0]

        def clock(now=now, tick=tick):
            now[0] += tick
            return now[0]
        rep.engine.clock = clock
    router = Router(reps, strategy="round_robin")
    assert router.cost_correction == "online"
    rng = np.random.default_rng(2)
    for i in range(4):
        router.submit(Request(rid=i, prompt=rng.integers(0, 512, 5,
                                                         dtype=np.int32),
                              max_new_tokens=4))
    router.run_until_drained()
    assert all(r.stats.measured for r in reps)
    assert reps[0].stats.tok_per_s < reps[1].stats.tok_per_s
    req = Request(rid=9, prompt=np.zeros(4, np.int32))
    assert Router(reps).route(req).name == "bf16"
    assert Router(reps, cost_correction="static").route(req).name \
        == "int8_serving"


def test_build_replicas_defaults_and_names(ref):
    _, params = ref
    reps = build_replicas(reduced(ARCH), ["bf16", "bf16", f"plan:{PLAN}"],
                          params=params, device="cpu")
    assert [r.name for r in reps] == ["bf16", "bf16#1", "plan:qwen2_0_5b"]
    assert all(r.engine.cache_len == 128 for r in reps)
    assert isinstance(reps[0], Replica) and reps[0].cost_correction == \
        "static"
    seeded = build_replicas(reduced(ARCH), ["bf16"], device="cpu")
    from repro_torch.models import registry
    want = registry.init_params(reduced(ARCH), 0, "cpu")
    assert torch.equal(seeded[0].engine.params["embed"]["w"],
                       want["embed"]["w"])
    with pytest.raises(TypeError):
        build_replicas(reduced(ARCH), ["bf16"], params=params,
                       device="cpu", batch_slots=2)
