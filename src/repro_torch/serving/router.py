"""Multi-replica routing: each replica serves its own precision plan
(the port's copy of ``repro/serving/router.py``).

The routing layer the paper's heterogeneity argument calls for: mixed
precision only pays off when the runtime sends each request to the right
datapath. A :class:`Replica` wraps one ``ServingEngine`` whose config
carries its own ``precision_policy`` (a preset name or a searched
``plan:<file>`` artifact). The :class:`Router` places requests across
replicas under one of three strategies:

  * ``plan_aware`` (default) — a static cost model scores every replica
    from ``core.simulator`` cycles and ``core.area_power`` efficiency
    under the replica's *actual* per-projection policy: requests tagged
    ``"accuracy"`` go to the replica with the lowest accuracy proxy
    (e.g. the bf16 replica), everything else to the replica with the
    cheapest load-discounted cycles/token (e.g. the int8 replica).
  * ``least_loaded`` — min (active slots + waiting) / slots.
  * ``round_robin`` — the baseline.

**Measured-cost feedback** (``cost_correction="online"``): the static
simulator estimate cannot see a replica that *became* slow — a noisy
neighbor, thermal throttling, a bigger co-resident batch. Every engine
publishes measured :class:`repro_torch.obs.ReplicaStats` (EWMA tok/s, queue
depth, p95 TTFT), and the online mode blends the measured
seconds-per-token into the static cycles score: both are normalized by
their fleet mean (unit-free), then mixed with weight ``online_blend``
on the measured term. Replicas without a throughput sample yet fall
back to their static score, so cold fleets route exactly like
``"static"``. ``routing_report()`` shows static, measured and
effective side by side.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence

from repro_torch.configs import ModelConfig
from repro_torch.core import area_power as ap
from repro_torch.core import simulator as sim
from repro_torch.core.policy import PrecisionPolicy, PrecisionSpec
from repro_torch.core.workloads import ConvLayer
from repro_torch.models.registry import projection_groups
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import Request, ServingEngine

# workload datatype of each policy mode on the MC-IPU tile; bf16/fp32
# projections run the FP16 datapath at full alignment width
_MODE_TYPES = {"int4": sim.INT4, "int8": sim.INT8, "fp16_ipu": sim.FP16,
               "bf16": sim.FP16, "fp32": sim.FP16}

# literal parameter paths covering every projection-group pattern of the
# model zoo (see registry.projection_groups): the cost model resolves a
# policy's mode per group by matching the group pattern against these
_CANDIDATE_PATHS = (
    "block/full/attn/wq", "block/full/attn/wk", "block/full/attn/wv",
    "block/full/attn/wo", "block/swa/attn/wq", "block/swa/attn/wo",
    "block/mlp/w_gate", "block/mlp/w_up", "block/mlp/w_down",
    "block/moe/experts",
    "block/mix/w_r", "block/mix/w_o", "block/mix/c_key",
    "block/rec/w_in_rnn", "block/rec/w_out",
    "projector/fc1", "lm_head",
)


def _spec_width(spec: PrecisionSpec) -> int:
    if spec.ipu is not None:
        return max(spec.ipu.w, 10)
    # bf16/fp32 model the wide-adder FP16 path (never multi-cycles);
    # fp16_ipu without an explicit IPU config uses the paper's w=16
    return 38 if spec.mode in ("bf16", "fp32") else 16


def replica_cost(cfg: ModelConfig, policy: PrecisionPolicy,
                 seed: int = 0) -> Dict[str, float]:
    """Static per-token cost of serving ``cfg`` under ``policy``.

    Sums ``core.simulator`` cycles of every projection group at its
    policy-routed precision (one decode token), MAC-weights
    ``core.area_power`` TOPS/W across groups, and carries the additive
    analytic accuracy proxy the autotune planner searches on — the three
    axes plan-aware routing trades off.
    """
    from repro_torch.autotune.objectives import analytic_proxy
    cycles = ideal = 0.0
    macs_total = 0
    seconds_per_watt = 0.0   # sum over groups of macs / (TOPS/W)
    acc = 0.0
    for g in projection_groups(cfg):
        path = next((p for p in _CANDIDATE_PATHS if re.search(g.pattern, p)),
                    None)
        spec = policy.spec_for(path) if path else policy.default
        types = _MODE_TYPES[spec.mode]
        w = _spec_width(spec)
        sw = spec.ipu.sw_precision if spec.ipu is not None else 28
        tile = dataclasses.replace(sim.BIG_TILE, adder_w=w, cluster_size=1,
                                   sw_precision=sw)
        layer = ConvLayer(g.name, c=g.d_in, k=g.d_out, ho=1, wo=1, r=1,
                          s=1, count=g.count)
        stats = sim.simulate_network([layer], tile, types,
                                     sim.FORWARD_SOURCE, seed=seed)
        cycles += stats.cycles
        ideal += stats.ideal_cycles
        design = ap.IPUDesign(
            f"route_{spec.mode}_w{w}", mult_a=4, mult_b=4, adder_w=w,
            fp_support=True, tile=tile, cluster_size=1,
            fp_mc_factor=stats.slowdown)
        _, tops_w = ap.efficiency(design, types)
        macs_total += g.macs_per_token
        seconds_per_watt += g.macs_per_token / max(tops_w, 1e-9)
        acc += analytic_proxy(spec.mode, w, sw)
    return {
        "cycles_per_token": cycles,
        "ideal_cycles_per_token": ideal,
        "tops_per_w": macs_total / max(seconds_per_watt, 1e-9),
        "acc_proxy": acc,
    }


@dataclasses.dataclass
class Replica:
    """One serving engine + its precision policy and routing counters.

    The attribute surface the :class:`Router` reads is deliberately
    narrow — ``name``/``cost``/``routed``/``load``/``stats``/
    ``cost_correction`` plus ``submit``/``has_pending``/``step``/
    ``completed``/``metrics`` — so a replica does NOT have to hold its
    engine in-process (the reference's fabric implements the same
    protocol over a transport; not ported yet).
    """

    name: str
    policy_name: str
    engine: ServingEngine
    cost: Dict[str, float] = dataclasses.field(default_factory=dict)
    routed: int = 0

    @property
    def load(self) -> float:
        """Occupancy estimate: (active slots + waiting) / slots."""
        eng = self.engine
        active = sum(r is not None for r in eng.slot_req)
        return (active + len(eng.scheduler)) / max(eng.b, 1)

    @property
    def stats(self):
        """Measured :class:`repro_torch.obs.ReplicaStats` the online cost
        correction blends in."""
        return self.engine.stats

    @property
    def cost_correction(self) -> str:
        """How this replica asks to be costed ('static' | 'online')."""
        return self.engine.config.cost_correction

    def submit(self, req: Request) -> None:
        self.engine.submit(req)

    def has_pending(self) -> bool:
        return self.engine.has_pending()

    def step(self) -> None:
        self.engine.step()

    @property
    def completed(self) -> Dict[int, Request]:
        return self.engine.completed

    def metrics(self) -> Dict:
        return self.engine.metrics()


def _replica_name(policy_name: str) -> str:
    if policy_name.startswith("plan:"):
        stem = os.path.splitext(os.path.basename(policy_name[5:]))[0]
        return f"plan:{stem}"
    return policy_name


def build_replicas(cfg: ModelConfig, policy_names: Sequence[str],
                   params=None, config: Optional[EngineConfig] = None,
                   device=None) -> List[Replica]:
    """One replica per policy/plan ref, initialized from a single raw
    parameter set (``registry.init_params(cfg, 0, device)`` when
    ``params`` is None). Each engine *prepares* its own storage copy
    from its policy at construction (quant.prepare): the int4 replica
    holds packed nibbles + scales, the bf16 replica the raw tree — so
    the per-replica ``cost['weight_bytes']`` genuinely differ.

    ``config`` is the shared :class:`~repro_torch.serving.config.
    EngineConfig` every replica runs under (default
    ``EngineConfig(cache_len=128)``). The engines run on ``device``
    (CUDA unless ``device="cpu"``; without CUDA that default raises).
    The reference's legacy flat engine kwargs have no path in the port's
    engine: passing them raises ``TypeError``."""
    from repro_torch.device import resolve_device
    from repro_torch.models import registry
    device = resolve_device(device)
    if config is None:
        config = EngineConfig(cache_len=128)
    replicas: List[Replica] = []
    names: Dict[str, int] = {}
    for pname in policy_names:
        rcfg = dataclasses.replace(cfg, precision_policy=pname)
        api = registry.build(rcfg)
        if params is None:
            params = registry.init_params(rcfg, 0, device)
        engine = ServingEngine(rcfg, api, params, config=config,
                               device=device)
        name = _replica_name(pname)
        if name in names:           # duplicate policies stay addressable
            names[name] += 1
            name = f"{name}#{names[name]}"
        else:
            names[name] = 0
        cost = replica_cost(rcfg, engine.policy)
        cost["weight_bytes"] = engine.weight_bytes()
        replicas.append(Replica(name=name, policy_name=pname,
                                engine=engine, cost=cost))
    return replicas


class Router:
    """Places requests on replicas and drives their engines to drain."""

    STRATEGIES = ("plan_aware", "least_loaded", "round_robin")

    def __init__(self, replicas: Sequence[Replica],
                 strategy: str = "plan_aware",
                 cost_correction: Optional[str] = None,
                 online_blend: float = 0.75):
        if not replicas:
            raise ValueError("router needs at least one replica")
        if strategy not in self.STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r} "
                             f"(want one of {self.STRATEGIES})")
        if cost_correction is None:
            # inherit the fleet's declaration: one replica asking for
            # online correction turns it on for the whole cost ranking
            # (a partially-measured fleet degrades gracefully — see
            # _effective_costs)
            cost_correction = "online" if any(
                r.cost_correction == "online"
                for r in replicas) else "static"
        if cost_correction not in ("static", "online"):
            raise ValueError(f"cost_correction must be 'static' or "
                             f"'online', got {cost_correction!r}")
        if not 0.0 <= online_blend <= 1.0:
            raise ValueError(f"online_blend must be in [0, 1], got "
                             f"{online_blend}")
        self.replicas = list(replicas)
        self.strategy = strategy
        self.cost_correction = cost_correction
        self.online_blend = online_blend
        self._rr = 0

    def _effective_costs(self) -> List[float]:
        """Unit-free cost score per replica, lower is better.

        Static cycles/token and measured seconds/token (1 / EWMA tok/s)
        live in different units, so each is normalized by its mean over
        the replicas it exists for; ``online`` blends the two with
        weight ``online_blend`` on the measured term. Unmeasured
        replicas (no throughput sample yet) keep their static score —
        a cold fleet routes exactly like ``cost_correction="static"``.
        """
        static = [r.cost.get("cycles_per_token", 0.0)
                  for r in self.replicas]
        s_mean = sum(static) / len(static)
        s_norm = [s / s_mean if s_mean > 0 else 1.0 for s in static]
        if self.cost_correction != "online":
            return s_norm
        spt = [1.0 / r.stats.tok_per_s
               if r.stats.measured and r.stats.tok_per_s > 0
               else None
               for r in self.replicas]
        measured = [v for v in spt if v is not None]
        if not measured:
            return s_norm
        m_mean = sum(measured) / len(measured)
        w = self.online_blend
        return [(1.0 - w) * sn + w * (v / m_mean) if v is not None
                else sn
                for sn, v in zip(s_norm, spt)]

    def route(self, req: Request) -> Replica:
        if self.strategy == "round_robin":
            rep = self.replicas[self._rr % len(self.replicas)]
            self._rr += 1
            return rep
        if self.strategy == "least_loaded":
            return min(enumerate(self.replicas),
                       key=lambda ir: (ir[1].load, ir[0]))[1]
        # plan_aware: accuracy-tagged traffic takes the most accurate
        # datapath; the rest takes the cheapest (possibly
        # measurement-corrected) cost score, discounted by load so a
        # hot replica spills onto the others
        idx = range(len(self.replicas))
        if "accuracy" in req.tags:
            return min(zip(idx, self.replicas),
                       key=lambda ir: (ir[1].cost.get("acc_proxy", 0.0),
                                       ir[1].load, ir[0]))[1]
        costs = self._effective_costs()
        return min(zip(idx, self.replicas),
                   key=lambda ir: (costs[ir[0]] * (1.0 + ir[1].load),
                                   ir[0]))[1]

    def submit(self, req: Request) -> Replica:
        rep = self.route(req)
        rep.routed += 1
        rep.submit(req)
        return rep

    # ---------------------------------------------------------- execution

    def has_pending(self) -> bool:
        return any(r.has_pending() for r in self.replicas)

    def step(self) -> bool:
        stepped = False
        for rep in self.replicas:
            if rep.has_pending():
                rep.step()
                stepped = True
        return stepped

    def run_until_drained(self, max_ticks: int = 10_000) -> int:
        ticks = 0
        while self.has_pending():
            self.step()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError("router did not drain")
        return ticks

    # ------------------------------------------------------ observability

    @property
    def completed(self) -> Dict[int, Request]:
        out: Dict[int, Request] = {}
        for rep in self.replicas:
            out.update(rep.completed)
        return out

    def routing_counters(self) -> Dict[str, int]:
        return {rep.name: rep.routed for rep in self.replicas}

    def routing_report(self) -> Dict:
        """The cost ranking as the router sees it right now: static
        simulator estimate, measured replica stats, and the effective
        (possibly blended) score ``route()`` ranks non-accuracy traffic
        by — the ablation surface for online vs static correction."""
        costs = self._effective_costs()
        return {
            "cost_correction": self.cost_correction,
            "online_blend": self.online_blend,
            "replicas": {
                rep.name: {
                    "static_cycles_per_token":
                        rep.cost.get("cycles_per_token", 0.0),
                    "measured": rep.stats.snapshot(),
                    "effective_cost": costs[i],
                    "load": rep.load,
                    "routed": rep.routed,
                } for i, rep in enumerate(self.replicas)
            },
        }

    def report(self) -> Dict:
        """Per-replica routing counters, cost model, and engine metrics."""
        return {
            "strategy": self.strategy,
            "cost_correction": self.cost_correction,
            "routing": self.routing_report()["replicas"],
            "replicas": {
                rep.name: {
                    "policy": rep.policy_name,
                    "routed": rep.routed,
                    "cost": dict(rep.cost),
                    "metrics": rep.metrics(),
                } for rep in self.replicas
            },
        }
