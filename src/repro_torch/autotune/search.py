"""Plan search: cached score table -> greedy descent -> Pareto frontier
(the port's copy of ``repro/autotune/search.py``).

Every (projection group x candidate) score is one ``repro_torch.exp`` point
(content-addressed, shared across runs and job counts), so the search
itself is pure arithmetic over the table: re-running with a warm cache
executes zero simulator/model evaluations.

Search procedure:
  1. score all (group, candidate) pairs on the three axes;
  2. seed a plan pool with every *uniform* plan (one candidate
     everywhere) — the classic serving presets fall out as special
     cases;
  3. greedy ratio descent from the all-bf16 plan: repeatedly apply the
     single group-candidate swap with the best cycles-saved per unit
     accuracy-proxy cost, snapshotting every step — the trajectory
     traces the accuracy/performance curve;
  4. keep the non-dominated plans (minimize cycles, minimize accuracy
     proxy, maximize TOPS/W) as the frontier, and select the fastest
     plan whose accuracy proxy stays within budget (default: no worse
     than uniform INT8).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import exp
from repro_torch.autotune.candidates import Candidate, exact_for
from repro_torch.autotune.plan import PlanRule, PrecisionPlan
from repro_torch.models.registry import ProjGroup

_OBJ = "repro_torch.autotune.objectives"


@dataclasses.dataclass
class ScoreTable:
    """Merged per-(group, candidate) scores from the three objectives."""

    scores: Dict[Tuple[str, str], Dict]
    groups: Tuple[ProjGroup, ...]
    candidates: Tuple[Candidate, ...]

    def score(self, group: str, cand: Candidate) -> Dict:
        return self.scores[(group, cand.key())]


def _zip_axes(pairs: Sequence[Tuple[ProjGroup, Candidate]]) -> Dict:
    return {
        "group": [g.name for g, _ in pairs],
        "mode": [c.mode for _, c in pairs],
        "w": [c.w for _, c in pairs],
        "sw_precision": [c.sw_precision for _, c in pairs],
        "cluster": [c.cluster for _, c in pairs],
    }


def build_scores(arch: str, groups: Sequence[ProjGroup],
                 candidates: Sequence[Candidate],
                 engine: Optional[exp.EngineConfig] = None,
                 seq: int = 1, seed: int = 0, shapes: str = "full",
                 probe: bool = True) -> ScoreTable:
    """Evaluate (or fetch from cache) every group x candidate score."""
    engine = engine or exp.EngineConfig()
    pairs = [(g, c) for g in groups for c in candidates]
    fixed = {"arch": arch, "seq": seq, "seed": seed, "shapes": shapes}

    table: Dict[Tuple[str, str], Dict] = {
        (g.name, c.key()): {} for g, c in pairs}

    for sweep_name, fn, extra_fixed in (
            ("autotune_cycles", f"{_OBJ}:cycles_point", {}),
            ("autotune_efficiency", f"{_OBJ}:efficiency_point", {})):
        spec = exp.SweepSpec(name=sweep_name, fn=fn, mode="zip",
                             axes=_zip_axes(pairs),
                             fixed={**fixed, **extra_fixed})
        results, _ = exp.run_sweep(spec, engine)
        for (g, c), (_, value) in zip(pairs, results):
            table[(g.name, c.key())].update(value)

    # accuracy is cluster-independent: dedupe the hardware axis so the
    # (expensive) model probe runs once per (group, mode, w, P)
    acc_pairs: List[Tuple[ProjGroup, Candidate]] = []
    seen = set()
    for g, c in pairs:
        k = (g.name, c.mode, c.w, c.sw_precision)
        if k not in seen:
            seen.add(k)
            acc_pairs.append((g, c))
    axes = _zip_axes(acc_pairs)
    del axes["cluster"]
    # accuracy_point's key carries only (arch, seed, probe): the probe
    # shape is fixed, so seq/shapes must not fragment its cache entries
    spec = exp.SweepSpec(
        name="autotune_accuracy", fn=f"{_OBJ}:accuracy_point", mode="zip",
        axes=axes, fixed={"arch": arch, "seed": seed, "probe": probe})
    results, _ = exp.run_sweep(spec, engine)
    acc = {(g.name, c.mode, c.w, c.sw_precision): v
           for (g, c), (_, v) in zip(acc_pairs, results)}
    for g, c in pairs:
        table[(g.name, c.key())].update(
            acc[(g.name, c.mode, c.w, c.sw_precision)])

    return ScoreTable(table, tuple(groups), tuple(candidates))


# ---------------------------------------------------------------- metrics

Assignment = Dict[str, Candidate]   # group name -> candidate


def plan_metrics(table: ScoreTable, assign: Assignment) -> Dict:
    """Compose per-group scores into whole-plan metrics. Cycles and the
    accuracy proxy are additive; efficiency aggregates time-weighted
    (total MACs over total compute time across heterogeneous layers)."""
    cycles = ideal = acc = 0.0
    macs_tot = 0.0
    t_mm2 = t_w = 0.0   # sum of macs / per-layer TOPS (time in mm2/W form)
    for gname, cand in assign.items():
        s = table.score(gname, cand)
        cycles += s["cycles"]
        ideal += s["ideal_cycles"]
        acc += s["acc_proxy"]
        macs = float(s["macs"])
        macs_tot += macs
        t_mm2 += macs / s["tops_per_mm2"]
        t_w += macs / s["tops_per_w"]
    return {
        "cycles": cycles,
        "ideal_cycles": ideal,
        "acc_proxy": acc,
        "tops_per_mm2": macs_tot / t_mm2 if t_mm2 else 0.0,
        "tops_per_w": macs_tot / t_w if t_w else 0.0,
        "modes": {g: c.mode for g, c in sorted(assign.items())},
    }


# ----------------------------------------------------------------- search

def greedy_descent(table: ScoreTable, start: Assignment,
                   max_steps: int = 256) -> List[Assignment]:
    """Ratio-greedy: at each step apply the single swap with the best
    cycles-saved per accuracy cost (swaps that improve both always win).
    Returns the trajectory including the start point; every step strictly
    reduces total cycles, so termination is guaranteed."""
    traj = [dict(start)]
    cur = dict(start)
    for _ in range(max_steps):
        best = None   # (ratio_key, group, cand)
        for g in table.groups:
            s_cur = table.score(g.name, cur[g.name])
            for cand in table.candidates:
                if cand == cur[g.name]:
                    continue
                s = table.score(g.name, cand)
                d_cyc = s["cycles"] - s_cur["cycles"]
                if d_cyc >= 0:
                    continue
                d_acc = s["acc_proxy"] - s_cur["acc_proxy"]
                # strictly-improving swaps rank above any trade-off;
                # among trade-offs, maximize cycles saved per acc cost
                ratio = (float("inf") if d_acc <= 0
                         else -d_cyc / d_acc)
                key = (ratio, -d_cyc)
                if best is None or key > best[0]:
                    best = (key, g.name, cand)
        if best is None:
            break
        cur[best[1]] = best[2]
        traj.append(dict(cur))
    return traj


def pareto_front(plans: List[Dict]) -> List[Dict]:
    """Non-dominated filter: minimize cycles and acc_proxy, maximize
    TOPS/W. Ties collapse to the first occurrence."""
    def dominates(a, b):
        am, bm = a["metrics"], b["metrics"]
        no_worse = (am["cycles"] <= bm["cycles"]
                    and am["acc_proxy"] <= bm["acc_proxy"]
                    and am["tops_per_w"] >= bm["tops_per_w"])
        better = (am["cycles"] < bm["cycles"]
                  or am["acc_proxy"] < bm["acc_proxy"]
                  or am["tops_per_w"] > bm["tops_per_w"])
        return no_worse and better

    front = []
    for p in plans:
        if any(dominates(q, p) for q in plans):
            continue
        if any(q["assignment"] == p["assignment"] for q in front):
            continue
        front.append(p)
    return front


def _plan_record(name: str, table: ScoreTable, assign: Assignment) -> Dict:
    return {"name": name,
            "assignment": {g: c.key() for g, c in sorted(assign.items())},
            "metrics": plan_metrics(table, assign)}


def _rules_for(table: ScoreTable, assign: Assignment) -> Tuple[PlanRule, ...]:
    return tuple(
        PlanRule(group=g.name, pattern=g.pattern,
                 mode=assign[g.name].mode, w=assign[g.name].w,
                 sw_precision=assign[g.name].sw_precision,
                 cluster=assign[g.name].cluster,
                 exact=exact_for(assign[g.name].mode, assign[g.name].w),
                 group_size=assign[g.name].group_size)
        for g in table.groups)


def search_plan(arch: str, table: ScoreTable,
                acc_budget: Optional[float] = None,
                name: Optional[str] = None) -> PrecisionPlan:
    """Full search over a score table -> a PrecisionPlan artifact whose
    frontier holds every non-dominated assignment found."""
    pool: List[Dict] = []
    by_name: Dict[str, Assignment] = {}

    def add(pname: str, assign: Assignment):
        if assign in by_name.values():
            return
        by_name[pname] = dict(assign)
        pool.append(_plan_record(pname, table, assign))

    for cand in table.candidates:
        add(f"uniform_{cand.key()}",
            {g.name: cand for g in table.groups})

    bf16 = next((c for c in table.candidates if c.mode == "bf16"),
                table.candidates[0])
    traj = greedy_descent(table, {g.name: bf16 for g in table.groups})
    for i, assign in enumerate(traj[1:], 1):
        add(f"greedy_step{i}", assign)

    front = pareto_front(pool)
    front.sort(key=lambda p: p["metrics"]["cycles"])

    if acc_budget is None:
        # default budget: no less accurate than quantizing everything to
        # INT8 (the standard serving baseline); falls back to the median
        # frontier accuracy when INT8 isn't in the candidate set
        int8 = next((p for p in pool
                     if p["name"] == "uniform_int8"), None)
        if int8 is not None:
            acc_budget = int8["metrics"]["acc_proxy"]
        else:
            accs = sorted(p["metrics"]["acc_proxy"] for p in front)
            acc_budget = accs[len(accs) // 2]

    eligible = [p for p in front
                if p["metrics"]["acc_proxy"] <= acc_budget * (1 + 1e-9)]
    selected = (min(eligible, key=lambda p: p["metrics"]["cycles"])
                if eligible else
                min(front, key=lambda p: p["metrics"]["acc_proxy"]))
    assign = by_name[selected["name"]]

    return PrecisionPlan(
        name=name or f"{arch.replace('-', '_').replace('.', '_')}_auto",
        arch=arch,
        rules=_rules_for(table, assign),
        default_mode="bf16",
        metrics=selected["metrics"],
        frontier=tuple(front),
        meta={"selected_from": selected["name"],
              "acc_budget": acc_budget,
              "n_pool": len(pool),
              "n_groups": len(table.groups),
              "n_candidates": len(table.candidates)},
    )
