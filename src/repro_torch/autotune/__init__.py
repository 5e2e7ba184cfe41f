"""Autotune: the Pareto-frontier precision planner (mirror of
``repro/autotune``).

Closes the loop from the paper's three cost models to the serving
stack: enumerate per-layer precision candidates (``candidates``), score
them on cycles / area-power efficiency / accuracy through the cached
``repro_torch.exp`` engine (``objectives``; the accuracy probe runs on
the engine's device), search the joint space (``search``), and emit a
versioned :class:`PrecisionPlan` artifact (``plan``, the reference's
``precision-plan-v1`` JSON) that ``core.policy`` loads directly via
``precision_policy="plan:<file>"``.

CLI: ``python -m repro_torch.autotune {search,score,report,smoke}``.

Imports stay lazy (PEP 562) so cache-salt computation and plan loading
never pull the model stack.
"""
_LAZY = {
    "Candidate": "repro_torch.autotune.candidates",
    "default_candidates": "repro_torch.autotune.candidates",
    "MODES": "repro_torch.autotune.plan",
    "PLAN_SCHEMA": "repro_torch.autotune.plan",
    "PlanRule": "repro_torch.autotune.plan",
    "PrecisionPlan": "repro_torch.autotune.plan",
    "load_act_scales": "repro_torch.autotune.plan",
    "load_plan": "repro_torch.autotune.plan",
    "load_policy": "repro_torch.autotune.plan",
    "build_scores": "repro_torch.autotune.search",
    "search_plan": "repro_torch.autotune.search",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(name)
