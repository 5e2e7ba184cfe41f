"""The precision plan artifact (mirror of ``repro/autotune``).

``plan`` reads and writes the reference's ``precision-plan-v1`` JSON
and turns it into a serving policy (``precision_policy="plan:<file>"``);
``objectives.analytic_proxy`` is the accuracy axis the router's cost
model shares with the planner. The planner's search and CLI are not
ported yet.
"""
from repro_torch.autotune.plan import (MODES, PLAN_SCHEMA,  # noqa: F401
                                       PlanRule, PrecisionPlan,
                                       load_act_scales, load_plan,
                                       load_policy)
