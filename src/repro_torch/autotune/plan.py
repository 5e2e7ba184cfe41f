"""PrecisionPlan — the serializable artifact the planner searches for
(the port's copy of ``repro/autotune/plan.py``).

A plan is a complete per-layer precision assignment for one
architecture: an ordered list of (projection-group pattern -> candidate)
rules plus a default, exactly the shape
:class:`repro_torch.core.policy.PrecisionPolicy` consumes —
``to_policy()`` is a pure translation, so a plan searched offline is
what serves traffic (``precision_policy="plan:<file>"``).

The JSON schema is versioned and shared with the reference package: a
plan file either package writes, the other reads. Besides the selected
assignment, the artifact carries the searched Pareto frontier and the
calibrated activation scales the plan was searched with.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Any, Dict, Tuple

from repro_torch.core.ipu import IPUConfig
from repro_torch.core.policy import PrecisionPolicy, PrecisionSpec

PLAN_SCHEMA = "precision-plan-v1"

MODES = ("bf16", "fp32", "int8", "int4", "fp8", "fp4", "fp16_ipu")


@dataclasses.dataclass(frozen=True)
class PlanRule:
    """One plan entry: a projection-group pattern and its candidate.

    ``w``/``sw_precision``/``cluster`` describe the MC-IPU configuration
    the candidate was scored on; only fp16_ipu rules carry them into the
    executed PrecisionSpec (INT modes need no alignment hardware).
    ``group_size`` (int/fp storage modes) selects per-group weight
    scales — K/group_size scale groups along the contraction dim —
    threaded into the PrecisionSpec; None keeps per-out-channel scales.
    (``group`` is the projection-group *name*, not related.)
    """

    group: str
    pattern: str
    mode: str
    w: int = 16
    sw_precision: int = 28
    cluster: int = 1
    exact: bool = False
    group_size: Any = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"invalid plan mode {self.mode!r} "
                             f"(want one of {MODES})")
        if self.group_size is not None and int(self.group_size) < 1:
            raise ValueError(f"group_size must be positive, got "
                             f"{self.group_size}")

    def spec(self) -> PrecisionSpec:
        if self.mode == "fp16_ipu":
            return PrecisionSpec(
                "fp16_ipu", exact=self.exact,
                ipu=IPUConfig(n=16, w=max(self.w, 10),
                              sw_precision=self.sw_precision))
        gs = None if self.group_size is None else int(self.group_size)
        return PrecisionSpec(self.mode, exact=self.exact, group_size=gs)


@dataclasses.dataclass(frozen=True)
class PrecisionPlan:
    """A versioned, serializable per-layer precision assignment."""

    name: str
    arch: str
    rules: Tuple[PlanRule, ...] = ()
    default_mode: str = "bf16"
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)
    frontier: Tuple[Dict[str, Any], ...] = ()
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # calibrated static activation scales {runtime policy path -> f32
    # scale}: a plan searched offline ships its own calibration, and
    # serving engines resolving the plan consume the scales via
    # ``act_calibration="auto"``
    act_scales: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.default_mode not in MODES:
            raise ValueError(f"invalid default mode {self.default_mode!r}")

    def assignment(self) -> Dict[str, str]:
        """group name -> mode (compact summary for reports)."""
        return {r.group: r.mode for r in self.rules}

    def to_policy(self) -> PrecisionPolicy:
        """The executable policy: first-match-wins rules in plan order,
        unmatched paths fall through to the default spec."""
        return PrecisionPolicy(
            name=self.name,
            rules=tuple((r.pattern, r.spec()) for r in self.rules),
            default=PrecisionSpec(self.default_mode),
        )

    # ------------------------------------------------------ serialization

    def to_json(self) -> Dict[str, Any]:
        return {
            "schema": PLAN_SCHEMA,
            "name": self.name,
            "arch": self.arch,
            "default_mode": self.default_mode,
            "rules": [dataclasses.asdict(r) for r in self.rules],
            "metrics": self.metrics,
            "frontier": list(self.frontier),
            "meta": self.meta,
            "act_scales": dict(self.act_scales),
        }

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "PrecisionPlan":
        schema = obj.get("schema")
        if schema != PLAN_SCHEMA:
            raise ValueError(
                f"unsupported plan schema {schema!r} (want {PLAN_SCHEMA})")
        return cls(
            name=obj["name"],
            arch=obj["arch"],
            rules=tuple(PlanRule(**r) for r in obj["rules"]),
            default_mode=obj.get("default_mode", "bf16"),
            metrics=obj.get("metrics", {}),
            frontier=tuple(obj.get("frontier", [])),
            meta=obj.get("meta", {}),
            act_scales=obj.get("act_scales", {}),
        )

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        return path


def load_plan(path: str) -> PrecisionPlan:
    with open(path) as f:
        return PrecisionPlan.from_json(json.load(f))


@functools.lru_cache(maxsize=64)
def _load_policy_cached(path: str, mtime_ns: int) -> PrecisionPolicy:
    return load_plan(path).to_policy()


def load_policy(path: str) -> PrecisionPolicy:
    """Plan file -> policy, cached on (path, mtime) so a per-forward
    ``get_policy`` resolution never re-reads the file."""
    apath = os.path.abspath(path)
    return _load_policy_cached(apath, os.stat(apath).st_mtime_ns)


def load_act_scales(path: str) -> Dict[str, float]:
    """Calibrated activation scales carried by a plan artifact (empty
    when the plan was searched without calibration)."""
    return dict(load_plan(path).act_scales)
