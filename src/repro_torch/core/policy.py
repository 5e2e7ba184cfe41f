"""Per-layer mixed-precision policy (mirror of ``repro/core/policy.py``).

A PrecisionPolicy maps parameter paths (regex over 'block/attn/wq'-style
names) to a PrecisionSpec; ``layers.mplinear`` routes each projection's
matmul by its spec's mode. The presets are the reference's;
``"plan:<file>"`` loads an autotune plan artifact
(``repro_torch.autotune.plan``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

from repro_torch.core.ipu import IPUConfig

_ROUTING_TRACE: Optional[List[Tuple[str, str]]] = None


@contextlib.contextmanager
def trace_routing():
    """Record every (path, mode) the active policies route while open."""
    global _ROUTING_TRACE
    records: List[Tuple[str, str]] = []
    prev = _ROUTING_TRACE
    _ROUTING_TRACE = records
    try:
        yield records
    finally:
        _ROUTING_TRACE = prev


@dataclasses.dataclass(frozen=True)
class PrecisionSpec:
    mode: str = "bf16"         # bf16|fp32|int8|int4|fp8|fp4|fp16_ipu
    exact: bool = False        # route through the bit-exact int kernels
    ipu: Optional[IPUConfig] = None
    group_size: Optional[int] = None

    def __post_init__(self):
        if self.mode not in ("bf16", "fp32", "int8", "int4",
                             "fp8", "fp4", "fp16_ipu"):
            raise ValueError(self.mode)
        if self.group_size is not None and self.group_size < 1:
            raise ValueError(f"group_size must be positive, got "
                             f"{self.group_size}")

    @property
    def weight_bits(self) -> Optional[int]:
        return {"int8": 8, "int4": 4}.get(self.mode)


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Ordered (regex, spec) rules; first match wins; default last."""

    name: str
    rules: Tuple[Tuple[str, PrecisionSpec], ...] = ()
    default: PrecisionSpec = PrecisionSpec("bf16")

    def spec_for(self, path: str) -> PrecisionSpec:
        spec = self.default
        for pattern, rule_spec in self.rules:
            if re.search(pattern, path):
                spec = rule_spec
                break
        if _ROUTING_TRACE is not None:
            _ROUTING_TRACE.append((path, spec.mode))
        return spec


BF16 = PrecisionPolicy("bf16")
FP32 = PrecisionPolicy("fp32", default=PrecisionSpec("fp32"))
INT8_SERVING = PrecisionPolicy(
    "int8_serving", rules=((r"router|lm_head", PrecisionSpec("bf16")),),
    default=PrecisionSpec("int8"))
INT4_SERVING = PrecisionPolicy(
    "int4_serving", rules=((r"router|lm_head", PrecisionSpec("bf16")),),
    default=PrecisionSpec("int4"))
PAPER_HYBRID = PrecisionPolicy(
    "paper_hybrid",
    rules=(
        (r"router|lm_head|embed", PrecisionSpec("fp16_ipu",
                                                ipu=IPUConfig(n=16, w=28))),
        (r"attn/wo", PrecisionSpec("fp16_ipu", ipu=IPUConfig(n=16, w=16))),
    ),
    default=PrecisionSpec("int4"))
FIDELITY_FP16_IPU = PrecisionPolicy(
    "fidelity_fp16_ipu",
    default=PrecisionSpec("fp16_ipu", exact=True,
                          ipu=IPUConfig(n=16, w=16, accum="fp32")))
FIDELITY_INT8 = PrecisionPolicy(
    "fidelity_int8", default=PrecisionSpec("int8", exact=True))

POLICIES = {p.name: p for p in (
    BF16, FP32, INT8_SERVING, INT4_SERVING, PAPER_HYBRID,
    FIDELITY_FP16_IPU, FIDELITY_INT8)}


def register_policy(policy: PrecisionPolicy) -> PrecisionPolicy:
    """Register a policy under its name (latest wins)."""
    POLICIES[policy.name] = policy
    return policy


_PINNED: Dict[str, PrecisionPolicy] = {}


@contextlib.contextmanager
def pinned_policy(name: str, policy: PrecisionPolicy):
    """Resolve ``name`` to ``policy`` while open. An engine runs its
    forwards under the policy it resolved at construction, so a
    ``plan:`` file rewritten or deleted afterwards (or a registered
    policy replaced) changes nothing it serves."""
    prev = _PINNED.get(name)
    _PINNED[name] = policy
    try:
        yield
    finally:
        if prev is None:
            del _PINNED[name]
        else:
            _PINNED[name] = prev


def get_policy(name: str) -> PrecisionPolicy:
    """Resolve a policy name. ``"plan:<path.json>"`` loads a serialized
    autotune PrecisionPlan artifact and returns its policy."""
    pinned = _PINNED.get(name)
    if pinned is not None:
        return pinned
    if name.startswith("plan:"):
        from repro_torch.autotune.plan import load_policy
        return load_policy(name[len("plan:"):])
    return POLICIES[name]
