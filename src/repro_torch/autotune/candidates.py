"""Candidate enumeration: the joint space the planner searches (the
port's copy of ``repro/autotune/candidates.py``).

A :class:`Candidate` is one per-layer precision option — an operand mode
(INT4/INT8 quantized, fp8/fp4 storage, the approximate FP16 IPU datapath,
or plain BF16) crossed with the MC-IPU configuration that executes it
(adder precision ``w``, software precision ``P``, cluster size; paper
§3.2–3.3). INT, fp-storage and BF16 candidates are canonicalized to one
hardware point each (no alignment hardware / wide-adder reference) so
the score cache never fragments over parameters that cannot change their
cost. ``Candidate.key()`` equals the reference's: keys are cache-key
material and plan-assignment strings.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs import ModelConfig
from repro_torch.models.registry import ProjGroup, projection_groups

# The wide-adder reference point: a 38-bit tree serves any FP16
# alignment in one cycle (simulator baseline; §4.1).
WIDE_W = 38


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One per-layer precision option. Hashable, canonically encodable
    (frozen dataclass of primitives) — usable directly as sweep-axis
    values and cache-key material."""

    mode: str                 # int4 | int8 | fp8 | fp4 | fp16_ipu | bf16
    w: int = 16               # MC-IPU adder precision
    sw_precision: int = 28    # software precision P (FP32 accumulation)
    cluster: int = 1          # intra-tile cluster size (§3.3)
    # per-group weight scales for the storage modes (int/fp8/fp4):
    # K/group_size scale groups along the contraction dim; None keeps
    # per-out-channel scales (the serving default)
    group_size: Optional[int] = None

    def __post_init__(self):
        if self.mode not in ("int4", "int8", "fp8", "fp4", "fp16_ipu",
                             "bf16"):
            raise ValueError(f"unknown candidate mode {self.mode!r}")
        if self.group_size is not None and self.group_size < 1:
            raise ValueError(f"group_size must be positive, got "
                             f"{self.group_size}")

    def key(self) -> str:
        g = f"_g{self.group_size}" if self.group_size else ""
        if self.mode in ("int4", "int8", "fp8", "fp4", "bf16"):
            return self.mode + g
        return f"{self.mode}_w{self.w}_p{self.sw_precision}_c{self.cluster}"


def exact_for(mode: str, w: int) -> bool:
    """Whether a candidate must execute on the bit-exact kernel path.
    fp16_ipu below w=28 is *not* approximated by the fp16-cast matmul
    (§3.1: indistinguishable only at w >= 28), so both the divergence
    probe and the emitted plan rules route it through ``kernels.ops``
    (``mp_matmul``) — measured accuracy always describes the datapath
    that serves."""
    return mode == "fp16_ipu" and w < 28


def canonical(mode: str, w: int = 16, sw_precision: int = 28,
              cluster: int = 1, group_size: Optional[int] = None
              ) -> Candidate:
    """Canonicalize hardware axes that are meaningless for a mode: INT
    and fp-storage datapaths never multi-cycle (any w serves them; pin
    the narrow INT point), and bf16 is the wide-adder single-cycle
    reference. ``group_size`` survives canonicalization only for the
    storage modes it parameterizes."""
    if mode in ("int4", "int8", "fp8", "fp4"):
        return Candidate(mode, w=16, sw_precision=28, cluster=1,
                         group_size=group_size)
    if mode == "bf16":
        return Candidate(mode, w=WIDE_W, sw_precision=28, cluster=1)
    return Candidate(mode, w=w, sw_precision=sw_precision, cluster=cluster)


def default_candidates(widths: Sequence[int] = (12, 16, 20, 28),
                       clusters: Sequence[int] = (1,),
                       modes: Sequence[str] = ("bf16", "fp16_ipu", "int8",
                                               "int4", "fp8", "fp4"),
                       group_sizes: Sequence[Optional[int]] = (None,),
                       ) -> Tuple[Candidate, ...]:
    """The default per-layer search grid. fp16_ipu expands over the
    (w, cluster) hardware axes; the storage modes (int4/int8/fp8/fp4)
    expand over ``group_sizes`` (None = per-out-channel scales); bf16
    contributes one point."""
    out: List[Candidate] = []
    for mode in modes:
        if mode == "fp16_ipu":
            for w, c in itertools.product(widths, clusters):
                out.append(canonical(mode, w=w, cluster=c))
        elif mode in ("int4", "int8", "fp8", "fp4"):
            for g in group_sizes:
                out.append(canonical(mode, group_size=g))
        else:
            out.append(canonical(mode))
    # dedupe, preserving order (canonicalization can collapse points)
    seen: Dict[Candidate, None] = {}
    for c in out:
        seen.setdefault(c)
    return tuple(seen)


def groups_for(cfg: ModelConfig) -> Tuple[ProjGroup, ...]:
    """The tunable projection groups of an architecture (re-exported so
    the CLI and search only import this module)."""
    return projection_groups(cfg)
