"""Recommended production launch configuration per (arch x shape) cell
(mirror of ``repro/launch/cell_configs.py``).

The dry-run's baseline runs every cell with the plain configuration
(the paper-faithful reference); these overrides are the reference's
measured-best settings from its EXPERIMENTS.md §Perf items, named in
each note. The reference's notes also quote per-device gigabytes on
its 16 GB TPU; those are TPU figures and are left out here. Consumed
by ``python -m repro_torch.launch.dryrun --recommended``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CellConfig:
    microbatches: int = 1
    moe_dispatch: Optional[str] = None   # None = arch default ('einsum')
    remat: str = "full"
    note: str = ""


# (arch, shape) -> config.  Cells not listed run the defaults.
RECOMMENDED: Dict[Tuple[str, str], CellConfig] = {
    # §Perf M7: activation peaks scale 1/k with gradient accumulation
    ("gemma2-9b", "train_4k"): CellConfig(
        microbatches=2, note="M7: activation peak / microbatches"),
    ("mixtral-8x7b", "train_4k"): CellConfig(
        microbatches=4, note="M7: activation peak / microbatches"),
    ("recurrentgemma-9b", "train_4k"): CellConfig(
        microbatches=4, note="M7: activation peak / microbatches"),
    ("stablelm-12b", "train_4k"): CellConfig(
        microbatches=2, note="memory headroom"),
    ("glm4-9b", "train_4k"): CellConfig(
        microbatches=2, note="memory headroom"),
    # §Perf C1-C3: gather dispatch removes the one-hot dispatch FLOPs
    ("qwen3-moe-30b-a3b", "prefill_32k"): CellConfig(
        moe_dispatch="gather",
        note="C1: gather dispatch, fewer FLOPs and bytes"),
    ("qwen3-moe-30b-a3b", "decode_32k"): CellConfig(
        moe_dispatch="gather", note="C1 applies to decode as well"),
    ("qwen3-moe-30b-a3b", "train_4k"): CellConfig(
        moe_dispatch="gather", microbatches=4,
        note="C3: gather dispatch with microbatches"),
}


def recommended(arch: str, shape: str) -> CellConfig:
    return RECOMMENDED.get((arch, shape), CellConfig())
