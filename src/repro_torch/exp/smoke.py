"""Sweep-engine smoke check (mirror of ``repro/exp/smoke.py``).

Runs a tiny simulator sweep three ways and asserts the engine's core
contracts end to end:

  1. cold cache  — every point is executed;
  2. warm cache  — a second run performs **zero** simulator evaluations
     (``report.n_executed == 0``) and returns identical rows;
  3. parallel    — ``--jobs 2`` against a fresh cache produces
     byte-identical JSON to the serial run.

    PYTHONPATH=src python -m repro_torch.exp.smoke [--cache-dir DIR]

The points are numpy simulator runs (``repro_torch.core.simulator``):
they take no device, and the parallel leg's spawned workers each import
torch.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile

from repro_torch.core import simulator as sim
from repro_torch.core.workloads import ConvLayer
from repro_torch.exp import EngineConfig, ResultCache, SweepSpec, run_sweep
from repro_torch.exp.runner import rows_from

_TINY_LAYER = ("smoke", 32, 32, 8, 8, 3, 3, 1)


def eval_point(w: int, cluster: int, seed: int = 0,
               source: str = "forward") -> dict:
    """Simulate one tiny conv layer at one (adder width, cluster) point."""
    layer = ConvLayer(*_TINY_LAYER)
    tile = dataclasses.replace(sim.SMALL_TILE, adder_w=w,
                               cluster_size=cluster)
    src = sim.FORWARD_SOURCE if source == "forward" else sim.BACKWARD_SOURCE
    stats = sim.simulate_network([layer], tile, source=src, seed=seed,
                                 n_group_samples=64)
    return {"cycles": stats.cycles, "slowdown": stats.slowdown}


def square(x: int) -> int:
    """Trivial eval target for engine unit tests (no simulator)."""
    return x * x


def square_or_raise(x: int) -> int:
    """Eval target for the runner's partial-failure tests."""
    if x < 0:
        raise ValueError(f"negative input {x}")
    return x * x


def smoke_spec() -> SweepSpec:
    return SweepSpec(
        name="smoke",
        fn="repro_torch.exp.smoke:eval_point",
        axes={"w": [12, 16], "cluster": [1, 4]},
        fixed={"seed": 0, "source": "forward"},
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--jobs", type=int, default=2,
                    help="job count for the parallel determinism leg")
    args = ap.parse_args(argv)
    # fresh run directory per invocation so the cold-cache leg really is
    # cold even when --cache-dir points at a reused location
    base = args.cache_dir or tempfile.gettempdir()
    os.makedirs(base, exist_ok=True)
    cache_dir = tempfile.mkdtemp(dir=base, prefix="exp-smoke-run-")
    spec = smoke_spec()

    cold = EngineConfig(jobs=1, cache=ResultCache(cache_dir), progress=True)
    res_cold, rep_cold = run_sweep(spec, cold)
    assert rep_cold.n_executed == len(spec.points()), \
        f"cold run executed {rep_cold.n_executed} != {len(spec.points())}"

    warm = EngineConfig(jobs=1, cache=ResultCache(cache_dir), progress=True)
    res_warm, rep_warm = run_sweep(spec, warm)
    assert rep_warm.n_executed == 0, \
        f"warm run re-executed {rep_warm.n_executed} points"
    assert rep_warm.n_cached == len(spec.points())

    serial = json.dumps(rows_from(res_cold, spec.name), sort_keys=True)
    cached = json.dumps(rows_from(res_warm, spec.name), sort_keys=True)
    assert serial == cached, "cached rows differ from computed rows"

    par = EngineConfig(jobs=args.jobs, cache=None, progress=True)
    res_par, rep_par = run_sweep(spec, par)
    assert rep_par.n_executed == len(spec.points())
    parallel = json.dumps(rows_from(res_par, spec.name), sort_keys=True)
    assert parallel == serial, \
        f"jobs={args.jobs} rows differ from serial rows"

    shutil.rmtree(cache_dir, ignore_errors=True)
    print(f"exp smoke OK: {rep_cold.summary()} | {rep_warm.summary()} | "
          f"{rep_par.summary()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
