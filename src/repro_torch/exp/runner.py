"""Sweep execution: cache lookup, fan-out, progress, counters (mirror of
``repro/exp/runner.py``).

``run_sweep`` resolves each point against the cache, evaluates only the
misses (inline for ``jobs<=1``, else in a ``ProcessPoolExecutor``), and
returns results in spec order — so the emitted JSON is byte-identical
at any job count. The returned :class:`RunReport` exposes
``n_executed``: the number of fresh evaluations, the counter the
warm-cache acceptance check (and the exp smoke) asserts on.

The device: an eval function that takes a ``device`` keyword receives
``EngineConfig.device`` (``cuda`` unless asked otherwise; resolved once
per sweep, so without CUDA the sweep raises instead of falling back to
the CPU), in the parent and in the workers alike. The device is never a
parameter of an :class:`ExperimentPoint`: not of its cache key and not
of its row, so a sweep gives the same rows on either device. Eval
functions without that keyword (the numpy models) never see it.

The pool uses the ``spawn`` start method (a CUDA context must never be
forked, and spawn propagates ``sys.path``, so
``"repro_torch.studies.fig8_perf:eval_point"`` style references resolve
in children exactly as in the parent); with ``--device cuda`` each
worker opens its own CUDA context.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import functools
import importlib
import inspect
import multiprocessing
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.device import resolve_device
from repro_torch.exp.cache import ResultCache
from repro_torch.exp.sweep import ExperimentPoint, SweepSpec


def resolve_fn(ref: str):
    """Import ``"pkg.module:function"``."""
    mod_name, _, qual = ref.partition(":")
    if not qual:
        raise ValueError(f"bad fn reference {ref!r} (want 'pkg.mod:fn')")
    obj = importlib.import_module(mod_name)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


@functools.lru_cache(maxsize=None)
def takes_device(ref: str) -> bool:
    """Whether the eval function ``ref`` takes a ``device`` keyword."""
    return "device" in inspect.signature(resolve_fn(ref)).parameters


def _eval_point(point: ExperimentPoint, device: Optional[str] = None) -> Any:
    fn = resolve_fn(point.fn)
    if device is None:
        return fn(**point.kwargs)
    return fn(**point.kwargs, device=device)


@dataclasses.dataclass
class RunReport:
    """Outcome of one ``run_sweep`` call."""

    name: str
    n_points: int = 0
    n_cached: int = 0
    n_executed: int = 0
    wall_s: float = 0.0

    def merged(self, other: "RunReport") -> "RunReport":
        return RunReport(self.name, self.n_points + other.n_points,
                         self.n_cached + other.n_cached,
                         self.n_executed + other.n_executed,
                         self.wall_s + other.wall_s)

    def summary(self) -> str:
        return (f"{self.name}: {self.n_points} points, "
                f"{self.n_cached} cached, {self.n_executed} executed "
                f"in {self.wall_s:.2f}s")


@dataclasses.dataclass
class EngineConfig:
    """Shared CLI surface of every study entry point. ``device`` reaches
    the eval functions that take one (see the module docstring)."""

    jobs: int = 1
    cache: Optional[ResultCache] = dataclasses.field(
        default_factory=ResultCache)
    progress: bool = False
    device: str = "cuda"

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "EngineConfig":
        cache = None
        if not args.no_cache:
            cache = (ResultCache(args.cache_dir) if args.cache_dir
                     else ResultCache())
        return cls(jobs=args.jobs, cache=cache,
                   progress=not args.quiet_progress, device=args.device)

    # aggregate report across every sweep this config has run
    _total: RunReport = dataclasses.field(
        default_factory=lambda: RunReport("total"))

    @property
    def total(self) -> RunReport:
        return self._total


def add_cli_args(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group("experiment engine")
    g.add_argument("--jobs", type=int, default=1, metavar="N",
                   help="worker processes for sweep points (default 1)")
    g.add_argument("--no-cache", action="store_true",
                   help="ignore and don't write the on-disk result cache")
    g.add_argument("--cache-dir", default=None, metavar="DIR",
                   help="result cache location (default "
                        "results/expcache_torch)")
    g.add_argument("--quiet-progress", action="store_true",
                   help="suppress per-sweep progress lines on stderr")
    g.add_argument("--device", default="cuda",
                   help="torch device of the studies that compute with "
                        "torch (default cuda; 'cpu' runs the plain "
                        "PyTorch path; the numpy models ignore it)")


def run_sweep(spec: SweepSpec,
              engine: Optional[EngineConfig] = None,
              ) -> Tuple[List[Tuple[ExperimentPoint, Any]], RunReport]:
    """Evaluate a sweep; returns ([(point, result)...] in spec order,
    report). Cached points are never re-evaluated."""
    engine = engine or EngineConfig()
    t0 = time.perf_counter()
    points = spec.points()
    device = None
    if takes_device(spec.fn_ref):
        if any("device" in p.kwargs for p in points):
            raise ValueError(f"sweep {spec.name!r} binds 'device' as a "
                             "parameter; the engine passes it")
        device = str(resolve_device(engine.device))
    report = RunReport(spec.name, n_points=len(points))
    results: List[Any] = [None] * len(points)
    todo: List[int] = []
    for i, p in enumerate(points):
        if engine.cache is not None:
            hit, value = engine.cache.get(p)
            if hit:
                results[i] = value
                report.n_cached += 1
                continue
        todo.append(i)

    if todo and engine.progress:
        print(f"[exp:{spec.name}] evaluating {len(todo)}/{len(points)} "
              f"points (jobs={engine.jobs})", file=sys.stderr, flush=True)

    def _record(i: int, value: Any) -> None:
        # cache incrementally (puts are atomic) so an interrupt or a
        # failing point keeps every result computed before it
        results[i] = value
        report.n_executed += 1
        if engine.cache is not None:
            engine.cache.put(points[i], value)

    if engine.jobs <= 1 or len(todo) <= 1:
        for n_done, i in enumerate(todo, 1):
            _record(i, _eval_point(points[i], device))
            _progress(engine, spec.name, n_done, len(todo))
    else:
        workers = min(engine.jobs, len(todo))
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(workers,
                                                    mp_context=ctx) as pool:
            futs = {pool.submit(_eval_point, points[i], device): i
                    for i in todo}
            n_done = 0
            first_exc: Optional[Exception] = None
            for fut in concurrent.futures.as_completed(futs):
                try:
                    value = fut.result()
                except Exception as e:
                    # keep draining so every finished point still gets
                    # cached; surface the first failure afterwards
                    if first_exc is None:
                        first_exc = e
                    continue
                _record(futs[fut], value)
                n_done += 1
                _progress(engine, spec.name, n_done, len(todo))
            if first_exc is not None:
                raise first_exc

    report.wall_s = time.perf_counter() - t0
    engine._total = engine._total.merged(report)
    if engine.progress:
        print(f"[exp:{spec.name}] {report.summary()}", file=sys.stderr,
              flush=True)
    return list(zip(points, results)), report


def _progress(engine: EngineConfig, name: str, done: int, total: int) -> None:
    if not engine.progress or total < 8:
        return
    step = max(total // 8, 1)
    if done % step == 0 or done == total:
        print(f"[exp:{name}] {done}/{total}", file=sys.stderr, flush=True)


def rows_from(results: Sequence[Tuple[ExperimentPoint, Any]],
              sweep: str) -> List[Dict[str, Any]]:
    """Flatten (point, result) pairs into structured JSON rows — the
    reference's interchange format (``tools/roofline_table.py`` renders
    it)."""
    return [{"sweep": sweep, "params": p.kwargs, "value": v}
            for p, v in results]
