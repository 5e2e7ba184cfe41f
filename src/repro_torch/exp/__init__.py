"""Declarative experiment engine for the paper's studies (mirror of
``repro/exp``).

Every study (``repro_torch.studies``) declares its parameter space as a
:class:`SweepSpec`, and the engine takes care of the rest:

  * ``sweep``  — axis expansion (cartesian or zipped, with filters) into
    hashable :class:`ExperimentPoint`s;
  * ``cache``  — a content-addressed on-disk result store keyed by a
    stable hash of (eval function, params, code-version salt), so
    re-running any study only evaluates missing points;
  * ``runner`` — executes points inline or via a process pool
    (``--jobs``), counts cache hits vs. fresh evaluations, and returns
    results in spec order so output is byte-identical at any job count;
    eval functions that take a ``device`` keyword get the engine's.

Entry points share one CLI surface (``--jobs/--no-cache/--cache-dir/
--device``) via :func:`add_cli_args` / :func:`EngineConfig.from_args`.
"""
from repro_torch.exp.cache import ResultCache, code_salt, point_key
from repro_torch.exp.runner import (EngineConfig, RunReport, add_cli_args,
                                    rows_from, run_sweep)
from repro_torch.exp.sweep import ExperimentPoint, SweepSpec

__all__ = [
    "EngineConfig", "ExperimentPoint", "ResultCache", "RunReport",
    "SweepSpec", "add_cli_args", "code_salt", "point_key", "rows_from",
    "run_sweep",
]
