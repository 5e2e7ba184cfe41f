"""Shared study utilities: result emission, engine CLI, CSV rows (mirror
of ``benchmarks/common.py``; its ``time_fn`` waits for the port's
benchmark)."""
import argparse
import json
import os

from repro_torch import exp

# the port's own directory: a study never writes the reference's
# results/bench/<name>.json by default
RESULTS_DIR = os.environ.get("BENCH_TORCH_OUT", "results/bench_torch")


def engine_main(run_fn, argv=None, doc=None):
    """Shared entry point of every sweep-backed study module: parse the
    engine CLI (--jobs/--no-cache/--cache-dir/--device), run, print the
    executed/cached counter line."""
    ap = argparse.ArgumentParser(description=doc)
    exp.add_cli_args(ap)
    args = ap.parse_args(argv)
    engine = exp.EngineConfig.from_args(args)
    run_fn(engine=engine)
    print(f"# {engine.total.summary()}")


def emit(name: str, payload: dict):
    os.makedirs(RESULTS_DIR, exist_ok=True)
    with open(os.path.join(RESULTS_DIR, f"{name}.json"), "w") as f:
        json.dump(payload, f, indent=1, default=float)


def row(name: str, us: float, derived: str = ""):
    print(f"{name},{us:.1f},{derived}")
