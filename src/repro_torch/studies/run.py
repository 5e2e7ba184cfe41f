"""Study harness: one module per paper table/figure (mirror of
``benchmarks/run.py``, over the six studies; the reference's
``autotune_bench``, ``kernel_bench`` and ``serve_bench`` are not ported).

Prints ``name,us_per_call,derived`` CSV rows per study and writes JSON
artifacts to results/bench_torch/.

Every study runs through the ``repro_torch.exp`` engine: pass
``--jobs N`` to fan points out over worker processes and re-run with a
warm cache to skip every already-evaluated point (``--no-cache`` to
force re-evaluation). ``--device`` reaches fig3_error, the one study
that computes with torch.

    PYTHONPATH=src python -m repro_torch.studies.run [--only NAME] \\
        [--device cpu]
"""
import argparse
import sys
import time

from repro_torch import exp


def main(argv=None) -> None:
    from repro_torch.studies import (fig3_error, fig7_breakdown, fig8_perf,
                                     fig9_expdiff, fig10_tradeoff, table1)
    ap = argparse.ArgumentParser(description=__doc__)
    exp.add_cli_args(ap)
    ap.add_argument("--only", default=None, metavar="NAME",
                    help="run a single study module (e.g. fig8_perf)")
    args = ap.parse_args(argv)
    engine = exp.EngineConfig.from_args(args)

    mods = (table1, fig7_breakdown, fig9_expdiff, fig8_perf,
            fig10_tradeoff, fig3_error)
    if args.only:
        mods = [m for m in mods if m.__name__.split(".")[-1] == args.only]
        if not mods:
            sys.exit(f"unknown study {args.only!r}")
    t0 = time.time()
    print("name,us_per_call,derived")
    for mod in mods:
        name = mod.__name__.split(".")[-1]
        print(f"# --- {name} ---", flush=True)
        mod.run(engine=engine)
    print(f"# engine {engine.total.summary()}")
    print(f"# all studies done in {time.time() - t0:.1f}s")


if __name__ == '__main__':
    main()
