"""Table 1 reproduction: TOPS/mm^2 and TOPS/W across the design-space
sensitivity study (MC-SER / MC-IPU4 / MC-IPU84 / MC-IPU8 / NVDLA / FP16 /
INT8 / INT4) x workloads (4x4, 8x4, 8x8, FP16xFP16). Mirror of
``benchmarks/table1.py``.

The design x workload grid is a ``repro_torch.exp`` sweep over the analytic
area/power model.
"""
import numpy as np

from repro_torch import exp
from repro_torch.core.area_power import (PAPER_TABLE1, WORKLOAD_TYPES,
                                         efficiency, paper_designs)
from repro_torch.studies.common import emit, engine_main, row


def eval_point(design: str, workload: str) -> dict:
    """One Table-1 cell: model-predicted (TOPS/mm2, TOPS/W) vs paper."""
    d = paper_designs()[design]
    a, p = efficiency(d, WORKLOAD_TYPES[workload])
    pa, pp = PAPER_TABLE1[design][workload]
    return {"model_tops_mm2": a, "paper_tops_mm2": pa,
            "model_tops_w": p, "paper_tops_w": pp}


def spec() -> exp.SweepSpec:
    return exp.SweepSpec(
        name="table1",
        fn="repro_torch.studies.table1:eval_point",
        axes={"design": list(PAPER_TABLE1), "workload": list(WORKLOAD_TYPES)})


def run(verbose: bool = True, engine: exp.EngineConfig = None):
    engine = engine or exp.EngineConfig()
    res, _ = exp.run_sweep(spec(), engine)
    results = {}
    errs = []
    for p, r in res:
        kw = p.kwargs
        results[f"{kw['design']}/{kw['workload']}"] = r
        a, pa = r["model_tops_mm2"], r["paper_tops_mm2"]
        pw, pp = r["model_tops_w"], r["paper_tops_w"]
        if a is not None and pa is not None:
            errs += [abs(a / pa - 1), abs(pw / pp - 1)]
        if verbose:
            fmt = lambda v: f"{v:.2f}" if v is not None else "--"
            row(f"table1/{kw['design']}/{kw['workload']}", 0.0,
                f"area {fmt(a)} (paper {fmt(pa)}) "
                f"power {fmt(pw)} (paper {fmt(pp)})")
    results["median_abs_rel_err"] = float(np.median(errs))
    results["max_abs_rel_err"] = float(np.max(errs))
    results["rows"] = exp.rows_from(res, "table1")
    emit("table1", results)
    if verbose:
        print(f"table1: median |rel err| "
              f"{results['median_abs_rel_err']:.1%}, "
              f"max {results['max_abs_rel_err']:.1%}")
    return results


def main(argv=None):
    engine_main(run, argv, __doc__)


if __name__ == "__main__":
    main()
