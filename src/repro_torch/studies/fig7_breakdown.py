"""Fig. 7 reproduction: area/power breakdown of MC-IPU tiles (mirror of
``benchmarks/fig7_breakdown.py``).

Columns: INT-only, MC-IPU(12..28), NVDLA-like 38b baseline, for 8- and
16-input tiles; component categories (FAcc, WBuf, ShCNT, MULT, Shft, AT).
Also prints the §4.2 deltas the paper calls out.

The variant grid runs through ``repro_torch.exp`` (analytic model —
cheap, but cached and fanned out like every other sweep for
uniformity).
"""
from repro_torch import exp
from repro_torch.core.area_power import (IPUDesign, area_breakdown,
                                         fig7_deltas, power_breakdown,
                                         tile_area_mm2, tile_power_w)
from repro_torch.core.simulator import tile_for
from repro_torch.studies.common import emit, engine_main, row


def eval_point(n_inputs: int, w: int, fp: bool) -> dict:
    """Area/power of one tile variant (fp=False -> INT-only design)."""
    tile = tile_for(n_inputs)
    name = f"mc{w}" if fp else "INT"
    d = IPUDesign(name, 4, 4, w, fp, tile)
    return {
        "area_mm2": tile_area_mm2(d),
        "power_w": tile_power_w(d),
        "area_breakdown": area_breakdown(d),
        "power_breakdown": power_breakdown(d),
    }


def spec() -> exp.SweepSpec:
    return exp.SweepSpec(
        name="fig7_breakdown",
        fn="repro_torch.studies.fig7_breakdown:eval_point",
        axes={"n_inputs": [8, 16], "fp": [False, True],
              "w": [12, 16, 20, 24, 28, 38]},
        # the INT column is a single design point per tile width
        filters=[lambda p: p["fp"] or p["w"] == 12])


def run(verbose: bool = True, engine: exp.EngineConfig = None):
    engine = engine or exp.EngineConfig()
    res, _ = exp.run_sweep(spec(), engine)
    results = {"deltas": fig7_deltas()}
    for p, r in res:
        kw = p.kwargs
        name = f"MC-IPU({kw['w']})" if kw["fp"] else "INT"
        key = f"{kw['n_inputs']}in/{name}"
        results[key] = r
        if verbose:
            ab = r["area_breakdown"]
            top = max(ab, key=ab.get)
            row(f"fig7/{key}", 0.0,
                f"area={r['area_mm2']:.4f}mm2 "
                f"power={r['power_w']:.3f}W top={top}"
                f"({ab[top]:.0%})")
    results["rows"] = exp.rows_from(res, "fig7_breakdown")
    emit("fig7_breakdown", results)
    if verbose:
        d = results["deltas"]
        print(f"fig7 deltas: 38->28 {d['adder_38_to_28']:+.1%} "
              f"(paper -17%), 38->12 {d['adder_38_to_12']:+.1%} "
              f"(paper -39%), INT->MC12 {d['int_to_mcipu12']:+.1%} "
              f"(paper +43%)")
    return results


def main(argv=None):
    engine_main(run, argv, __doc__)


if __name__ == "__main__":
    main()
