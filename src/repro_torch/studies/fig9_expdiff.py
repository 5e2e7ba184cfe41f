"""Fig. 9 reproduction: distribution of alignment sizes (max_exp - exp)
(mirror of ``benchmarks/fig9_expdiff.py``).

Forward-path products cluster near zero (paper: only ~1% exceed 8 bits);
backward products spread much wider — the empirical basis for small
shifters + MC-IPU. Also derives the 'weight of tail > 8' statistic.
"""
import numpy as np

from repro_torch import exp
from repro_torch.core import simulator as sim
from repro_torch.studies.common import emit, engine_main, row


def eval_point(direction: str, n: int = 8, samples: int = 200_000,
               seed: int = 0) -> dict:
    """Alignment-size histogram stats for one exponent source."""
    src = (sim.FORWARD_SOURCE if direction == "forward"
           else sim.BACKWARD_SOURCE)
    hist = sim.exponent_diff_histogram(src, n=n, samples=samples, seed=seed)
    return {
        "hist": hist.tolist(),
        "frac_gt8": float(hist[9:].sum()),
        "frac_le2": float(hist[:3].sum()),
        "mean": float((np.arange(len(hist)) * hist).sum()),
    }


def spec() -> exp.SweepSpec:
    return exp.SweepSpec(
        name="fig9_expdiff",
        fn="repro_torch.studies.fig9_expdiff:eval_point",
        axes={"direction": ["forward", "backward"]},
        fixed={"n": 8, "samples": 200_000, "seed": 0})


def run(verbose: bool = True, engine: exp.EngineConfig = None):
    engine = engine or exp.EngineConfig()
    res, _ = exp.run_sweep(spec(), engine)
    results = {}
    for p, r in res:
        name = p.kwargs["direction"]
        results[name] = r
        if verbose:
            row(f"fig9/{name}", 0.0,
                f">8bits={r['frac_gt8']:.3%} <=2bits={r['frac_le2']:.1%} "
                f"mean={r['mean']:.2f}")
    claims = {
        "fwd_tail_small": results["forward"]["frac_gt8"] < 0.05,
        "bwd_much_wider": (results["backward"]["frac_gt8"]
                           > 5 * results["forward"]["frac_gt8"]),
    }
    results["claims"] = claims
    results["rows"] = exp.rows_from(res, "fig9_expdiff")
    emit("fig9_expdiff", results)
    if verbose:
        print("fig9 claims:", claims)
    return results


def main(argv=None):
    engine_main(run, argv, __doc__)


if __name__ == "__main__":
    main()
