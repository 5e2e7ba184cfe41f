"""Fig. 8 reproduction: MC-IPU execution time vs precision and cluster
(mirror of ``benchmarks/fig8_perf.py``).

(a) Normalized execution time (vs the 38b-adder baselines) for adder
precisions {12, 16, 20, 24, 28} on the four study cases: ResNet-18/-50,
InceptionV3 forward and ResNet-18 backward, FP16 ops with FP32
accumulation (sw precision 28); 8-input tiles normalized to Baseline1,
16-input to Baseline2.

(b) Cluster-size sweep for MC-IPU(16).

Paper trends to reproduce: backward >> forward slowdown; >4x at 12b for
backprop; 8-input outperforms 16-input; small clusters recover most of
the loss for forward, backward keeps >= ~1.6x even at cluster 1.

Sweeps are declared through ``repro_torch.exp``; ``eval_point`` is the shared
simulator entry other scripts (fig10) reuse so identical (workload,
tile, precision) points are cached once.
"""
import dataclasses

from repro_torch import exp
from repro_torch.core import simulator as sim
from repro_torch.core import workloads as wl
from repro_torch.studies.common import emit, engine_main, row

CASES = {
    "resnet18_fwd": (wl.resnet18, "forward"),
    "resnet50_fwd": (wl.resnet50, "forward"),
    "inception_v3_fwd": (wl.inception_v3, "forward"),
    "resnet18_bwd": (wl.resnet18_backward, "backward"),
}

_SOURCES = {"forward": sim.FORWARD_SOURCE, "backward": sim.BACKWARD_SOURCE}


def _base(n_inputs: int) -> sim.TileConfig:
    return sim.BASELINE1 if n_inputs == 8 else sim.BASELINE2


def eval_point(case: str, n_inputs: int, w: int, cluster=None,
               skip_empty: bool = False) -> float:
    """Normalized execution time of one (workload, tile) design point."""
    layers_fn, src_name = CASES[case]
    base = _base(n_inputs)
    tile = dataclasses.replace(base, adder_w=w, cluster_size=cluster,
                               skip_empty_partitions=skip_empty)
    return sim.normalized_exec_time(layers_fn(), tile, base,
                                    source=_SOURCES[src_name])


def _specs():
    precision = exp.SweepSpec(
        name="fig8a_precision",
        fn="repro_torch.studies.fig8_perf:eval_point",
        axes={"n_inputs": [8, 16], "case": list(CASES),
              "w": [12, 16, 20, 24, 28]},
        fixed={"cluster": None, "skip_empty": False})
    # cluster values: the no-clustering point is the whole tile
    # (ipus_per_tile = 4 * n_inputs), then {8, 4, 2, 1}
    cluster = exp.SweepSpec(
        name="fig8b_cluster",
        fn="repro_torch.studies.fig8_perf:eval_point",
        axes={"n_inputs": [8, 16], "case": list(CASES),
              "cluster": [64, 32, 8, 4, 2, 1]},
        fixed={"w": 16, "skip_empty": False},
        filters=[lambda p: p["cluster"] in (8, 4, 2, 1)
                 or p["cluster"] == 4 * p["n_inputs"]])
    # ablation: Fig.-5 threshold walk (serve partition k in cycle k, empty
    # partitions burn a cycle) vs a scheduler that skips empty partitions
    # — a micro-optimization the paper's EHU design leaves on the table.
    skip = exp.SweepSpec(
        name="fig8c_skip_empty",
        fn="repro_torch.studies.fig8_perf:eval_point",
        axes={"case": ["resnet50_fwd", "resnet18_bwd"], "w": [12, 16],
              "skip_empty": [False, True]},
        fixed={"n_inputs": 16, "cluster": None})
    return precision, cluster, skip


def run(verbose: bool = True, engine: exp.EngineConfig = None):
    engine = engine or exp.EngineConfig()
    precision, cluster, skip = _specs()
    results = {}
    rows = []

    res, _ = exp.run_sweep(precision, engine)
    rows += exp.rows_from(res, precision.name)
    for p, t in res:
        kw = p.kwargs
        key = f"precision/{kw['n_inputs']}in/{kw['case']}/w{kw['w']}"
        results[key] = t
        if verbose:
            row(f"fig8a/{key}", 0.0, f"normalized={t:.3f}")

    res, _ = exp.run_sweep(cluster, engine)
    rows += exp.rows_from(res, cluster.name)
    for p, t in res:
        kw = p.kwargs
        key = f"cluster/{kw['n_inputs']}in/{kw['case']}/c{kw['cluster']}"
        results[key] = t
        if verbose:
            row(f"fig8b/{key}", 0.0, f"normalized={t:.3f}")

    res, _ = exp.run_sweep(skip, engine)
    rows += exp.rows_from(res, skip.name)
    walk = {(p.kwargs["case"], p.kwargs["w"]): t for p, t in res
            if not p.kwargs["skip_empty"]}
    for p, t in res:
        kw = p.kwargs
        if not kw["skip_empty"]:
            continue
        t0 = walk[(kw["case"], kw["w"])]
        key = f"skip_empty/{kw['case']}/w{kw['w']}"
        results[key] = {"fig5_walk": t0, "skip_empty": t, "gain": t0 / t}
        if verbose:
            row(f"fig8c/{key}", 0.0,
                f"walk={t0:.3f} skip={t:.3f} gain={t0/t:.3f}x")

    # derived fp_mc_factors for the area/power designs (used by Table 1)
    fwd = [results[f"precision/16in/{c}/w16"]
           for c in ("resnet18_fwd", "resnet50_fwd", "inception_v3_fwd")]
    results["mc_factor_w16_fwd_mean"] = sum(fwd) / len(fwd)
    claims = {
        "bwd_slower_than_fwd": (
            results["precision/16in/resnet18_bwd/w16"]
            > results["precision/16in/resnet18_fwd/w16"]),
        "w12_bwd_over_2x": results["precision/8in/resnet18_bwd/w12"] > 2.0,
        "monotone_precision": (
            results["precision/16in/resnet50_fwd/w12"]
            >= results["precision/16in/resnet50_fwd/w20"]
            >= results["precision/16in/resnet50_fwd/w28"]),
        "clustering_recovers": (
            results["cluster/8in/resnet50_fwd/c1"]
            <= results["cluster/8in/resnet50_fwd/c8"]),
    }
    results["claims"] = claims
    results["rows"] = rows
    emit("fig8_perf", results)
    if verbose:
        print("fig8 claims:", claims)
    return results


def main(argv=None):
    engine_main(run, argv, __doc__)


if __name__ == "__main__":
    main()
