"""Design-space exploration: size an MC-IPU accelerator for YOUR model.

Reproduces the paper's Fig.-10 sweep and then goes beyond it: scores the
(precision, cluster) design points on a *transformer serving* workload
built from one of the assigned architectures' projection shapes — the
kind of study a deployment team would run before taping out. Mirror of
``examples/accelerator_study.py`` (prints the same text); numpy models
only, so it takes no device.

    PYTHONPATH=src python -m repro_torch.examples.accelerator_study \\
        --arch qwen2-0.5b
"""
import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.core import simulator as sim
from repro_torch.core import workloads as wl
from repro_torch.core.area_power import (FP16, INT4, IPUDesign,
                                         baseline_design, efficiency)
from repro_torch.core.simulator import TileConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    layers = wl.lm_projection_layers(
        cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab, seq=args.seq,
        name=cfg.arch_id)
    print(f"workload: {cfg.arch_id} projections, seq={args.seq}, "
          f"{wl.total_macs(layers)/1e9:.1f} GMACs/token-batch")

    base = sim.BASELINE2
    print(f"\n{'design':>12s} {'mc':>5s} {'TOPS/mm2':>9s} {'TFLOPS/mm2':>11s}"
          f" {'TOPS/W':>7s} {'TFLOPS/W':>9s}")
    rows = []
    for w in (12, 16, 20, 28):
        for c in (1, 4, 16):
            tile = dataclasses.replace(TileConfig(), adder_w=w,
                                       cluster_size=c)
            mc = sim.normalized_exec_time(layers, tile, base,
                                          source=sim.FORWARD_SOURCE)
            d = IPUDesign(f"({w},{c})", 4, 4, w, True, tile,
                          cluster_size=c, fp_mc_factor=mc)
            ai, pi = efficiency(d, INT4)
            af, pf = efficiency(d, FP16)
            rows.append(((w, c), mc, ai, af, pi, pf))
            print(f"{f'({w},{c})':>12s} {mc:5.2f} {ai:9.1f} {af:11.2f} "
                  f"{pi:7.2f} {pf:9.3f}")
    b = baseline_design(16)
    ai, pi = efficiency(b, INT4)
    af, pf = efficiency(b, FP16)
    print(f"{'NO-OPT':>12s} {1.0:5.2f} {ai:9.1f} {af:11.2f} "
          f"{pi:7.2f} {pf:9.3f}")

    # simple Pareto over (TOPS/mm2, TFLOPS/mm2)
    pareto = []
    for r in rows:
        if not any((o[2] >= r[2] and o[3] >= r[3] and o != r)
                   for o in rows):
            pareto.append(r[0])
    print(f"\narea-efficiency Pareto points: {pareto}")
    print("paper's power-Pareto picks: (12,1) and (16,1)")


if __name__ == "__main__":
    main()
