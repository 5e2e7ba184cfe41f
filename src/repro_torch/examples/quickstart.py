"""Quickstart: the paper's arithmetic in five minutes (mirror of
``examples/quickstart.py``; prints the same text).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

1. Decompose FP16 numbers the way the IPU does.
2. Run the approximate FP-IP at several IPU precisions; compare against
   the exact dot product and the Theorem-1 bound.
3. Show the MC-IPU multi-cycle schedule on the paper's Fig.-4 example.
4. Query the calibrated 7nm area/power model.

Steps 2 and 3 compute on ``--device`` (``cuda`` by default; without
CUDA it raises, ``--device cpu`` runs them on the CPU).
"""
import argparse

import numpy as np
import torch

from repro_torch.core import ehu, error_bounds, exact_ref
from repro_torch.core.area_power import FP16, INT4, efficiency, paper_designs
from repro_torch.core.ipu import IPUConfig, fp16_inner_product
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the FP-IP and the schedule "
                         "(default cuda; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    print("=== 1. FP16 decomposition ===")
    for v in (1.0, -0.375, 6.1e-5):
        s, e, m = exact_ref.decompose_fp16(v)
        print(f"  {v:>10}: sign={s:+d} exp={e:+d} mag={m} "
              f"(= {s} * {m} * 2^{e - 10})")

    print("\n=== 2. Approximate FP-IP vs exact ===")
    a = np.asarray(rng.normal(0, 1, 64), np.float16)
    b = np.asarray(rng.normal(0, 1, 64), np.float16)
    exact = float(exact_ref.exact_dot(a, b))
    print(f"  exact dot: {exact:.8f}")
    for w in (12, 16, 20, 28):
        cfg = IPUConfig(n=16, w=w, accum="fp32", sw_precision=w)
        approx = float(fp16_inner_product(
            torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev),
            cfg))
        bound = float(error_bounds.fp_ip_bound(w, 10, 16))
        print(f"  IPU({w:2d}):  {approx:.8f}   |err|={abs(approx-exact):.2e}"
              f"   Theorem-1 bound~{bound:.2e}")

    print("\n=== 3. MC-IPU schedule (paper Fig. 4: sp=5) ===")
    # alignments of A, B, C, D
    shift = torch.tensor([0, 8, 7, 2], dtype=torch.int32, device=dev)
    active = torch.ones(4, dtype=torch.bool, device=dev)
    cyc, local = ehu.service_schedule(shift, active, sp=5)
    n = ehu.num_cycles(shift, active, sp=5)
    print(f"  products A-D alignments {list(map(int, shift))}")
    print(f"  cycles needed: {int(n)}")
    for i, name in enumerate("ABCD"):
        print(f"  {name}: served in cycle {int(cyc[i])}, "
              f"local shift {int(local[i])}")

    print("\n=== 4. Area/power model (calibrated to the paper's 7nm) ===")
    for name, d in paper_designs().items():
        a4, p4 = efficiency(d, INT4)
        af, pf = efficiency(d, FP16)
        fmt = lambda v: f"{v:6.2f}" if v is not None else "    --"
        print(f"  {name:9s} INT4: {fmt(a4)} TOPS/mm2 {fmt(p4)} TOPS/W"
              f"   FP16: {fmt(af)} TFLOPS/mm2 {fmt(pf)} TFLOPS/W")


if __name__ == "__main__":
    main()
