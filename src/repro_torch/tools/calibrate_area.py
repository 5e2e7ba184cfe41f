"""Fit the area/power Calibration constants to the paper's numbers
(mirror of ``tools/calibrate_area.py``, over the port's numpy copy of
the model; it takes no device).

Least-squares over log-ratios of all Table 1 cells plus the §4.2 relative
area deltas and the abstract headline gains. Run:

    PYTHONPATH=src python -m repro_torch.tools.calibrate_area

and paste the printed Calibration into area_power.DEFAULT_CAL.
"""
import dataclasses
import math

import numpy as np

from repro_torch.core import area_power as ap

PARAMS = ["a_scale", "b_scale", "alpha_add", "alpha_shift", "alpha_reg",
          "alpha_sram", "ctrl_area", "serial_area_factor",
          "serial_power_factor", "beta_mult", "beta_reg", "beta_sram",
          "misc_fraction"]
X0 = [0.1723, 9.64, 1.10, 0.42, 0.65, 0.30, 0.0, 0.5, 1.8,
      1.05e-3, 0.55e-3, 0.25e-3, 0.18]
LOWER = [0.01, 1.0, 0.2, 0.05, 0.1, 0.05, 0.0, 0.1, 1.0,
         0.2e-3, 0.1e-3, 0.05e-3, 0.05]
UPPER = [1.0, 50.0, 4.0, 2.0, 3.0, 1.5, 400.0, 1.5, 4.0,
         4e-3, 3e-3, 2e-3, 0.5]


def make_cal(x):
    kw = dict(zip(PARAMS, x))
    return dataclasses.replace(ap.Calibration(), **kw)


def residuals(x):
    cal = make_cal(x)
    res = []
    model = ap.table1_model(cal)
    for d, row in model.items():
        for wl, (a, p) in row.items():
            pa, pp = ap.PAPER_TABLE1[d][wl]
            if a is None or pa is None:
                continue
            res.append(math.log(a / pa))
            res.append(math.log(p / pp))
    deltas = ap.fig7_deltas(cal)
    for k, target in ap.PAPER_FIG7_DELTAS.items():
        res.append(3.0 * (deltas[k] - target))
    # headline targets: +46% TOPS/mm2, +25% TFLOPS/mm2, +63% TOPS/W,
    # +40% TFLOPS/W for the (16,1) point (paper abstract, 16-input).
    h = ap.headline_gains(1.3, cal)
    targets = {"tops_per_mm2_gain": 0.46, "tflops_per_mm2_gain": 0.25,
               "tops_per_w_gain": 0.63, "tflops_per_w_gain": 0.40}
    for k, t in targets.items():
        res.append(2.0 * (h[k] - t))
    return np.asarray(res)


def fit():
    """The least-squares solution (scipy's ``OptimizeResult``)."""
    from scipy.optimize import least_squares
    return least_squares(residuals, X0, bounds=(LOWER, UPPER),
                         xtol=1e-10, ftol=1e-10, max_nfev=4000)


def main():
    sol = fit()
    cal = make_cal(sol.x)
    print("# fitted Calibration:")
    for k, v in zip(PARAMS, sol.x):
        print(f"    {k}={v:.6g},")
    r = residuals(sol.x)
    print(f"# residual rms={np.sqrt((r**2).mean()):.4f} max={np.abs(r).max():.4f}")
    model = ap.table1_model(cal)
    errs = []
    for d, row in model.items():
        for wl, (a, p) in row.items():
            pa, pp = ap.PAPER_TABLE1[d][wl]
            if a is None:
                continue
            errs += [abs(a / pa - 1), abs(p / pp - 1)]
    print(f"# table1 median |err| {100*np.median(errs):.1f}%  "
          f"max {100*np.max(errs):.1f}%")
    print("# fig7:", {k: round(v, 3) for k, v in ap.fig7_deltas(cal).items()},
          "targets", ap.PAPER_FIG7_DELTAS)
    print("# headline:", {k: round(v, 3)
                          for k, v in ap.headline_gains(1.3, cal).items()})


if __name__ == "__main__":
    main()
