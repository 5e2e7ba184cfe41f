"""Fig. 3 reproduction: error of the approximate FP-IP vs IPU precision
(mirror of ``benchmarks/fig3_error.py``).

For each accumulator (FP16/FP32) and input distribution (Laplace, Normal,
Uniform — the paper's synthetic proxies for DNN tensors), measure the
median absolute error, absolute relative error (%), and contaminated
bits against the FP32-CPU (f64 here) reference, over IPU precisions.

Paper's conclusions to reproduce:
  * FP16 accumulation: errors < 1e-6 and 0 contaminated bits at w >= 16
  * FP32 accumulation: errors < 1e-5 at w >= 26; min contaminated at 27-28

The (accum, dist, w) grid is declared as a ``repro_torch.exp`` sweep;
each cell draws its inputs from a per-distribution seed so any cell is
reproducible in isolation (and across worker processes). The FP-IP runs
through ``repro_torch.core.ipu.fp16_inner_product_raw`` on ``--device``
(``cuda`` by default; without CUDA it raises, ``--device cpu`` runs it
on the CPU). The integer datapath is bit-exact on either device, so the
rows are the same, and the same as the reference's.

    PYTHONPATH=src python -m repro_torch.studies.fig3_error [--device cpu]
"""
import numpy as np
import torch

from repro_torch import exp
from repro_torch.core.ipu import IPUConfig, fp16_inner_product_raw
from repro_torch.device import resolve_device
from repro_torch.studies.common import emit, engine_main, row

N = 16          # IPU width
LENGTH = 64     # inner-product length
SAMPLES = 400   # inner products per cell (median reported)

_DIST_IDS = {"laplace": 1, "normal": 2, "uniform": 3}


def approx_value(a, b, cfg, device=None) -> np.ndarray:
    """Raw non-normalized accumulator value in f64 — the paper's Fig.-3
    metric isolates the IPU-precision truncation error BEFORE the output
    format rounds it (an FP16-rounded output is never within 1e-6 of the
    reference; the accumulator is). ``a``, ``b`` are numpy f16 arrays;
    the FP-IP runs on ``device`` (the card unless it says otherwise)."""
    device = resolve_device(device)
    acc, exp_ = fp16_inner_product_raw(torch.as_tensor(a, device=device),
                                       torch.as_tensor(b, device=device),
                                       cfg)
    hi = acc.hi.cpu().numpy().astype(np.float64)
    lo = acc.lo.cpu().numpy().astype(np.float64)
    e = exp_.cpu().numpy().astype(np.int64)
    return (hi * 2.0 ** 24 + lo) * np.exp2(np.clip(e, -200, 200) - 30.0)


def draw(rng, dist, shape):
    if dist == "laplace":
        return rng.laplace(0, 1, shape)
    if dist == "normal":
        return rng.normal(0, 1, shape)
    return rng.uniform(-1, 1, shape)


def contaminated_bits(approx: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Differing mantissa bits vs the f32 reference (paper's metric)."""
    a = np.asarray(approx, np.float32).view(np.uint32).astype(np.int64)
    r = np.asarray(ref, np.float32).view(np.uint32).astype(np.int64)
    x = np.bitwise_xor(a, r)
    out = np.zeros_like(x)
    nz = x != 0
    out[nz] = np.floor(np.log2(x[nz])) + 1
    return np.minimum(out, 32)


def operands(dist: str, length: int = LENGTH, samples: int = SAMPLES,
             seed: int = 0):
    """One cell's f16 operands ``a``, ``b`` (samples x length), drawn
    from the per-distribution seed."""
    rng = np.random.default_rng([seed, _DIST_IDS[dist]])
    a = np.asarray(draw(rng, dist, (samples, length)), np.float16)
    b = np.asarray(draw(rng, dist, (samples, length)), np.float16)
    return a, b


def ipu_config(accum: str, w: int, n: int = N) -> IPUConfig:
    """One cell's IPU: w < 10 is modelled as a 10-bit datapath with the
    software mask at w (the truncation study of §3.1)."""
    return IPUConfig(n=n, w=max(min(w, 28), 10), accum=accum,
                     sw_precision=w)


def eval_point(accum: str, dist: str, w: int, n: int = N,
               length: int = LENGTH, samples: int = SAMPLES,
               seed: int = 0, device: str = "cuda") -> dict:
    """One Fig.-3 cell: error metrics of the approximate FP-IP."""
    a, b = operands(dist, length, samples, seed)
    ref = (a.astype(np.float64) * b.astype(np.float64)).sum(-1)
    ref32 = ref.astype(np.float32)
    got = approx_value(a, b, ipu_config(accum, w, n), device)
    abs_err = np.abs(got - ref)
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)
    cb = contaminated_bits(got, ref32)
    return {
        "median_abs_err": float(np.median(abs_err)),
        "median_rel_err_pct": float(np.median(rel) * 100),
        "median_contaminated_bits": float(np.median(cb)),
        "mean_contaminated_bits": float(np.mean(cb)),
    }


PRECISIONS = [8, 10, 12, 14, 16, 20, 22, 24, 26, 27, 28]


def spec() -> exp.SweepSpec:
    return exp.SweepSpec(
        name="fig3_error", fn="repro_torch.studies.fig3_error:eval_point",
        axes={"accum": ["fp16", "fp32"],
              "dist": ["laplace", "normal", "uniform"],
              "w": PRECISIONS},
        fixed={"n": N, "length": LENGTH, "samples": SAMPLES, "seed": 0},
        filters=[lambda p: not (p["accum"] == "fp16" and p["w"] > 16)])


def run(verbose: bool = True, engine: exp.EngineConfig = None):
    engine = engine or exp.EngineConfig()
    res, _ = exp.run_sweep(spec(), engine)
    results = {}
    for p, r in res:
        kw = p.kwargs
        key = f"{kw['accum']}/{kw['dist']}/w{kw['w']}"
        results[key] = r
        if verbose:
            row(f"fig3/{key}", 0.0,
                f"abs={r['median_abs_err']:.2e} "
                f"rel%={r['median_rel_err_pct']:.2e} "
                f"cbits={r['median_contaminated_bits']:.1f}")
    # paper-claim checks (functional forms; the paper's absolute 1e-6 at
    # w=16 depends on its input scaling — see EXPERIMENTS.md reproduction
    # notes. The operative claims: w=16 error is far below FP16's own
    # representational noise (2^-11 relative), so 16b suffices for FP16
    # accumulation; w>=26-28 is exact to the FP32 reference.)
    fp16_ulp_rel = 100 * 2.0 ** -11  # percent
    claims = {
        "fp16_w16_below_fp16_noise": (
            results["fp16/laplace/w16"]["median_rel_err_pct"]
            < 0.1 * fp16_ulp_rel),
        "fp16_monotone": (
            results["fp16/laplace/w12"]["median_abs_err"]
            >= results["fp16/laplace/w14"]["median_abs_err"]
            >= results["fp16/laplace/w16"]["median_abs_err"]),
        "fp32_w26_zero_contam":
            results["fp32/laplace/w26"]["median_contaminated_bits"] == 0,
        "fp32_w28_zero_contam":
            results["fp32/laplace/w28"]["median_contaminated_bits"] == 0,
        "fp32_monotone": (
            results["fp32/normal/w12"]["median_abs_err"]
            >= results["fp32/normal/w20"]["median_abs_err"]
            >= results["fp32/normal/w28"]["median_abs_err"]),
    }
    results["claims"] = claims
    results["rows"] = exp.rows_from(res, "fig3_error")
    emit("fig3_error", results)
    if verbose:
        print("fig3 claims:", claims)
    return results


def main(argv=None):
    engine_main(run, argv, __doc__)


if __name__ == "__main__":
    main()
