"""Roofline tables from the port's dry-run records
(``results/torch/dryrun/*.json``), and sweep-engine benchmark rows
(mirror of ``tools/roofline_table.py``).

Adds the analytic memory floor to the counted terms: the dry-run's byte
counts are unfused upper bounds (every op's operands counted at HBM),
so the credible memory term lies in [analytic floor, counted]; the
roofline fraction is reported against the counted bound (conservative)
with the floor alongside, and is not clipped: above 1, the counted
FLOPs or bytes fall short of the ideal's. Decode steps are scored
against their memory ideal (weights and cache read once per token)
rather than the compute ideal. The constants are the H100 SXM data
sheet's (``launch.roofline``): every time here is an estimate, not a
measurement.

    PYTHONPATH=src python -m repro_torch.tools.roofline_table [--dir results/torch/dryrun]
    PYTHONPATH=src python -m repro_torch.tools.roofline_table --bench [results/bench_torch]
"""
import argparse
import glob
import json
import os

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS

# the MemTracker categories of a cell's inputs (the state, the batch and
# the caches): the counterpart of XLA's argument size
ARGUMENT_CATEGORIES = ("Parameter", "Optstate", "Other")


def argument_bytes(rec) -> float:
    mem = rec.get("memory", {})
    return float(sum(mem.get(k, 0) for k in ARGUMENT_CATEGORIES))


def analytic_floor_bytes(rec) -> float:
    """Minimum global HBM traffic: weights touched once per step (x3 for
    train: read + grad write + opt update read/write approx), plus
    activations written+read once, plus KV cache traffic for decode."""
    cfg = get_config(rec["arch"])
    shape = SHAPES[rec["shape"]]
    n = cfg.params_count()
    n_active = cfg.active_params_count()
    tokens = shape.seq_len * shape.global_batch
    if rec["kind"] == "train":
        # fwd+bwd touch active weights ~3x in bf16 + f32 optimizer states
        w = 3 * n_active * 2 + 3 * n * 4
        acts = 2 * tokens * cfg.d_model * cfg.n_layers * 2
        return float(w + acts)
    if rec["kind"] == "prefill":
        w = n_active * 2
        acts = 2 * tokens * cfg.d_model * cfg.n_layers * 2
        return float(w + acts)
    # decode: weights + cache read per token
    cache = argument_bytes(rec) * rec.get("chips", 1)
    return float(n_active * 2 + cache * 0.5)


def load(dirpath):
    recs = []
    for p in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def enrich(rec):
    r = rec.get("roofline")
    if not r:
        return None
    chips = rec["chips"]
    floor = analytic_floor_bytes(rec)
    mem_floor_s = floor / chips / HBM_BW
    ideal_compute_s = r["model_flops"] / chips / PEAK_FLOPS
    ideal_s = max(ideal_compute_s, mem_floor_s)
    bound_s = max(r["compute_s"], r["memory_s"], r["collective_s"])
    out = dict(r)
    out["mem_floor_s"] = mem_floor_s
    out["ideal_s"] = ideal_s
    # not clipped at 1 as the reference's is: the counts are the port's
    # own, and a share above 1 shows an undercount
    out["fraction"] = ideal_s / bound_s if bound_s else 0.0
    out["fits_card"] = rec.get("fits_card")
    out["per_device_gb"] = (rec.get("per_device_bytes", 0) or 0) / 1e9
    out["compile_s"] = rec.get("compile_s")
    out["coll_by_op"] = rec.get("collectives", {}).get("by_op", {})
    return out


def fmt_row(e):
    return (f"| {e['arch']} | {e['shape']} | {e['mesh']} "
            f"| {e['compute_s']*1e3:9.2f} | {e['memory_s']*1e3:9.2f} "
            f"| {e['mem_floor_s']*1e3:9.2f} | {e['collective_s']*1e3:9.2f} "
            f"| {e['bottleneck']:10s} | {e['fraction']:.3f} "
            f"| {e['flops_ratio']:.2f} | {e['per_device_gb']:.2f} |")


def _flat_value(value):
    """Scalar-ize a sweep row value for tabular display."""
    if isinstance(value, dict):
        return {k: v for k, v in value.items()
                if isinstance(v, (int, float, bool, str)) or v is None}
    return {"value": value}


def bench_tables(dirpath: str) -> None:
    """Render the structured sweep rows every sweep-engine benchmark
    emits (payload key 'rows') as one markdown table per sweep."""
    for path in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(path) as f:
            payload = json.load(f)
        rows = payload.get("rows")
        if not rows:
            continue
        by_sweep = {}
        for r in rows:
            by_sweep.setdefault(r["sweep"], []).append(r)
        for sweep, srows in by_sweep.items():
            params = list(srows[0]["params"])
            metrics = list(_flat_value(srows[0]["value"]))
            print(f"\n### {sweep} ({os.path.basename(path)})\n")
            print("| " + " | ".join(params + metrics) + " |")
            print("|" + "---|" * (len(params) + len(metrics)))
            for r in srows:
                vals = [str(r["params"].get(k)) for k in params]
                flat = _flat_value(r["value"])
                for m in metrics:
                    v = flat.get(m)
                    vals.append(f"{v:.4g}" if isinstance(v, float)
                                else str(v))
                print("| " + " | ".join(vals) + " |")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default="results/torch/dryrun")
    ap.add_argument("--bench", nargs="?", const="results/bench_torch",
                    default=None, metavar="DIR",
                    help="render sweep-engine benchmark rows instead of "
                         "the dryrun roofline table")
    args = ap.parse_args(argv)
    if args.bench:
        bench_tables(args.bench)
        return 0
    recs = load(args.dir)
    header = ("| arch | shape | mesh | compute ms | memCounted ms "
              "| memFloor ms | coll ms | bottleneck | frac | MODEL/counted "
              "| GB/dev |")
    sep = "|" + "---|" * 11
    print(header)
    print(sep)
    rows = []
    for rec in recs:
        if rec.get("status") != "ok":
            continue
        e = enrich(rec)
        if e:
            rows.append(e)
            print(fmt_row(e))
    # summary stats
    ok = [e for e in rows if e["mesh"] == "pod16x16"]
    worst = sorted(ok, key=lambda e: e["fraction"])[:3]
    collb = sorted(ok, key=lambda e: -e["collective_s"])[:3]
    print("\nworst roofline fractions (single-pod):",
          [(e["arch"], e["shape"], round(e["fraction"], 3))
           for e in worst])
    print("most collective-heavy:",
          [(e["arch"], e["shape"], f"{e['collective_s']*1e3:.1f}ms")
           for e in collb])
    misfits = [e for e in rows if e["fits_card"] is False]
    print("cells exceeding the card's memory:",
          [(e["arch"], e["shape"], e["mesh"], round(e["per_device_gb"], 1))
           for e in misfits])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
