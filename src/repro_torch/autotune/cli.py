"""``python -m repro_torch.autotune`` — search / score / report / smoke
(the port of ``repro/autotune/cli.py``; the same subcommands, flags and
printed text).

search  — build the cached score table for a model and emit the selected
          PrecisionPlan (+ Pareto frontier) as a versioned JSON artifact.
score   — re-derive the metrics of an existing plan from the (cached)
          score table and print them.
report  — render a plan's Pareto frontier as a markdown table.
smoke   — CI contract: a tiny 2-layer search executes > 0 evaluations
          cold and exactly 0 on an immediate warm re-run.

All evaluations go through the ``repro_torch.exp`` cache; the engine
flags (``--jobs/--no-cache/--cache-dir/--device``) behave exactly as in
``repro_torch.studies``. The accuracy objective runs on ``--device``
(``cuda`` by default): without CUDA, ``search``, ``score`` and ``smoke``
raise unless given ``--device cpu``, also with ``--no-probe`` (the
engine resolves the device of every sweep whose eval function takes
one). Plans go to ``results/plans_torch/<arch>.json`` by default, never
over the reference's ``results/plans/``.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import tempfile
from typing import List, Optional

from repro_torch import exp
from repro_torch.autotune import candidates as cand_mod
from repro_torch.autotune import search as search_mod
from repro_torch.autotune.plan import PrecisionPlan, load_plan

# the port's own directory: the reference's committed plans live in
# results/plans/, which a port search must never overwrite
DEFAULT_PLAN_DIR = "results/plans_torch"


def resolve_arch(name: str) -> str:
    """Accept registry ids and filesystem-safe aliases
    (``qwen2_0_5b`` -> ``qwen2-0.5b``)."""
    from repro_torch.configs import ARCH_IDS

    def norm(s: str) -> str:
        return re.sub(r"[^a-z0-9]+", "_", s.lower()).strip("_")

    if name in ARCH_IDS:
        return name
    for aid in ARCH_IDS:
        if norm(aid) == norm(name):
            return aid
    raise SystemExit(f"unknown model {name!r}; known: "
                     f"{', '.join(ARCH_IDS)}")


def arch_slug(arch: str) -> str:
    return re.sub(r"[^a-z0-9]+", "_", arch.lower()).strip("_")


def _candidates(args) -> tuple:
    group_sizes = tuple(None if g <= 0 else g
                        for g in getattr(args, "group_sizes", [0]))
    return cand_mod.default_candidates(
        widths=tuple(args.widths), clusters=tuple(args.clusters),
        modes=tuple(args.modes), group_sizes=group_sizes)


def _table(args, engine, arch, shapes):
    from repro_torch.configs import get_config, reduced
    cfg = reduced(arch) if shapes == "reduced" else get_config(arch)
    groups = cand_mod.groups_for(cfg)
    return search_mod.build_scores(
        arch, groups, _candidates(args), engine, seq=args.seq,
        seed=args.seed, shapes=shapes, probe=not args.no_probe)


def _check_device(device: str) -> None:
    """Resolve ``--device`` before any sweep: the accuracy objective
    takes the device (with or without the probe), so without CUDA a
    search needs ``--device cpu``; nothing falls back."""
    from repro_torch.device import resolve_device
    try:
        resolve_device(device)
    except RuntimeError as e:
        raise RuntimeError(
            f"{e}: the planner's accuracy objective runs on --device "
            f"(default cuda); pass --device cpu to score on the CPU") \
            from None


def _engine(args) -> exp.EngineConfig:
    _check_device(args.device)
    return exp.EngineConfig.from_args(args)


def _add_search_args(p: argparse.ArgumentParser):
    p.add_argument("--model", required=True,
                   help="registry arch id (aliases like qwen2_0_5b ok)")
    p.add_argument("--seq", type=int, default=1,
                   help="tokens per forward the simulator scores "
                        "(1 = decode step)")
    p.add_argument("--seed", type=int, default=0,
                   help="RNG seed threaded through every eval point "
                        "(part of the cache key)")
    p.add_argument("--widths", type=int, nargs="+", default=[12, 16, 20, 28],
                   help="fp16_ipu adder precisions to enumerate")
    p.add_argument("--clusters", type=int, nargs="+", default=[1],
                   help="cluster sizes to enumerate")
    p.add_argument("--modes", nargs="+",
                   default=["bf16", "fp16_ipu", "int8", "int4",
                            "fp8", "fp4"],
                   help="candidate operand modes")
    p.add_argument("--group-sizes", type=int, nargs="+", default=[0],
                   help="per-group weight-scale sizes for the storage "
                        "modes (0 = per-out-channel scales)")
    p.add_argument("--no-probe", action="store_true",
                   help="skip the model forward-divergence probe "
                        "(analytic accuracy proxy only)")
    p.add_argument("--shapes", choices=["full", "reduced"], default="full",
                   help="score the published dims or the reduced config")
    exp.add_cli_args(p)


def cmd_search(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.autotune search")
    _add_search_args(ap)
    ap.add_argument("--acc-budget", type=float, default=None,
                    help="accuracy-proxy ceiling for plan selection "
                         "(default: uniform-INT8 accuracy)")
    ap.add_argument("--out", default=None,
                    help=f"plan path (default {DEFAULT_PLAN_DIR}/<arch>.json)")
    ap.add_argument("--calibrate", action="store_true",
                    help="run a short activation-calibration pass "
                         "(quant.calibrate on the reduced config, under "
                         "the selected plan's own policy) and embed the "
                         "static act scales in the plan artifact")
    args = ap.parse_args(argv)
    arch = resolve_arch(args.model)
    engine = _engine(args)

    import dataclasses
    table = _table(args, engine, arch, args.shapes)
    plan = search_mod.search_plan(arch, table, acc_budget=args.acc_budget)
    # record the eval-point parameters so downstream scoring (bench,
    # `score`) addresses the exact same cached points
    plan = dataclasses.replace(plan, meta={
        **plan.meta, "seq": args.seq, "seed": args.seed,
        "shapes": args.shapes, "probe": not args.no_probe})
    if args.calibrate:
        plan = dataclasses.replace(
            plan, act_scales=plan_act_scales(plan, seed=args.seed,
                                             device=args.device))
    out = args.out or f"{DEFAULT_PLAN_DIR}/{arch_slug(arch)}.json"
    plan.save(out)

    print(f"# {engine.total.summary()}")
    print(f"plan {plan.name} ({arch}) -> {out}")
    print(f"  selected: {plan.meta['selected_from']}  "
          f"frontier: {len(plan.frontier)} non-dominated plans")
    m = plan.metrics
    print(f"  cycles={m['cycles']:.3g} (ideal {m['ideal_cycles']:.3g})  "
          f"tops/mm2={m['tops_per_mm2']:.2f}  tops/W={m['tops_per_w']:.3f}  "
          f"acc_proxy={m['acc_proxy']:.3g}")
    for g, mode in m["modes"].items():
        print(f"    {g}: {mode}")
    return 0


def cmd_score(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.autotune score")
    _add_search_args(ap)
    ap.add_argument("--plan", required=True, help="plan JSON to score")
    args = ap.parse_args(argv)
    arch = resolve_arch(args.model)
    engine = _engine(args)
    plan = load_plan(args.plan)

    table = _table(args, engine, arch, args.shapes)
    assign = {}
    for rule in plan.rules:
        assign[rule.group] = cand_mod.canonical(
            rule.mode, w=rule.w, sw_precision=rule.sw_precision,
            cluster=rule.cluster, group_size=rule.group_size)
    missing = [g.name for g in table.groups if g.name not in assign]
    if missing:
        raise SystemExit(f"plan {plan.name} lacks groups {missing}")
    metrics = search_mod.plan_metrics(table, assign)
    print(f"# {engine.total.summary()}")
    json.dump({"plan": plan.name, "arch": arch, "metrics": metrics},
              sys.stdout, indent=1, sort_keys=True)
    print()
    return 0


def plan_act_scales(plan: PrecisionPlan, seed: int = 0,
                    device=None) -> dict:
    """Calibrated static activation scales for ``plan``: forwards random
    token batches through the family-preserving reduced model under the
    plan's own policy (so downstream activations carry the plan's
    quantization noise) and records every projection's input absmax —
    the ``quant.calibrate`` pass, keyed to ride in the plan artifact.

    Scales are measured on ``registry.build(cfg).init(0, device)`` — the
    port's convention of every serving entry point (serve_lm, the
    serving smoke, build_replicas): seed 0 drawn by a torch generator on
    ``device`` (CUDA by default; raises without it unless
    ``device="cpu"``), so scales calibrated on the card belong to the
    card's draw and scales calibrated on the CPU to the CPU's, which
    differ — regardless of the search ``seed``, which only drives the
    calibration token draws (numpy). A replica serving other weights
    should re-calibrate (``act_calibration="auto"`` on a plan without
    scales, or an explicit ``calibrate_act_scales`` dict) rather than
    consume plan scales measured on other weights."""
    import dataclasses as dc

    from repro_torch.configs import reduced
    from repro_torch.core.policy import POLICIES, register_policy
    from repro_torch.device import resolve_device
    from repro_torch.models import registry
    from repro_torch.quant.calibrate import calibrate_act_scales

    device = resolve_device(device)
    name = f"_calib/{plan.name}"
    register_policy(dc.replace(plan.to_policy(), name=name))
    try:
        cfg = dc.replace(reduced(plan.arch), precision_policy=name)
        api = registry.build(cfg)
        params = api.init(0, device)
        return calibrate_act_scales(cfg, api, params, seed=seed,
                                    device=device)
    finally:
        POLICIES.pop(name, None)


def plan_weight_bytes(arch: str, modes, shapes: str = "full"
                      ) -> Optional[float]:
    """Estimated weight-resident bytes of serving ``arch`` with each
    projection group stored in its assigned mode (quant.prepare storage
    formats: packed nibbles for int4, int8 + per-out-channel scales,
    fp16 casts; bf16/fp32 raw). Matches what the serving engine keeps
    resident: the head/embedding group is costed at fp32 regardless of
    its assigned mode (``registry.projection_paths`` never routes it
    through preparation), and MoE experts are costed at their *stored*
    count (all ``n_experts``, not the ``top_k`` executed per token).
    None when the arch is unknown."""
    from repro_torch.models.registry import projection_groups
    from repro_torch.quant.prepare import MODE_BYTES_PER_PARAM
    try:
        from repro_torch.configs import get_config, reduced
        cfg = reduced(arch) if shapes == "reduced" else get_config(arch)
    except KeyError:
        return None
    total = 0.0
    for g in projection_groups(cfg):
        mode = modes.get(g.name)
        if mode is None:
            return None              # partial assignment: no estimate
        count = g.count
        if g.name == "moe_experts" and cfg.moe:
            count = 3 * cfg.moe.n_experts * cfg.n_layers
        if g.name == "head":
            mode = "fp32"            # never prepared: stays raw resident
        total += g.d_in * g.d_out * count * MODE_BYTES_PER_PARAM[mode]
        if mode in ("int8", "int4", "fp8", "fp4"):
            total += g.d_out * count * 4     # f32 scales per out-channel
    return total


def _fmt_bytes(n: Optional[float]) -> str:
    if n is None:
        return "?"
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.2f}{unit}"
        n /= 1024
    return f"{n:.2f}GB"


def render_report(plan: PrecisionPlan) -> str:
    """Markdown Pareto report of a plan artifact."""
    shapes = plan.meta.get("shapes", "full")
    lines = [
        f"# Precision plan `{plan.name}` ({plan.arch})",
        "",
        f"Selected from `{plan.meta.get('selected_from', '?')}` — "
        f"{len(plan.frontier)} non-dominated plans out of "
        f"{plan.meta.get('n_pool', '?')} searched "
        f"({plan.meta.get('n_groups', '?')} groups x "
        f"{plan.meta.get('n_candidates', '?')} candidates).",
        "",
        "## Selected assignment",
        "",
        "| group | mode | w | P | cluster |",
        "|---|---|---|---|---|",
    ]
    for r in plan.rules:
        lines.append(f"| {r.group} | {r.mode} | {r.w} | {r.sw_precision} "
                     f"| {r.cluster} |")
    lines += [
        "",
        "## Pareto frontier (cycles v, acc_proxy v, TOPS/W ^)",
        "",
        "| plan | cycles | TOPS/mm2 | TOPS/W | acc proxy | weights "
        "| modes |",
        "|---|---|---|---|---|---|---|",
    ]
    for p in plan.frontier:
        m = p["metrics"]
        modes = ", ".join(f"{g}:{mo}" for g, mo in m["modes"].items())
        sel = " **(selected)**" if p["name"] == plan.meta.get(
            "selected_from") else ""
        wb = plan_weight_bytes(plan.arch, m["modes"], shapes)
        lines.append(
            f"| {p['name']}{sel} | {m['cycles']:.4g} "
            f"| {m['tops_per_mm2']:.2f} | {m['tops_per_w']:.3f} "
            f"| {m['acc_proxy']:.3g} | {_fmt_bytes(wb)} | {modes} |")
    return "\n".join(lines) + "\n"


def cmd_report(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.autotune report")
    ap.add_argument("--plan", required=True)
    ap.add_argument("--out", default=None,
                    help="write markdown here instead of stdout")
    args = ap.parse_args(argv)
    text = render_report(load_plan(args.plan))
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"report -> {args.out}")
    else:
        print(text, end="")
    return 0


def cmd_smoke(argv: List[str]) -> int:
    """Tiny 2-layer search, twice: cold executes > 0 points, an
    immediate warm re-run executes exactly 0 (the CI contract)."""
    ap = argparse.ArgumentParser(prog="repro_torch.autotune smoke")
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="device of the divergence probe (default cuda; "
                         "'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)
    _check_device(args.device)
    base = args.cache_dir or tempfile.gettempdir()
    import os
    os.makedirs(base, exist_ok=True)
    cache_dir = tempfile.mkdtemp(dir=base, prefix="autotune-smoke-")

    arch = resolve_arch("qwen2-0.5b")
    from repro_torch.configs import reduced
    cfg = reduced(arch)          # 2-layer toy config
    assert cfg.n_layers == 2, cfg.n_layers
    groups = cand_mod.groups_for(cfg)
    cands = cand_mod.default_candidates(
        widths=(16,), clusters=(1,), modes=("bf16", "fp16_ipu", "int8"))

    def run(engine):
        table = search_mod.build_scores(
            arch, groups, cands, engine, seq=1, seed=0, shapes="reduced",
            probe=True)
        return search_mod.search_plan(arch, table)

    cold = exp.EngineConfig(jobs=args.jobs, cache=exp.ResultCache(cache_dir),
                            progress=True, device=args.device)
    plan = run(cold)
    assert cold.total.n_executed > 0, "cold run executed no points"
    assert len(plan.frontier) >= 1, "empty Pareto frontier"

    warm = exp.EngineConfig(jobs=args.jobs, cache=exp.ResultCache(cache_dir),
                            progress=True, device=args.device)
    plan_warm = run(warm)
    assert warm.total.n_executed == 0, \
        f"warm run re-executed {warm.total.n_executed} points"
    assert plan_warm.to_json() == plan.to_json(), \
        "warm-cache plan differs from cold plan"

    # the plan round-trips through JSON into an executable policy
    path = os.path.join(cache_dir, "smoke_plan.json")
    plan.save(path)
    policy = load_plan(path).to_policy()
    assert policy.rules == plan.to_policy().rules, \
        "reloaded plan routes differently"
    import shutil
    shutil.rmtree(cache_dir, ignore_errors=True)
    print(f"autotune smoke OK: cold {cold.total.n_executed} executed, "
          f"warm {warm.total.n_cached} cached / 0 executed, "
          f"frontier {len(plan.frontier)}")
    return 0


COMMANDS = {"search": cmd_search, "score": cmd_score,
            "report": cmd_report, "smoke": cmd_smoke}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("subcommands:", ", ".join(COMMANDS))
        return 0 if argv else 2
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown subcommand {cmd!r}; want one of "
              f"{', '.join(COMMANDS)}", file=sys.stderr)
        return 2
    return COMMANDS[cmd](argv[1:])
