"""End-to-end serving example (mirror of ``examples/serve_lm.py``).

Serves a qwen2-family model through the ``repro_torch.serving`` runtime
under mixed-precision policies — the paper's technique as deployment
configuration. Two modes:

* single engine (``--policy`` / ``--plan``): continuous batching with
  chunked prefill admission under one precision policy (engine tuning
  via ``EngineConfig``, per-request decoding via ``SamplingParams`` —
  try ``--temperature 0.8``), printing the per-projection routing
  report for plans;
* multi-replica router (``--replicas``): each replica carries its own
  policy or searched plan, and the plan-aware router splits a mixed
  workload (a third of the requests are accuracy-tagged) by the
  simulator-backed cost model.

``main`` serves ``reduced("qwen2-0.5b")``, as the reference's does;
``run_single`` and ``run_router`` take any configuration (the full-width
one too). Weights are ``registry.build(cfg).init(seed=0, device)``:
jax's PRNG cannot be repeated in torch, so the streams are the port's
own. Everything runs on ``--device`` (``cuda`` by default; without CUDA
it raises, ``--device cpu`` runs the plain PyTorch path).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
        [--policy int4_serving]
    PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
        --plan results/plans/qwen2_0_5b.json
    PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
        --replicas int8_serving,plan:results/plans/qwen2_0_5b.json
"""
import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import reduced
from repro_torch.device import resolve_device
from repro_torch.serving import (EngineConfig, Request, Router,
                                 SamplingParams, ServingEngine,
                                 build_replicas)


def _mixed_workload(cfg, n, max_new, tagged_every=3, temperature=0.0):
    rng = np.random.default_rng(0)
    sampling = SamplingParams(temperature=temperature)
    reqs = []
    for rid in range(n):
        prompt = rng.integers(0, cfg.vocab, int(rng.integers(4, 12)),
                              dtype=np.int32)
        reqs.append(Request(
            rid=rid, prompt=prompt, max_new_tokens=max_new,
            sampling=sampling,
            tags=("accuracy",) if rid % tagged_every == 0 else ()))
    return reqs


def _pct(block, key="p50"):
    return f"{block.get(key, 0) * 1e3:.1f}ms" if block else "n/a"


def _engine_config(args):
    return EngineConfig(
        batch_slots=args.slots, cache_len=128,
        decode_block=args.decode_block,
        act_calibration="auto" if args.calibrate else None)


def _summary(completed, dt, ticks, metrics):
    """What a caller reads off a run: tokens per request, tok/s, TTFT."""
    total_new = sum(r.new_tokens for r in completed.values())
    return {"ticks": ticks,
            "new_tokens": {rid: r.new_tokens
                           for rid, r in sorted(completed.items())},
            "wall_s": dt, "tok_s": total_new / dt, "metrics": metrics}


def run_router(args, cfg):
    """Serve the mixed workload through a router over ``--replicas``
    (policies or ``plan:`` files) of ``cfg``; prints the reference's
    report and returns the run's summary."""
    device = resolve_device(args.device)
    policies = [p for p in args.replicas.split(",") if p]
    replicas = build_replicas(cfg, policies, config=_engine_config(args),
                              device=device)
    router = Router(replicas, strategy=args.strategy)
    for rep in replicas:
        storage = "prepared" if rep.engine.prepared else "dynamic"
        print(f"replica {rep.name}: cycles/tok="
              f"{rep.cost['cycles_per_token']:.4g} "
              f"tops/W={rep.cost['tops_per_w']:.3g} "
              f"acc_proxy={rep.cost['acc_proxy']:.3g} "
              f"weights={rep.cost['weight_bytes']['projections']}B "
              f"({storage})")

    t0 = time.time()
    for req in _mixed_workload(cfg, args.requests, args.max_new,
                               temperature=args.temperature):
        router.submit(req)
    ticks = router.run_until_drained()
    dt = time.time() - t0

    completed = router.completed
    total_new = sum(r.new_tokens for r in completed.values())
    print(f"\nstrategy={router.strategy} requests={args.requests} "
          f"completed={len(completed)} ticks={ticks} "
          f"({total_new / dt:.1f} tok/s on {device.type})")
    report = router.report()
    for name, rep in report["replicas"].items():
        m = rep["metrics"]
        print(f"  {name}: routed={rep['routed']} "
              f"ttft_p50={_pct(m['ttft_s'])} "
              f"queue_p90={_pct(m['queue_delay_s'], 'p90')} "
              f"prefill_calls={m['counters']['prefill_calls']}")
    return _summary(completed, dt, ticks, {
        name: rep["metrics"] for name, rep in report["replicas"].items()})


def run_single(args, cfg):
    """Serve the mixed workload on one engine of ``cfg`` under
    ``--policy`` or ``--plan``; prints the reference's report and
    returns the run's summary."""
    device = resolve_device(args.device)
    policy_name = f"plan:{args.plan}" if args.plan else args.policy
    cfg = dataclasses.replace(cfg, precision_policy=policy_name)
    from repro_torch.models import registry
    api = registry.build(cfg)
    params = api.init(seed=0, device=device)
    engine = ServingEngine(cfg, api, params, config=_engine_config(args),
                           device=device)
    if args.plan:
        from repro_torch.autotune.plan import load_plan
        plan = load_plan(args.plan)
        print(f"plan={plan.name} (arch {plan.arch}, "
              f"{len(plan.frontier)} frontier plans)")
        for path, mode in sorted(engine.routing_report().items()):
            print(f"  route {path}: {mode}")

    t0 = time.time()
    for req in _mixed_workload(cfg, args.requests, args.max_new,
                               temperature=args.temperature):
        engine.submit(req)
    ticks = engine.run_until_drained()
    dt = time.time() - t0

    total_new = sum(r.new_tokens for r in engine.completed.values())
    m = engine.metrics()
    print(f"policy={policy_name} requests={args.requests} "
          f"slots={args.slots} ticks={ticks} "
          f"decode_block={engine.decode_block}"
          + (" calibrated" if m["act_calibrated"] else ""))
    print(f"generated {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s on {device.type}); "
          f"ttft_p50={_pct(m['ttft_s'])} "
          f"queue_p90={_pct(m['queue_delay_s'], 'p90')} "
          f"prefill_calls={m['counters']['prefill_calls']} "
          f"host_syncs={m['counters']['host_syncs']}")
    for rid in sorted(engine.completed)[:3]:
        r = engine.completed[rid]
        print(f"  req{rid}: prompt={list(r.prompt[:6])}... -> "
              f"completion={r.tokens[len(r.prompt):][:8]}")

    # what the accelerator model says about this policy
    from repro_torch.core.area_power import (INT4, INT8, FP16, efficiency,
                                             paper_designs)
    d = paper_designs()["MC-IPU4"]
    wl = {"int4_serving": INT4, "int8_serving": INT8}.get(args.policy)
    if wl is not None and not args.plan:
        a, p = efficiency(d, wl)
        af, pf = efficiency(d, FP16)
        print(f"\nMC-IPU4 accelerator at this policy: {a:.1f} TOPS/mm2, "
              f"{p:.2f} TOPS/W (vs FP16 path {af:.1f}/{pf:.2f}) — the "
              f"INT4 datapath the paper optimizes for.")
    return _summary(engine.completed, dt, ticks, m)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--policy", default="int4_serving",
                    choices=["bf16", "int8_serving", "int4_serving",
                             "paper_hybrid"])
    ap.add_argument("--plan", default=None, metavar="PLAN_JSON",
                    help="serve under a precision-plan artifact "
                         "(overrides --policy)")
    ap.add_argument("--replicas", default=None, metavar="POLICY,POLICY,..",
                    help="run the multi-replica router instead: comma-"
                         "separated policy names or plan:<file> refs")
    ap.add_argument("--strategy", default="plan_aware",
                    choices=Router.STRATEGIES)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--decode-block", type=int, default=1,
                    help="tokens decoded per host dispatch (one program "
                         "with on-device greedy selection; 1 = per-token; "
                         "quantized policies also need --calibrate)")
    ap.add_argument("--calibrate", action="store_true",
                    help="calibrate static activation scales at engine "
                         "construction (drops the per-token absmax)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature "
                         "(SamplingParams; 0 = greedy, seeded on-device "
                         "sampling otherwise)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the engines run on (default cuda; "
                         "'cpu' runs the plain PyTorch path)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = reduced("qwen2-0.5b")
    if args.replicas:
        run_router(args, cfg)
    else:
        run_single(args, cfg)


if __name__ == "__main__":
    main()
