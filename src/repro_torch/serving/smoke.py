"""``python -m repro_torch.serving smoke`` — the serving runtime's contract
on the port's engine and router (mirror of ``repro/serving/smoke.py``).

A router over three replicas (int8_serving, bf16 and int4_serving,
tiny reduced qwen2) serves a mixed workload: a third of the requests are accuracy-tagged, priorities and
prompt lengths vary. The contract asserts:

  * every submitted request completes with exactly ``max_new_tokens``
    generated tokens, and both serving replicas receive traffic;
  * admission runs through the chunked prefill path: zero
    teacher-forced prompt tokens, > 0 prefill calls, TTFT and queue
    delay samples on every replica;
  * the int4 replica serves prepared weights: its decode step performs
    zero dynamic weight quantizations, its projection storage is at
    most 1/6 of the raw f32 bytes, and a control engine with
    preparation off shows the counter is live;
  * a second identical run routes identically;
  * the decode fast path (``--decode-block``, default 4) on a blocked,
    calibrated int8 replica: token-for-token the per-token engine's
    streams, one host sync a block, zero weight and activation quants a
    step;
  * the fused datapath: that replica resolved ``fused_executors="auto"``
    onto the fused executors and stages no operand, a staged control
    does, ``fused_executors="on"`` without prepared weights refuses
    construction, and an exact per-channel int8 (``fidelity_int8``)
    engine gives the same greedy streams fused and staged;
  * continuous batching on a bursty tick-driven trace: a long prompt
    streams through several prefill waves, queue pressure cuts blocks
    short and admits mid-block, stop ids end requests mid-budget, an
    oversized request admits with a trailing window, and the greedy
    streams equal a flags-off engine's on the same trace;
  * online cost correction: of two same-policy replicas, one slowed by
    a dilated clock, static costing sends every request to the slow one
    and online costing (measured tok/s) to the fast one;
  * with ``--trace PATH``, observability: a traced engine exports a
    valid, non-empty Chrome trace with every tick-phase span, every
    request stage and a ``compile:*`` span, and its counters equal an
    untraced engine's on the same workload.

Everything runs on ``--device`` (``cuda`` by default; without CUDA that
raises, and ``--device cpu`` runs the plain PyTorch versions), where the
engines replay their programs from CUDA graphs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional

import numpy as np

REPLICAS = ("int8_serving", "bf16", "int4_serving")
CACHE_LEN = 64


def _cfg(policy: Optional[str] = None):
    from repro_torch.configs import reduced
    cfg = reduced("qwen2-0.5b")
    assert cfg.n_layers == 2, cfg.n_layers   # tiny model: CI-sized
    if policy is not None:
        cfg = dataclasses.replace(cfg, precision_policy=policy)
    return cfg


def _prompt(rng, cfg):
    return rng.integers(0, cfg.vocab, int(rng.integers(3, 12)),
                        dtype=np.int32)


def _run_workload(requests: int, slots: int, max_new: int, seed: int,
                  device):
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import Request
    from repro_torch.serving.router import Router, build_replicas

    cfg = _cfg()
    replicas = build_replicas(cfg, REPLICAS,
                              config=EngineConfig(batch_slots=slots,
                                                  cache_len=CACHE_LEN),
                              device=device)
    router = Router(replicas, strategy="plan_aware")
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    for rid in range(requests):
        prompt = _prompt(rng, cfg)
        reqs.append(Request(
            rid=rid, prompt=prompt, max_new_tokens=max_new,
            priority=int(rng.integers(0, 3)),
            tags=("accuracy",) if rid % 3 == 0 else ()))
    for r in reqs:
        router.submit(r)
    ticks = router.run_until_drained()
    return router, reqs, ticks


def _serve_pair(policy: str, configs: Dict, requests: int, max_new: int,
                seed: int, device):
    """The same workload through one engine per entry of ``configs``
    ({key: EngineConfig without act scales}), sharing raw parameters and
    the first engine's calibrated scales. Returns ({key: engine},
    {key: {rid: tokens}})."""
    from repro_torch.models import registry
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = _cfg(policy)
    api = registry.build(cfg)
    params = registry.init_params(cfg, seed, device)
    scales = None
    engines, tokens = {}, {}
    for key, config in configs.items():
        eng = ServingEngine(cfg, api, params, config=dataclasses.replace(
            config, act_calibration=scales or "auto"), device=device)
        scales = eng.act_scales      # calibrate once, share the scales
        rng = np.random.default_rng(seed)
        reqs = [Request(rid=rid, prompt=_prompt(rng, cfg),
                        max_new_tokens=max_new)
                for rid in range(requests)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        engines[key] = eng
        tokens[key] = {r.rid: list(r.tokens) for r in reqs}
    return engines, tokens


def _run_blocked_pair(decode_block: int, requests: int, slots: int,
                      max_new: int, seed: int, device):
    """A per-token and a blocked + calibrated int8_serving engine."""
    from repro_torch.serving.config import EngineConfig
    return _serve_pair("int8_serving", {
        blk: EngineConfig(batch_slots=slots, cache_len=CACHE_LEN,
                          decode_block=blk)
        for blk in (1, decode_block)}, requests, max_new, seed, device)


def _run_fused_pair(decode_block: int, requests: int, slots: int,
                    max_new: int, seed: int, device):
    """A fused (``fused_executors="on"``) and a staged (``"off"``)
    fidelity_int8 engine: exact per-channel int8, so the greedy streams
    must be identical."""
    from repro_torch.serving.config import EngineConfig
    return _serve_pair("fidelity_int8", {
        mode: EngineConfig(batch_slots=slots, cache_len=CACHE_LEN,
                           decode_block=decode_block, fused_executors=mode)
        for mode in ("on", "off")}, requests, max_new, seed, device)


# the bursty trace of the continuous-batching contract: rid ->
# (prompt_len, budget, submit_tick). rid 0 is the multi-wave long
# prompt, rid 4 is oversized (10 + 60 > cache_len 64, truncated admit),
# rids 2-4 land mid-run while the slots are busy
_CONTINUOUS_TRACE = {
    0: (18, 7, 0),
    1: (5, 10, 0),
    2: (7, 11, 2),
    3: (4, 6, 3),
    4: (10, 60, 5),
}


def _drive_trace(cfg, api, params, config, stops, device):
    """Submits land at their trace tick (possibly mid-decode); the
    engine steps once a tick until drained."""
    from repro_torch.serving.config import SamplingParams
    from repro_torch.serving.engine import Request, ServingEngine

    rng = np.random.default_rng(1)
    prompts = {rid: rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for rid, (n, _, _) in sorted(_CONTINUOUS_TRACE.items())}
    eng = ServingEngine(cfg, api, params, config=config, device=device)
    pending = {rid: t for rid, (_, _, t) in _CONTINUOUS_TRACE.items()}
    tick = 0
    while pending or eng.has_pending():
        for rid in [r for r, t in pending.items() if t <= tick]:
            del pending[rid]
            eng.submit(Request(
                rid=rid, prompt=prompts[rid],
                max_new_tokens=_CONTINUOUS_TRACE[rid][1],
                sampling=SamplingParams(stop_ids=stops.get(rid, ()))))
        eng.step()
        tick += 1
        if tick > 10_000:
            raise RuntimeError("continuous trace did not drain")
    return eng


def _run_continuous(decode_block: int, seed: int, device):
    """The continuous engine against a flags-off engine on the same
    trace; stop ids for rids 1 and 3 come from the flags-off greedy
    streams, so stops are certain. Returns (continuous engine, flags-off
    engine, expected streams, stops)."""
    from repro_torch.models import registry
    from repro_torch.quant.calibrate import calibrate_act_scales
    from repro_torch.serving.config import EngineConfig

    cfg = _cfg("int8_serving")
    api = registry.build(cfg)
    params = registry.init_params(cfg, seed, device)
    scales = calibrate_act_scales(cfg, api, params, device=device)
    base = EngineConfig(batch_slots=2, cache_len=CACHE_LEN,
                        decode_block=decode_block, prefill_chunk=4,
                        act_calibration=scales)
    off = dataclasses.replace(base, mid_block_admission=False,
                              eos_stopping=False)
    ref = _drive_trace(cfg, api, params, off, {}, device)
    streams = {r.rid: list(r.tokens) for r in ref.completed.values()}
    # a stop id per stopping request from its greedy stream; the
    # expected continuous stream ends at its first occurrence
    stops, expected = {}, {}
    for rid, (n, budget, _) in _CONTINUOUS_TRACE.items():
        gen = streams[rid][n:]
        if rid in (1, 3):
            tok = gen[min(2, budget - 1)]
            stops[rid] = (int(tok),)
            expected[rid] = streams[rid][:n + gen.index(tok) + 1]
        else:
            expected[rid] = streams[rid]
    cont = _drive_trace(cfg, api, params, base, stops, device)
    return cont, ref, expected, stops


def _run_cost_correction(slots: int, requests: int, seed: int, device):
    """Two bf16 replicas, one slowed by a clock running 8x, under static
    and online costing; requests drain one at a time so the load is zero
    at every placement. Returns {mode: routing counters}."""
    from repro_torch.models import registry
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.router import Replica, Router, replica_cost

    cfg = _cfg("bf16")
    api = registry.build(cfg)
    params = registry.init_params(cfg, seed, device)
    shares = {}
    for mode in ("static", "online"):
        replicas = []
        for name, clock in (("slow", lambda: time.monotonic() * 8.0),
                            ("fast", time.monotonic)):
            eng = ServingEngine(cfg, api, params, clock=clock,
                                config=EngineConfig(batch_slots=slots,
                                                    cache_len=CACHE_LEN),
                                device=device)
            replicas.append(Replica(
                name=name, policy_name="bf16", engine=eng,
                cost=replica_cost(cfg, eng.policy)))
        router = Router(replicas, strategy="plan_aware",
                        cost_correction=mode)
        # warm-up: one request per replica seeds the measured stats
        for wid, rep in enumerate(replicas):
            rep.engine.submit(Request(
                rid=-(wid + 1), prompt=np.arange(1, 7, dtype=np.int32),
                max_new_tokens=4))
            rep.engine.run_until_drained()
        rng = np.random.default_rng(seed)
        for rid in range(requests):
            router.submit(Request(
                rid=rid, prompt=rng.integers(0, cfg.vocab, 6,
                                             dtype=np.int32),
                max_new_tokens=4))
            router.run_until_drained()
        shares[mode] = router.routing_counters()
    return shares


TICK_PHASES = ("admission", "prefill_dispatch", "block_dispatch",
               "host_sync", "harvest")
REQUEST_STAGES = ("queued", "prefill", "decode", "first_token", "finished")


def _run_trace_contract(path: str, requests: int, slots: int, max_new: int,
                        seed: int, device):
    """A traced and an untraced engine on the same workload: the trace
    is valid, non-empty and complete, and the counters are equal.
    Returns the number of trace events."""
    from repro_torch.obs import validate_chrome_trace
    from repro_torch.serving.config import EngineConfig

    engines, _ = _serve_pair("int8_serving", {
        trace: EngineConfig(batch_slots=slots, cache_len=CACHE_LEN,
                            decode_block=4, trace=trace)
        for trace in (True, False)}, requests, max_new, seed, device)
    traced = engines[True]
    traced.dump_trace(path)
    with open(path) as f:
        data = json.load(f)
    errs = validate_chrome_trace(data)
    assert not errs, errs[:5]
    events = data["traceEvents"]
    assert events, "trace is empty"
    names = [e["name"] for e in events]
    for phase in TICK_PHASES:
        assert phase in names, f"missing tick-phase span {phase!r}"
    for stage in REQUEST_STAGES:
        assert stage in names, f"missing request span {stage!r}"
    assert any(str(n).startswith("compile:") for n in names), \
        "cold traced engine recorded no compile spans"
    assert dict(traced.counters) == dict(engines[False].counters), \
        (dict(traced.counters), dict(engines[False].counters))
    return len(events)


def main(argv: Optional[List[str]] = None,
         summary: Optional[Dict] = None) -> int:
    """Run the contract; every assertion that fails raises. ``summary``,
    when given, receives the contract's numbers."""
    from repro_torch.device import resolve_device
    from repro_torch.models import registry
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import ServingEngine

    ap = argparse.ArgumentParser(
        prog="repro_torch.serving smoke", description=__doc__)
    ap.add_argument("--requests", type=int, default=9)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=3)
    ap.add_argument("--decode-block", type=int, default=4,
                    help="block size of the fast-path replica (>= 2: "
                         "the contract compares it against per-token)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="also run the observability contract and "
                         "write the traced engine's Chrome trace here")
    ap.add_argument("--device", default="cuda",
                    help="torch device the engines run on (default cuda; "
                         "'cpu' runs the plain PyTorch versions)")
    args = ap.parse_args(argv)
    if args.decode_block < 2:
        ap.error("--decode-block must be >= 2 (the blocked replica is "
                 "compared against a decode_block=1 engine)")
    device = resolve_device(args.device)
    summary = {} if summary is None else summary

    router, reqs, ticks = _run_workload(args.requests, args.slots,
                                        args.max_new, args.seed, device)
    counters = router.routing_counters()
    report = router.report()

    # --- completion: every request finished with the asked-for tokens
    completed = router.completed
    assert len(completed) == len(reqs), \
        f"{len(reqs) - len(completed)} requests never completed"
    for r in reqs:
        assert r.done and r.new_tokens == args.max_new, \
            f"req{r.rid}: done={r.done} new={r.new_tokens}"

    # --- routing: both replicas took traffic
    for name, n in counters.items():
        assert n > 0, f"replica {name!r} received no traffic: {counters}"

    # --- admission went through chunked prefill, not teacher forcing
    for name, rep in report["replicas"].items():
        c = rep["metrics"]["counters"]
        assert c["teacher_forced_tokens"] == 0, (name, c)
        assert c["prefill_calls"] > 0, (name, c)
        assert rep["metrics"]["ttft_s"], f"{name}: no TTFT samples"
        assert rep["metrics"]["queue_delay_s"], f"{name}: no queue delays"

    # --- prepared weights: the int4 replica holds packed storage and
    # its decode step never quantizes a weight
    int4 = next(rep for rep in router.replicas
                if rep.policy_name == "int4_serving")
    assert int4.engine.prepared, "int4 replica did not prepare weights"
    assert int4.engine.weight_quant_trace_count() == 0, \
        "prepared int4 replica still quantizes weights per decode step"
    wb = int4.engine.weight_bytes()
    raw = next(rep for rep in router.replicas if rep.policy_name == "bf16")
    raw_proj = raw.engine.weight_bytes()["projections"]
    assert wb["projections"] * 6 <= raw_proj, (wb, raw_proj)
    # the counter hook is live: an unprepared engine shows > 0
    dyn = ServingEngine(int4.engine.cfg, int4.engine.api, raw.engine.params,
                        config=EngineConfig(batch_slots=args.slots,
                                            cache_len=CACHE_LEN,
                                            prepare_weights=False),
                        device=device)
    dyn_quants = dyn.weight_quant_trace_count()
    assert dyn_quants > 0, "dynamic control engine counted no quants"

    # --- determinism: an identical second run routes identically
    router2, _, _ = _run_workload(args.requests, args.slots, args.max_new,
                                  args.seed, device)
    assert router2.routing_counters() == counters, \
        (router2.routing_counters(), counters)

    # --- decode fast path: the blocked + calibrated replica gives the
    # per-token engine's streams, syncs the host once a block, and
    # quantizes no weight and reduces no activation a step
    blk = args.decode_block
    engines, tokens = _run_blocked_pair(blk, args.requests, args.slots,
                                        args.max_new, args.seed, device)
    assert tokens[blk] == tokens[1], \
        "blocked decode diverged from per-token decode"
    fast, per_tok = engines[blk].counters, engines[1].counters
    assert per_tok["host_syncs"] == per_tok["decode_steps"], per_tok
    assert fast["decode_steps"] <= fast["ticks"] * blk, (fast, blk)
    assert fast["host_syncs"] * blk >= fast["decode_steps"], (fast, blk)
    assert fast["host_syncs"] < per_tok["host_syncs"], (fast, per_tok)
    assert engines[blk].weight_quant_trace_count() == 0, \
        "blocked replica quantizes weights per decode step"
    assert engines[blk].act_quant_trace_count() == 0, \
        "calibrated replica still absmax-reduces activations"
    dyn_acts = dyn.act_quant_trace_count()
    assert dyn_acts > 0, "dynamic control engine counted no activation quants"

    # --- fused executors: the blocked + calibrated replica resolved
    # "auto" onto the fused datapath and stages no operand; a staged
    # control (same scales) shows the count_staged hook is live
    assert engines[blk].fused, "calibrated blocked replica did not fuse"
    assert engines[blk].staged_trace_count() == 0, \
        "fused replica still materializes staged operands"
    cfg8 = engines[blk].cfg
    staged_ctl = ServingEngine(
        cfg8, registry.build(cfg8),
        registry.init_params(cfg8, args.seed, device),
        config=EngineConfig(batch_slots=args.slots, cache_len=CACHE_LEN,
                            decode_block=blk,
                            act_calibration=engines[blk].act_scales,
                            fused_executors="off"), device=device)
    staged_mats = staged_ctl.staged_trace_count()
    assert staged_mats > 0, "staged control counted no materializations"
    # fused_executors="on" without prepared weights must refuse
    try:
        ServingEngine(cfg8, registry.build(cfg8), staged_ctl.params,
                      config=EngineConfig(batch_slots=args.slots,
                                          cache_len=CACHE_LEN,
                                          prepare_weights=False,
                                          fused_executors="on"),
                      device=device)
    except ValueError:
        pass
    else:
        raise AssertionError(
            "fused_executors='on' accepted prepare_weights=False")

    # --- fused exactness: exact per-channel int8 fused and staged give
    # identical greedy streams, and neither stages an operand (exact
    # specs feed their storage to the kernels on both paths)
    fus_engines, fus_tokens = _run_fused_pair(
        blk, args.requests, args.slots, args.max_new, args.seed, device)
    assert fus_tokens["on"] == fus_tokens["off"], \
        "fused exact-int8 streams diverged from the base datapath"
    assert fus_engines["on"].staged_trace_count() == 0 \
        and fus_engines["off"].staged_trace_count() == 0, \
        (fus_engines["on"].staged_trace_count(),
         fus_engines["off"].staged_trace_count())

    # --- continuous batching against a flags-off engine on one trace
    cont, ref, expected, stops = _run_continuous(blk, args.seed, device)
    cc, rc = cont.counters, ref.counters
    got = {r.rid: list(r.tokens) for r in cont.completed.values()}
    assert got == expected, "continuous greedy streams diverged"
    # rid 0's 17 prefill tokens take 5 waves of 4
    assert cc["prefill_calls"] >= 5, cc
    assert cc["teacher_forced_tokens"] == 0, cc
    assert cc["short_blocks"] > 0, cc
    assert cc["mid_block_admits"] > 0, cc
    assert rc["short_blocks"] == 0 and rc["mid_block_admits"] == 0, rc
    assert cc["eos_stops"] == len(stops), (cc, stops)
    for rid in stops:
        req = cont.completed[rid]
        assert req.finish_reason == "stop", (rid, req.finish_reason)
        assert req.new_tokens < req.budget, (rid, req.new_tokens)
    over = cont.completed[4]
    assert over.truncated and over.new_tokens == 60, \
        (over.truncated, over.new_tokens)
    assert rc["eos_stops"] == 0 and ref.completed[1].new_tokens == 10, rc
    assert cont.weight_quant_trace_count() == 0, \
        "continuous replica quantizes weights per decode step"
    assert cont.act_quant_trace_count() == 0, \
        "continuous replica still absmax-reduces activations"

    # --- online cost correction moves traffic off the slowed replica
    shares = _run_cost_correction(args.slots, requests=6, seed=args.seed,
                                  device=device)
    assert shares["static"]["slow"] == 6 and \
        shares["static"]["fast"] == 0, shares["static"]
    assert shares["online"]["fast"] == 6 and \
        shares["online"]["slow"] == 0, shares["online"]

    # --- observability (only with --trace)
    trace_events = None
    if args.trace:
        trace_events = _run_trace_contract(args.trace, args.requests,
                                           args.slots, args.max_new,
                                           args.seed, device)

    summary.update({
        "device": str(device), "requests": len(completed), "ticks": ticks,
        "routing": counters,
        "prefill_calls": {n: rep["metrics"]["counters"]["prefill_calls"]
                          for n, rep in report["replicas"].items()},
        "ttft_s": {n: {"n": rep["metrics"]["n"], **rep["metrics"]["ttft_s"]}
                   for n, rep in report["replicas"].items()},
        "int4_projection_bytes": wb["projections"],
        "f32_projection_bytes": raw_proj,
        "storage_ratio": wb["projections"] / raw_proj,
        "dynamic_weight_quants": dyn_quants,
        "dynamic_act_quants": dyn_acts,
        "block_equals_per_token": tokens[blk] == tokens[1],
        "block_host_syncs": fast["host_syncs"],
        "block_decode_steps": fast["decode_steps"],
        "per_token_host_syncs": per_tok["host_syncs"],
        "staged_control_mats": staged_mats,
        "fused_equals_staged": fus_tokens["on"] == fus_tokens["off"],
        "continuous": {k: cc[k] for k in ("prefill_calls", "short_blocks",
                                          "mid_block_admits", "eos_stops")},
        "cost_correction": shares, "trace_events": trace_events})
    for name, rep in report["replicas"].items():
        m = rep["metrics"]
        print(f"replica {name}: routed={rep['routed']} "
              f"cycles/tok={rep['cost']['cycles_per_token']:.3g} "
              f"acc_proxy={rep['cost']['acc_proxy']:.3g} "
              f"ttft_p50={m['ttft_s'].get('p50', 0) * 1e3:.1f}ms "
              f"queue_p90={m['queue_delay_s'].get('p90', 0) * 1e3:.1f}ms")
    print(f"serving-smoke OK on {device}: {len(completed)} requests over "
          f"{len(counters)} replicas in {ticks} ticks, "
          f"counters={counters}; int4 prepared "
          f"{wb['projections']}B vs {raw_proj}B fp32 projections, "
          f"0 weight quants/step (dynamic control: {dyn_quants}); "
          f"decode_block={blk} token-identical with "
          f"{fast['host_syncs']} syncs / {fast['decode_steps']} steps "
          f"(per-token: {per_tok['host_syncs']}), 0 act quants/step "
          f"(dynamic control: {dyn_acts}); "
          f"fused: 0 staged mats/step (staged control: {staged_mats}), "
          f"exact-int8 fused==staged streams; "
          f"continuous: {cc['prefill_calls']} prefill waves, "
          f"{cc['short_blocks']} short blocks, "
          f"{cc['mid_block_admits']} mid-block admits, "
          f"{cc['eos_stops']} EOS stops, streams identical to the "
          f"flags-off baseline; cost correction static={shares['static']} "
          f"online={shares['online']}"
          + (f"; trace: {trace_events} events -> {args.trace}"
             if args.trace else ""))
    return 0
