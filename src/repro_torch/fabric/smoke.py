"""``python -m repro_torch.fabric smoke`` — the serving-fabric CI contract
(the port's copy of ``repro/fabric/smoke.py``).

A tiny int4 replica (reduced qwen2, prepared + calibrated) goes through
the full fabric lifecycle on one host, deterministically:

  * **serve-ready checkpoint round trip** — the prepared engine is
    saved (packed int4 storage + scales + calibrated activation scales
    + resolved configs), rebuilt from the checkpoint alone, and the
    restored engine must (a) perform ZERO dynamic weight quants and
    ZERO activation-scale calibrations in its traced decode step —
    restore skipped quantize/pack/calibrate entirely — and (b) serve
    token streams identical to the original engine;
  * **fleet without failures** — a controller with two workers restored
    from the SAME checkpoint serves a workload; every request completes
    with exactly the single-engine reference stream, and the routing
    report shows TRANSPORTED replica stats (ingested StatsSnapshot
    messages, not in-process objects) driving online cost correction;
  * **kill a worker mid-flight** — the same workload, but an injected
    :class:`~repro_torch.runtime.fault_tolerance.WorkerFailure` silences one
    worker while it holds in-flight requests. The controller's
    heartbeat timeout (driven by a ManualClock, so the run is exactly
    reproducible) declares it dead, requeues its in-flight work at the
    front of the fleet queue, and re-admits on the survivor: zero
    requests lost, and every token stream equal to the no-failure run.

Everything runs on ``--device`` (``cuda`` by default; without CUDA that
raises, and ``--device cpu`` runs the plain PyTorch versions). The
weights are drawn from numpy seeds (``init(..., draws="numpy")``), so
every device and torch build serves the same model.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Dict, List

import numpy as np

POLICY = "int4_serving"


def _make_requests(cfg, n: int, max_new: int, seed: int) -> List:
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=rid,
                    prompt=rng.integers(0, cfg.vocab,
                                        int(rng.integers(3, 12)),
                                        dtype=np.int32),
                    max_new_tokens=max_new,
                    priority=int(rng.integers(0, 3)))
            for rid in range(n)]


def _streams(completed: Dict[int, object]) -> Dict[int, List[int]]:
    return {rid: list(r.tokens) for rid, r in completed.items()}


def _engine_streams(engine, reqs) -> Dict[int, List[int]]:
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    return _streams({r.rid: r for r in reqs})


def _run_fleet(ckpt: str, reqs, *, kill: bool, heartbeat_timeout: float,
               kill_tick: int, device):
    from repro_torch.fabric.controller import Controller, ManualClock
    from repro_torch.fabric.controller import spawn_local_worker
    from repro_torch.runtime.fault_tolerance import WorkerFailure

    clock = ManualClock()
    ctrl = Controller(heartbeat_timeout=heartbeat_timeout, clock=clock)

    def die_at(tick: int) -> None:
        if kill and tick == kill_tick:
            raise WorkerFailure(f"injected at worker tick {tick}")

    spawn_local_worker(ctrl, ckpt, name="worker-a", device=device)
    spawn_local_worker(ctrl, ckpt, name="worker-b", failure_hook=die_at,
                       device=device)
    for r in reqs:
        ctrl.submit(r)
    ticks = ctrl.run_until_drained(advance=lambda: clock.advance(1.0))
    return ctrl, ticks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.fabric smoke")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kill-tick", type=int, default=3,
                    help="worker tick at which the injected failure "
                    "silences worker-b (mid-flight)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the engines run on (default cuda; "
                    "--device cpu runs the plain PyTorch versions)")
    args = ap.parse_args(argv)

    import dataclasses

    from repro_torch.configs import reduced
    from repro_torch.device import resolve_device
    from repro_torch.fabric.checkpoint import (build_engine,
                                               save_engine_checkpoint)
    from repro_torch.models import registry
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import ServingEngine

    device = resolve_device(args.device)
    cfg = dataclasses.replace(reduced("qwen2-0.5b"),
                              precision_policy=POLICY)
    api = registry.build(cfg)
    params = api.init(args.seed, device, draws="numpy")
    config = EngineConfig(batch_slots=args.slots, cache_len=64,
                          act_calibration="auto",
                          cost_correction="online")
    engine = ServingEngine(cfg, api, params, config=config, device=device)

    with tempfile.TemporaryDirectory(prefix="fabric_smoke_") as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        save_engine_checkpoint(engine, ckpt, step=0)

        # -- serve-ready restore: zero quantize/calibrate work, same
        # streams as the engine that was saved
        restored = build_engine(ckpt, api=api, device=device)
        wq = restored.weight_quant_trace_count()
        aq = restored.act_quant_trace_count()
        assert wq == 0, f"restored engine quantizes weights ({wq}/step)"
        assert aq == 0, f"restored engine calibrates scales ({aq}/step)"
        assert restored.act_scales == engine.act_scales
        ref = _engine_streams(engine,
                              _make_requests(cfg, args.requests,
                                             args.max_new, args.seed))
        got = _engine_streams(restored,
                              _make_requests(cfg, args.requests,
                                             args.max_new, args.seed))
        assert got == ref, "restored engine diverged from saved engine"
        print(f"fabric-smoke: restore ok — 0 weight quants, 0 act "
              f"calibrations, {len(ref)} identical streams")

        # -- two-worker fleet, no failures: streams == single-engine
        # reference; stats driving routing are transported
        reqs = _make_requests(cfg, args.requests, args.max_new,
                              args.seed)
        ctrl, ticks = _run_fleet(ckpt, reqs, kill=False,
                                 heartbeat_timeout=4.0,
                                 kill_tick=args.kill_tick, device=device)
        assert len(ctrl.completed) == args.requests, (
            f"fleet lost requests: {sorted(ctrl.completed)}")
        fleet = _streams(ctrl.completed)
        assert fleet == ref, "fleet streams diverged from single engine"
        rep = ctrl.routing_report()
        assert rep["cost_correction"] == "online", rep["cost_correction"]
        for name, r in rep["replicas"].items():
            assert r["measured"]["transported"], (
                f"{name}: router read in-process stats, not "
                f"transported snapshots")
            assert r["measured"]["tok_per_s"] is not None, (
                f"{name}: no measured throughput crossed the wire")
        routed = ctrl.routing_counters()
        assert all(v > 0 for v in routed.values()), (
            f"a worker got no traffic: {routed}")
        print(f"fabric-smoke: fleet ok — {ticks} ticks, routed={routed},"
              f" online correction over transported stats")

        # -- kill worker-b mid-flight: heartbeat timeout -> requeue ->
        # re-admit on the survivor; zero loss, identical streams
        reqs = _make_requests(cfg, args.requests, args.max_new,
                              args.seed)
        ctrl, ticks = _run_fleet(ckpt, reqs, kill=True,
                                 heartbeat_timeout=4.0,
                                 kill_tick=args.kill_tick, device=device)
        assert ctrl.failures == ["worker-b"], ctrl.failures
        assert ctrl.scheduler.requeued > 0, (
            "the dead worker held no in-flight requests — the kill "
            "tick was not mid-flight")
        assert len(ctrl.completed) == args.requests, (
            f"failure lost requests: have {sorted(ctrl.completed)}")
        assert _streams(ctrl.completed) == ref, (
            "failover changed token streams")
        alive = [h.name for h in ctrl.workers.values() if h.alive]
        assert alive == ["worker-a"], alive
        print(f"fabric-smoke: failover ok — worker-b died mid-flight, "
              f"{ctrl.scheduler.requeued} requeued, 0 lost, streams "
              f"identical ({ticks} ticks)")
    print(f"fabric-smoke: PASS on {device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
