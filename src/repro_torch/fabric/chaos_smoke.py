"""``python -m repro_torch.fabric chaos`` — the chaos-hardening CI contract
(the port's copy of ``repro/fabric/chaos_smoke.py``).

One seeded :class:`~repro_torch.fabric.chaos.FaultSchedule` per worker, a
ManualClock, and a 3-worker fleet restored from one serve-ready
checkpoint. Everything that goes wrong is deterministic, and nothing
that goes wrong may change what callers observe:

  * **combined chaos** — worker-a's telemetry is dropped, duplicated
    and split across delivery quanta, and its heartbeats stall through
    a window (suspect -> recover, no rework); worker-b suffers a
    connection reset mid-flight (transient partition) and resumes IN
    PLACE via the Resume handshake; worker-c dies silently at a
    scheduled tick (permanent kill) and its work requeues. The run must
    complete with zero request loss and token streams identical to a
    single-engine reference.
  * **transient partition, isolated** — a two-worker fleet where the
    only fault is worker-b's severed link. Recovery must go through
    Resume, not requeue: ``scheduler.requeued == 0``, ``resumed == 1``,
    no failures, identical streams. Run twice with the same seed, the
    delivery traces and streams must be bit-identical.

Everything runs on ``--device`` (``cuda`` by default; without CUDA that
raises, and ``--device cpu`` runs the plain PyTorch versions), on the
weights ``smoke`` draws from numpy seeds. ``check_contract`` runs both
parts over any serve-ready checkpoint (``chip_smoke.py`` phase 17 gives
it full-width qwen2-0.5b).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Callable, Dict, List, Optional

from repro_torch.fabric.smoke import (POLICY, _engine_streams, _make_requests,
                                _streams)


def _spawn_chaos_worker(ctrl, ckpt: str, name: str, *,
                        schedule=None, resumable: bool = False,
                        device=None):
    """spawn_local_worker with the worker-side endpoint wrapped in a
    ChaosEndpoint (faults apply to the worker -> controller direction,
    where the token stream lives). Returns (worker, handle, endpoint)
    so the harness can reattach and read the delivery trace."""
    from repro_torch.fabric import transport as tp
    from repro_torch.fabric.chaos import ChaosEndpoint, fail_at
    from repro_torch.fabric.checkpoint import build_engine
    from repro_torch.fabric.controller import LocalWorkerDriver
    from repro_torch.fabric.worker import FabricWorker

    ctrl_ep, worker_ep = tp.local_pair()
    hook = None
    if schedule is not None:
        worker_ep = ChaosEndpoint(worker_ep, schedule, ctrl.clock)
        hook = fail_at(schedule.kill_at_tick)
    engine = build_engine(ckpt, clock=ctrl.clock, device=device)
    worker = FabricWorker(name, engine, worker_ep, clock=ctrl.clock,
                          failure_hook=hook, resumable=resumable)
    worker.announce()
    ctrl.add_worker(ctrl_ep, driver=LocalWorkerDriver(worker), name=name)
    return worker, ctrl.workers[name], worker_ep


def _drive(ctrl, clock, *, reattach: Optional[Dict] = None,
           max_ticks: int = 10_000) -> Dict[str, int]:
    """Tick the fleet to drained, healing each worker in ``reattach``
    (name -> FabricWorker) the moment the controller suspects it.
    Returns how many in-flight requests each healed worker was holding
    at reattach time — the work that must resume, not requeue."""
    from repro_torch.fabric.controller import reattach_local_worker

    pending = dict(reattach or {})
    held: Dict[str, int] = {}
    ticks = 0
    while ctrl.has_pending():
        clock.advance(1.0)
        ctrl.tick()
        ticks += 1
        for name in list(pending):
            h = ctrl.workers[name]
            if h.state == "suspect" and h.endpoint.closed:
                held[name] = len(h.replica.in_flight)
                reattach_local_worker(ctrl, pending.pop(name))
        if ticks > max_ticks:
            raise RuntimeError(
                f"chaos fleet did not drain in {max_ticks} ticks")
    return held


def _run_combined(ckpt: str, reqs, seed: int, kill_tick: int, device):
    """Drops + duplicates + partial writes + heartbeat stall on
    worker-a, transient partition on worker-b, silent kill on
    worker-c — one schedule set, one run."""
    from repro_torch.fabric.chaos import FaultSchedule
    from repro_torch.fabric.controller import Controller, ManualClock

    clock = ManualClock()
    ctrl = Controller(heartbeat_timeout=4.0, clock=clock)
    # telemetry hostility: StatsSnapshot drops keep heartbeat gaps
    # bounded (the stall window alone drives suspicion, never death)
    _, _, ep_a = _spawn_chaos_worker(
        ctrl, ckpt, "worker-a",
        schedule=FaultSchedule(seed=seed, drop_rate=0.3,
                               droppable=("StatsSnapshot",),
                               duplicate_every=3, partial_every=4,
                               stall_heartbeats_between=(6.0, 10.0)),
        device=device)
    wb, _, ep_b = _spawn_chaos_worker(
        ctrl, ckpt, "worker-b",
        schedule=FaultSchedule(seed=seed, reset_at_msg=12),
        resumable=True, device=device)
    _spawn_chaos_worker(
        ctrl, ckpt, "worker-c",
        schedule=FaultSchedule(seed=seed, kill_at_tick=kill_tick),
        device=device)
    for r in reqs:
        ctrl.submit(r)
    held = _drive(ctrl, clock, reattach={"worker-b": wb})
    return ctrl, held, ep_a, ep_b


def _run_partition(ckpt: str, reqs, seed: int, device):
    """The isolated resume path: the ONLY fault is worker-b's severed
    connection; recovery must not touch the requeue machinery."""
    from repro_torch.fabric.chaos import FaultSchedule
    from repro_torch.fabric.controller import (Controller, ManualClock,
                                         spawn_local_worker)

    clock = ManualClock()
    ctrl = Controller(heartbeat_timeout=4.0, clock=clock)
    spawn_local_worker(ctrl, ckpt, name="worker-a", device=device)
    wb, _, ep_b = _spawn_chaos_worker(
        ctrl, ckpt, "worker-b",
        schedule=FaultSchedule(seed=seed, reset_at_msg=12),
        resumable=True, device=device)
    for r in reqs:
        ctrl.submit(r)
    held = _drive(ctrl, clock, reattach={"worker-b": wb})
    return ctrl, held, ep_b


def check_contract(ckpt: str, make_requests: Callable[[], List], ref,
                   seed: int, kill_tick: int, device) -> Dict:
    """The chaos contract over the serve-ready checkpoint ``ckpt``:
    ``make_requests()`` gives a fresh copy of the workload, ``ref`` the
    single engine's streams for it. Raises AssertionError on a breach;
    returns the runs' counters."""
    # -- combined chaos: drops + partition + silent kill, one run
    reqs = make_requests()
    ctrl, held, ep_a, ep_b = _run_combined(ckpt, reqs, seed, kill_tick,
                                           device)
    assert len(ctrl.completed) == len(reqs), (
        f"chaos lost requests: have {sorted(ctrl.completed)}")
    assert _streams(ctrl.completed) == ref, (
        "chaos changed token streams")
    assert ctrl.failures == ["worker-c"], ctrl.failures
    assert ctrl.scheduler.requeued > 0, (
        "the killed worker held nothing — kill tick not mid-flight")
    assert ctrl.resumed == 1, ctrl.resumed
    assert ctrl.workers["worker-b"].state == "alive", (
        ctrl.workers["worker-b"].state)
    assert held.get("worker-b", 0) > 0, (
        "worker-b held no in-flight work at severance — the reset "
        "message index is not mid-flight")
    assert "worker-a" in ctrl.suspects, (
        "the heartbeat stall never drove suspicion")
    acts_a = {a for _, _, a in ep_a.log}
    assert {"dropped", "duplicated", "partial",
            "stalled"} <= acts_a, acts_a
    assert any(a == "reset" for _, _, a in ep_b.log), ep_b.log
    combined = {"requeued": ctrl.scheduler.requeued,
                "resumed": ctrl.resumed, "suspects": list(ctrl.suspects),
                "failures": list(ctrl.failures),
                "held_at_reset": held.get("worker-b", 0),
                "ticks": ctrl.ticks}
    print(f"chaos-smoke: combined ok — {len(ref)} streams identical"
          f" under drops+partition+kill; requeued="
          f"{ctrl.scheduler.requeued} (kill), resumed="
          f"{ctrl.resumed}, suspects={ctrl.suspects}")

    # -- transient partition alone: resume in place, requeued == 0,
    # and the whole run is bit-reproducible
    runs = []
    for _ in range(2):
        reqs = make_requests()
        ctrl, held, ep_b = _run_partition(ckpt, reqs, seed, device)
        assert len(ctrl.completed) == len(reqs), (
            f"partition lost requests: {sorted(ctrl.completed)}")
        assert _streams(ctrl.completed) == ref, (
            "partition changed token streams")
        assert ctrl.scheduler.requeued == 0, (
            f"transient partition requeued "
            f"{ctrl.scheduler.requeued} requests instead of "
            f"resuming in place")
        assert ctrl.failures == [], ctrl.failures
        assert ctrl.resumed == 1, ctrl.resumed
        assert held.get("worker-b", 0) > 0, held
        runs.append((list(ep_b.log), _streams(ctrl.completed)))
    assert runs[0] == runs[1], (
        "same seed, different run: chaos is not deterministic")
    print(f"chaos-smoke: partition ok — resumed in place holding "
          f"{held['worker-b']} in-flight, requeued=0, two runs "
          f"bit-identical ({len(runs[0][0])} trace entries)")
    return {"combined": combined,
            "partition": {"held_at_reset": held["worker-b"],
                          "trace_entries": len(runs[0][0]),
                          "ticks": ctrl.ticks, "runs": len(runs)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.fabric chaos")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kill-tick", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device the engines run on (default cuda; "
                    "--device cpu runs the plain PyTorch versions)")
    args = ap.parse_args(argv)

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

    with tempfile.TemporaryDirectory(prefix="chaos_smoke_") as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        save_engine_checkpoint(engine, ckpt, step=0)
        ref = _engine_streams(
            build_engine(ckpt, api=api, device=device),
            _make_requests(cfg, args.requests, args.max_new, args.seed))

        check_contract(
            ckpt, lambda: _make_requests(cfg, args.requests, args.max_new,
                                         args.seed),
            ref, args.seed, args.kill_tick, device)
    print(f"chaos-smoke: PASS on {device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
