"""The port's serving fabric (``repro_torch.fabric``) on the CPU.

Mirrors ``tests/test_fabric.py`` case for case on the port: the wire
layer (typed messages, framing, endpoint pairs), the config round trips
behind serve-ready checkpoints, the scheduler's failure-recovery
requeue, the controller's kill -> requeue -> re-admit loop, chaos
endpoints, suspect/resume liveness and graceful degradation — the
control-plane cases over a deterministic ``FakeEngine`` — then the real
engine: a prepared checkpoint restored bit for bit, and the TCP
subprocess fleet (``slow``, as the reference's).

Against the reference, on the same inputs:

* every message type's ``encode_message`` bytes equal the reference's
  (int-keyed ``Resume``/``ResumeAck``, an ``np.float64`` in
  ``StatsSnapshot``), and each package decodes the other's frames;
* ``_msgpack`` equals ``msgpack`` on int keys, float and int
  subclasses, and refuses hostile bytes with ``ValueError``;
* a ``ChaosEndpoint`` delivers the reference's trace, and
  ``backoff_delays`` the reference's delays;
* ``python -m repro_torch.fabric smoke|chaos --device cpu`` keep the
  reference's contract (kill mid-flight, transient partition);
* one mixed fleet: a JAX worker (``python -m repro.fabric worker`` on a
  port-written checkpoint, in one subprocess with XLA's excess precision
  off, as ``_torch_parity`` runs the reference) and a port worker behind
  the port's controller; and the reference's ``Controller`` driving port
  workers over endpoints that share one pair of deques. Greedy streams
  equal the single port engine's.

``msgpack`` is used here only as the yardstick; the port never imports
it.
"""
import collections
import dataclasses
import enum
import subprocess
import sys

import msgpack
import numpy as np
import pytest

from repro.fabric import chaos as ref_chaos
from repro.fabric import transport as ref_tp
from repro_torch.checkpoint import _msgpack
from repro_torch.configs import ModelConfig, MoESpec
from repro_torch.fabric import transport as tp
from repro_torch.fabric.chaos import ChaosEndpoint, FaultSchedule, fail_at
from repro_torch.fabric.checkpoint import (engine_config_from_dict,
                                           engine_config_to_dict,
                                           model_config_from_dict,
                                           model_config_to_dict)
from repro_torch.fabric.controller import (Controller, FabricError,
                                           FleetBusy, LocalWorkerDriver,
                                           ManualClock,
                                           reattach_local_worker)
from repro_torch.fabric.worker import FabricWorker
from repro_torch.obs import ReplicaStats
from repro_torch.runtime.fault_tolerance import WorkerFailure
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import Request
from repro_torch.serving.scheduler import AdmissionScheduler, SchedulerFull

from _torch_parity import one_intra_op_thread  # noqa: F401 (autouse)


# ---------------------------------------------------------------- wire

class TestWireProtocol:
    MESSAGES = [
        tp.Hello(name="w0", policy="int4_serving", slots=4,
                 model_config={"d_model": 64, "rec_pattern": []},
                 cost_correction="online", resumable=True),
        tp.SubmitRequest(rid=7, prompt=[1, 2, 3], max_new_tokens=8,
                         priority=2, tags=["accuracy"],
                         temperature=0.7, top_k=5, top_p=0.9,
                         stop_ids=[11], seed=42),
        tp.TokenChunk(rid=7, tokens=[4, 5], done=True,
                      finish_reason="stop", truncated=True, start=3),
        tp.StatsSnapshot(name="w0", stats={"tok_per_s": 3.5},
                         slots=4, completed=9),
        tp.Heartbeat(tick=12, time=3.25),
        tp.Register(name="fresh", need_checkpoint=True),
        tp.RegisterAck(ckpt_dir="/shared/ckpt", step=7),
        tp.Resume(name="w0", progress={3: 5, 9: 0}),
        tp.ResumeAck(progress={3: 4}, cancel=[9]),
        tp.Drain(), tp.Drained(completed=3), tp.Shutdown(),
    ]

    @pytest.mark.parametrize("msg", MESSAGES,
                             ids=lambda m: type(m).__name__)
    def test_codec_roundtrip(self, msg):
        assert tp.decode_message(tp.encode_message(msg)) == msg

    def test_unknown_type_rejected(self):
        with pytest.raises(ValueError, match="unknown fabric message"):
            tp.decode_message(msgpack.packb({"t": "Nope", "f": {}}))
        with pytest.raises(TypeError):
            tp.encode_message({"not": "a message"})

    def test_framing_survives_arbitrary_chunking(self):
        payloads = [tp.encode_message(m) for m in self.MESSAGES]
        stream = b"".join(tp.pack_frame(p) for p in payloads)
        for chunk in (1, 3, len(stream)):      # byte-by-byte .. all-at-once
            dec = tp.FrameDecoder()
            frames = []
            for i in range(0, len(stream), chunk):
                frames.extend(dec.feed(stream[i:i + chunk]))
            assert frames == payloads

    def test_local_pair_is_a_framed_wire(self):
        a, b = tp.local_pair()
        a.send(tp.Heartbeat(tick=1, time=0.0))
        a.send(tp.Drain())
        assert b.poll() == [tp.Heartbeat(tick=1, time=0.0), tp.Drain()]
        assert b.poll() == []
        b.send(tp.Drained())
        assert a.poll() == [tp.Drained()]
        # closing either side closes both (a dead TCP peer, in memory)
        b.close()
        assert a.closed and b.closed
        with pytest.raises(tp.TransportClosed):
            a.send(tp.Shutdown())

    def test_hostile_frames_raise_typed_errors(self):
        # corrupt msgpack payload
        with pytest.raises(tp.ProtocolError, match="malformed"):
            tp.decode_message(b"\xc1\xff\x00garbage")
        # valid msgpack, but not the typed envelope
        with pytest.raises(tp.ProtocolError, match="envelope"):
            tp.decode_message(msgpack.packb([1, 2, 3]))
        # envelope whose fields are not a map
        with pytest.raises(tp.ProtocolError, match="not a map"):
            tp.decode_message(msgpack.packb({"t": "Drain", "f": [1]}))
        # right type, wrong fields
        with pytest.raises(tp.ProtocolError, match="bad Heartbeat"):
            tp.decode_message(msgpack.packb(
                {"t": "Heartbeat", "f": {"warp": 9}}))
        # every ProtocolError is a ValueError: containment code that
        # predates the subclass keeps working
        assert issubclass(tp.ProtocolError, ValueError)

    def test_oversized_frames_rejected_both_directions(self):
        with pytest.raises(tp.FrameTooLarge):
            tp.pack_frame(b"\x00" * (tp.MAX_FRAME + 1))
        dec = tp.FrameDecoder()
        # a hostile header announcing an absurd payload is refused at
        # the 4-byte mark — no buffering of unbounded garbage
        import struct
        with pytest.raises(tp.FrameTooLarge):
            dec.feed(struct.pack(">I", tp.MAX_FRAME + 1))

    def test_truncated_stream_is_visible_not_fatal(self):
        dec = tp.FrameDecoder()
        frame = tp.pack_frame(tp.encode_message(tp.Drain()))
        assert dec.feed(frame[:5]) == []
        assert dec.pending_bytes == 5          # mid-frame truncation
        assert dec.feed(frame[5:]) == [tp.encode_message(tp.Drain())]
        assert dec.pending_bytes == 0

    def test_backoff_is_seeded_and_bounded(self):
        a = tp.backoff_delays(8, seed=3)
        b = tp.backoff_delays(8, seed=3)
        c = tp.backoff_delays(8, seed=4)
        assert a == b and a != c               # pure function of seed
        assert all(0 < d <= 5.0 for d in a)
        # exponential envelope: undelayed upper bounds double
        assert all(d <= 0.1 * (2.0 ** k) for k, d in enumerate(a))

    def test_connect_with_retry_exhausts_into_typed_error(self):
        lst = tp.Listener()
        host, port = lst.host, lst.port
        lst.close()                            # nobody home
        slept = []
        with pytest.raises(tp.TransportClosed, match="after 3 attempts"):
            tp.connect_with_retry(host, port, attempts=3,
                                  sleep=slept.append)
        assert slept == tp.backoff_delays(3)[:len(slept)]

    def test_socket_endpoints_roundtrip(self):
        listener = tp.Listener()
        client = tp.connect(listener.host, listener.port)
        server = listener.accept(timeout=10.0)
        listener.close()
        try:
            client.send(tp.Hello(name="w", policy="bf16", slots=1))
            for _ in range(100):
                got = server.poll()
                if got:
                    break
            assert got == [tp.Hello(name="w", policy="bf16", slots=1)]
            server.send(tp.Shutdown())
            for _ in range(100):
                back = client.poll()
                if back:
                    break
            assert back == [tp.Shutdown()]
        finally:
            client.close()
            server.close()


# ------------------------------------------------------- config codecs

def _tiny_cfg(policy="bf16", **kw) -> ModelConfig:
    return ModelConfig(arch_id="tiny", family="lm", n_layers=1,
                       d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                       vocab=128, precision_policy=policy, **kw)


class TestConfigRoundTrip:
    def test_model_config_through_the_wire(self):
        cfg = _tiny_cfg(moe=MoESpec(n_experts=4, top_k=2, d_expert=16),
                        rec_pattern=("rec", "rec", "attn"))
        wire = msgpack.unpackb(msgpack.packb(model_config_to_dict(cfg)))
        back = model_config_from_dict(wire)
        assert back == cfg                    # tuples/MoESpec restored
        assert isinstance(back.rec_pattern, tuple)
        assert isinstance(back.moe, MoESpec)

    def test_model_config_unknown_field_rejected(self):
        d = model_config_to_dict(_tiny_cfg())
        d["from_the_future"] = 1
        with pytest.raises(ValueError, match="unknown fields"):
            model_config_from_dict(d)

    def test_engine_config_reinjects_act_scales(self):
        config = EngineConfig(batch_slots=2, cache_len=64,
                              act_calibration="auto",
                              cost_correction="online")
        wire = msgpack.unpackb(msgpack.packb(
            engine_config_to_dict(config)))
        assert "act_calibration" not in wire  # never serialized
        scales = {"block/mlp/w_up": 0.25}
        back = engine_config_from_dict(wire, scales)
        # restore swaps 'auto' (a calibration PASS) for the resolved
        # scales dict (zero-work) and keeps every other knob
        assert back.act_calibration == scales
        assert dataclasses.replace(back, act_calibration="auto") == config

    def test_engine_config_unknown_field_rejected(self):
        with pytest.raises(ValueError, match="unknown fields"):
            engine_config_from_dict({"warp_drive": True}, None)


# --------------------------------------------------- scheduler requeue

class TestSchedulerRequeue:
    def test_requeue_jumps_the_line_and_bypasses_the_bound(self):
        sched = AdmissionScheduler(max_queue=2)
        a, b = Request(rid=1, prompt=np.arange(3)), \
            Request(rid=2, prompt=np.arange(3))
        sched.submit(a, now=0.0)
        sched.submit(b, now=0.0)
        with pytest.raises(SchedulerFull):
            sched.submit(Request(rid=3, prompt=np.arange(3)), now=0.0)
        # recovery re-entries are admitted work: never bounced, placed
        # ahead of every waiting submit of the same priority class
        r1 = Request(rid=10, prompt=np.arange(3), submit_time=0.0)
        r2 = Request(rid=11, prompt=np.arange(3), submit_time=0.0)
        sched.requeue(r1)
        sched.requeue(r2)
        assert sched.requeued == 2 and len(sched) == 4
        picked = sched.select(4, now=1.0)
        assert [r.rid for r in picked] == [10, 11, 1, 2]

    def test_requeue_preserves_submit_time_for_promotion(self):
        sched = AdmissionScheduler(max_wait=5.0)
        old = Request(rid=1, prompt=np.arange(3), priority=9,
                      submit_time=0.0)
        sched.requeue(old)
        fresh = Request(rid=2, prompt=np.arange(3), priority=0)
        sched.submit(fresh, now=6.0)
        # the requeued request kept its original submission clock: it
        # is already past max_wait and outranks the priority-0 arrival
        assert [r.rid for r in sched.select(1, now=6.0)] == [1]


# ------------------------------------------------ fake-engine fleet

class FakeEngine:
    """Deterministic jax-free stand-in for ServingEngine: one token per
    slot per step, value ``(rid * 31 + position) % 97`` — placement-
    and batch-independent by construction, like greedy decode."""

    def __init__(self, cfg, config, clock):
        self.cfg = cfg
        self.config = config
        self.b = config.batch_slots
        self.clock = clock
        self.stats = ReplicaStats()
        self.scheduler = AdmissionScheduler()
        self.slot_req = [None] * self.b
        self.completed = {}

    def submit(self, req):
        self.scheduler.submit(req, now=self.clock())

    def has_pending(self):
        return len(self.scheduler) > 0 \
            or any(r is not None for r in self.slot_req)

    def step(self):
        now = self.clock()
        free = [s for s, r in enumerate(self.slot_req) if r is None]
        for req in self.scheduler.select(len(free), now):
            self.slot_req[free.pop(0)] = req
            req.tokens = [int(t) for t in req.prompt]
        new = 0
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            req.tokens.append((req.rid * 31 + len(req.tokens)) % 97)
            new += 1
            if len(req.tokens) - len(req.prompt) >= req.budget:
                req.done = True
                req.finish_reason = "length"
                self.completed[req.rid] = req
                self.slot_req[s] = None
        self.stats.on_tick(now, new, len(self.scheduler),
                           active_slots=sum(r is not None
                                            for r in self.slot_req))


def _expected_stream(req) -> list:
    start = len(req.prompt)
    return [int(t) for t in req.prompt] + [
        (req.rid * 31 + start + j) % 97 for j in range(req.budget)]


def _spawn_fake(ctrl, name, clock, *, slots=2, failure_hook=None):
    cfg = _tiny_cfg()
    engine = FakeEngine(cfg, EngineConfig(batch_slots=slots,
                                          cost_correction="online"),
                        clock)
    ctrl_ep, worker_ep = tp.local_pair()
    worker = FabricWorker(name, engine, worker_ep, clock=clock,
                          failure_hook=failure_hook)
    worker.announce()
    return ctrl.add_worker(ctrl_ep, driver=LocalWorkerDriver(worker),
                           name=name)


def _requests(n, max_new=6, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=rid,
                    prompt=rng.integers(0, 97, int(rng.integers(2, 6)),
                                        dtype=np.int32),
                    max_new_tokens=max_new)
            for rid in range(n)]


def _run(n_requests, *, kill_tick=None, heartbeat_timeout=3.0,
         max_new=6):
    clock = ManualClock()
    ctrl = Controller(heartbeat_timeout=heartbeat_timeout, clock=clock)

    def die(tick):
        if kill_tick is not None and tick == kill_tick:
            raise WorkerFailure("injected")

    _spawn_fake(ctrl, "worker-a", clock)
    _spawn_fake(ctrl, "worker-b", clock, failure_hook=die)
    reqs = _requests(n_requests, max_new=max_new)
    for r in reqs:
        ctrl.submit(r)
    ctrl.run_until_drained(advance=lambda: clock.advance(1.0))
    return ctrl, reqs


class TestControllerFleet:
    def test_fleet_completes_with_exact_streams(self):
        ctrl, reqs = _run(6)
        assert sorted(ctrl.completed) == [r.rid for r in reqs]
        for req in reqs:
            assert req.done and req.tokens == _expected_stream(req)
        # routing ran over TRANSPORTED stats, not in-process objects
        report = ctrl.routing_report()
        assert report["cost_correction"] == "online"
        for name, rep in report["replicas"].items():
            assert rep["measured"]["transported"], name
        routed = ctrl.routing_counters()
        assert sum(routed.values()) == 6 and all(
            v > 0 for v in routed.values()), routed

    def test_kill_mid_flight_loses_nothing(self):
        ref, _ = _run(8, max_new=8)
        ref_streams = {rid: list(r.tokens)
                       for rid, r in ref.completed.items()}
        ctrl, reqs = _run(8, kill_tick=2, max_new=8)
        assert ctrl.failures == ["worker-b"]
        assert ctrl.scheduler.requeued > 0
        assert sorted(ctrl.completed) == sorted(ref_streams)
        for rid, req in ctrl.completed.items():
            assert req.tokens == ref_streams[rid], f"rid {rid} diverged"
        alive = [h.name for h in ctrl.workers.values() if h.alive]
        assert alive == ["worker-a"]

    def test_closed_endpoint_detected_without_heartbeat_wait(self):
        clock = ManualClock()
        ctrl = Controller(heartbeat_timeout=1e9, clock=clock)
        _spawn_fake(ctrl, "worker-a", clock)
        hb = _spawn_fake(ctrl, "worker-b", clock)
        reqs = _requests(4)
        for r in reqs:
            ctrl.submit(r)
        ctrl.tick()
        hb.endpoint.close()     # process death: socket EOF, no timeout
        ctrl.run_until_drained(advance=lambda: clock.advance(1.0))
        assert ctrl.failures == ["worker-b"]
        assert sorted(ctrl.completed) == [r.rid for r in reqs]

    def test_last_worker_death_is_a_fleet_error(self):
        clock = ManualClock()
        ctrl = Controller(heartbeat_timeout=2.0, clock=clock)

        def die(tick):
            if tick == 1:
                raise WorkerFailure("injected")

        _spawn_fake(ctrl, "only", clock, failure_hook=die)
        for r in _requests(3):
            ctrl.submit(r)
        with pytest.raises(FabricError, match="no alive workers"):
            ctrl.run_until_drained(advance=lambda: clock.advance(1.0))

    def test_worker_drain_and_shutdown(self):
        clock = ManualClock()
        engine = FakeEngine(_tiny_cfg(), EngineConfig(batch_slots=2),
                            clock)
        ctrl_ep, worker_ep = tp.local_pair()
        worker = FabricWorker("w", engine, worker_ep, clock=clock)
        req = _requests(1)[0]
        sp = req.sampling
        ctrl_ep.send(tp.SubmitRequest(
            rid=req.rid, prompt=[int(t) for t in req.prompt],
            max_new_tokens=req.budget, temperature=sp.temperature,
            top_k=sp.top_k, top_p=sp.top_p))
        ctrl_ep.send(tp.Drain())
        for _ in range(32):
            clock.advance(1.0)
            worker.tick()
        msgs = ctrl_ep.poll()
        drained = [m for m in msgs if isinstance(m, tp.Drained)]
        assert len(drained) == 1 and drained[0].completed == 1
        final = [m for m in msgs if isinstance(m, tp.TokenChunk)
                 and m.done]
        assert len(final) == 1
        ctrl_ep.send(tp.Shutdown())
        assert worker.tick() is False


# ---------------------------------------------------- chaos endpoint

class TestChaosEndpoint:
    def _pair(self, schedule, t0=0.0):
        clock = ManualClock(t0)
        ctrl_side, worker_side = tp.local_pair()
        return clock, ctrl_side, ChaosEndpoint(worker_side, schedule,
                                               clock)

    def test_deterministic_delivery_trace(self):
        def run():
            sched = FaultSchedule(seed=5, drop_rate=0.5,
                                  duplicate_every=3, partial_every=4)
            clock, ctrl_side, ep = self._pair(sched)
            got = []
            for i in range(40):
                clock.advance(1.0)
                ep.send(tp.Heartbeat(tick=i, time=clock.t))
                ep.send(tp.TokenChunk(rid=1, tokens=[i], start=i))
                got.extend(ctrl_side.poll())
            got.extend(ctrl_side.poll())
            return list(ep.log), got
        assert run() == run()          # same seed -> bit-identical run

    def test_drop_only_touches_droppable_types(self):
        sched = FaultSchedule(seed=0, drop_rate=1.0)   # drop EVERYTHING
        clock, ctrl_side, ep = self._pair(sched)
        for i in range(10):
            ep.send(tp.Heartbeat(tick=i, time=0.0))
            ep.send(tp.TokenChunk(rid=1, tokens=[i], start=i))
        got = ctrl_side.poll()
        # every heartbeat gone, every data-plane chunk intact: TCP
        # does not drop individual frames, so the data plane may only
        # fail by severance (reset_at_msg), never silent frame loss
        assert [m for m in got if isinstance(m, tp.Heartbeat)] == []
        chunks = [m for m in got if isinstance(m, tp.TokenChunk)]
        assert [c.tokens[0] for c in chunks] == list(range(10))

    def test_partial_write_reassembles_across_polls(self):
        sched = FaultSchedule(seed=0, partial_every=1)  # split all
        clock, ctrl_side, ep = self._pair(sched)
        ep.send(tp.Heartbeat(tick=1, time=0.0))
        assert ctrl_side.poll() == []          # only the head arrived
        ep.send(tp.Heartbeat(tick=2, time=0.0))   # flushes held tail
        got = ctrl_side.poll()
        assert tp.Heartbeat(tick=1, time=0.0) in got

    def test_delay_holds_until_clock_matures(self):
        sched = FaultSchedule(seed=0, delay_msgs=((0, 5.0),))
        clock, ctrl_side, ep = self._pair(sched)
        ep.send(tp.Heartbeat(tick=1, time=0.0))
        assert ctrl_side.poll() == []
        clock.advance(4.0)
        ep.send(tp.Drain())                    # flush: not matured yet
        assert [type(m).__name__ for m in ctrl_side.poll()] == ["Drain"]
        clock.advance(2.0)
        ep.send(tp.Drain())                    # now past the deadline
        assert tp.Heartbeat(tick=1, time=0.0) in ctrl_side.poll()

    def test_reset_severs_and_leaks_a_truncated_frame(self):
        sched = FaultSchedule(seed=0, reset_at_msg=2)
        clock, ctrl_side, ep = self._pair(sched)
        ep.send(tp.Heartbeat(tick=1, time=0.0))
        ep.send(tp.Heartbeat(tick=2, time=0.0))
        with pytest.raises(tp.TransportClosed, match="reset"):
            ep.send(tp.Heartbeat(tick=3, time=0.0))
        assert ep.tripped and ep.closed and ctrl_side.closed
        got = ctrl_side.poll()                 # pre-reset frames drain
        assert len(got) == 2
        with pytest.raises(tp.TransportClosed):
            ep.send(tp.Drain())

    def test_schedule_validation(self):
        with pytest.raises(ValueError, match="drop_rate"):
            FaultSchedule(drop_rate=1.5)
        with pytest.raises(ValueError, match="duplicate_every"):
            FaultSchedule(duplicate_every=-1)
        assert fail_at(None) is None
        hook = fail_at(3)
        hook(2)
        with pytest.raises(WorkerFailure):
            hook(3)


# ------------------------------------------- suspect/resume liveness

def _spawn_resumable(ctrl, name, clock, *, slots=2):
    cfg = _tiny_cfg()
    engine = FakeEngine(cfg, EngineConfig(batch_slots=slots,
                                          cost_correction="online"),
                        clock)
    ctrl_ep, worker_ep = tp.local_pair()
    worker = FabricWorker(name, engine, worker_ep, clock=clock,
                          resumable=True)
    worker.announce()
    handle = ctrl.add_worker(ctrl_ep, driver=LocalWorkerDriver(worker),
                             name=name)
    return worker, handle


class TestSuspectResume:
    def _fleet(self, **ctrl_kw):
        clock = ManualClock()
        ctrl = Controller(heartbeat_timeout=4.0, clock=clock, **ctrl_kw)
        _spawn_fake(ctrl, "worker-a", clock)
        worker_b, handle_b = _spawn_resumable(ctrl, "worker-b", clock)
        return clock, ctrl, worker_b, handle_b

    def test_transient_partition_resumes_in_place(self):
        ref_ctrl, ref_reqs = _run(8, max_new=8)
        ref = {r.rid: list(r.tokens) for r in ref_reqs}

        clock, ctrl, worker_b, hb = self._fleet()
        reqs = _requests(8, max_new=8)
        for r in reqs:
            ctrl.submit(r)
        # let work land on both workers, then sever worker-b's link
        for _ in range(2):
            clock.advance(1.0)
            ctrl.tick()
        assert hb.replica.in_flight, "worker-b got no work"
        held = dict(hb.replica.in_flight)
        worker_b.endpoint.close()
        clock.advance(1.0)
        ctrl.tick()
        assert hb.state == "suspect"
        # suspicion HOLDS in-flight work (no requeue) and stops new
        # routing, the suspect's requests stay owned by it
        assert ctrl.scheduler.requeued == 0
        assert dict(hb.replica.in_flight) == held
        # heal: fresh pair, worker dials back in with Resume
        reattach_local_worker(ctrl, worker_b)
        ctrl.run_until_drained(advance=lambda: clock.advance(1.0))
        assert ctrl.scheduler.requeued == 0    # resume path, not requeue
        assert ctrl.resumed == 1
        assert ctrl.failures == []
        assert hb.state == "alive"
        assert worker_b.reconnects == 1
        assert sorted(ctrl.completed) == sorted(ref)
        for rid, req in ctrl.completed.items():
            assert req.tokens == ref[rid], f"rid {rid} diverged"

    def test_grace_expiry_requeues_and_late_resume_rejoins_empty(self):
        clock, ctrl, worker_b, hb = self._fleet(resume_grace=2.0)
        reqs = _requests(6, max_new=8)
        for r in reqs:
            ctrl.submit(r)
        for _ in range(2):
            clock.advance(1.0)
            ctrl.tick()
        assert hb.replica.in_flight
        worker_b.endpoint.close()
        # stay gone past the grace: the controller gives up holding
        for _ in range(4):
            clock.advance(1.0)
            ctrl.tick()
        assert hb.state == "dead"
        assert ctrl.failures == ["worker-b"]
        assert ctrl.scheduler.requeued > 0
        # the worker finally comes back: everything it held was
        # rerouted, so the ResumeAck cancels it all and it rejoins
        # as an empty-handed alive worker
        reattach_local_worker(ctrl, worker_b)
        ctrl.run_until_drained(advance=lambda: clock.advance(1.0))
        assert hb.state == "alive" and ctrl.resumed == 1
        # the cancel wiped its pre-death ledger; anything live now is
        # post-resume work it finished and retains for resume safety
        assert all(req.done for req, _ in worker_b._live.values())
        assert sorted(ctrl.completed) == [r.rid for r in reqs]
        for req in reqs:
            assert req.tokens == _expected_stream(req)

    def test_duplicated_chunks_never_duplicate_tokens(self):
        clock = ManualClock()
        ctrl = Controller(heartbeat_timeout=4.0, clock=clock)
        handle = _spawn_fake(ctrl, "w", clock)
        req = _requests(1, max_new=4)[0]
        ctrl.submit(req)
        for _ in range(32):
            if req.done:
                break
            clock.advance(1.0)
            ctrl.tick()
            if req.tokens is None or req.done:
                continue
            gen = [int(t) for t in req.tokens[len(req.prompt):]]
            # faithful duplicate of everything streamed so far: the
            # start offset trims it to nothing
            ctrl._on_tokens(handle, tp.TokenChunk(
                rid=req.rid, tokens=gen, start=0))
            # chunk from the future (its predecessor was lost): the
            # gap means it must be ignored outright
            ctrl._on_tokens(handle, tp.TokenChunk(
                rid=req.rid, tokens=[99], start=len(gen) + 5))
        assert req.done and req.tokens == _expected_stream(req)

    def test_suspect_worker_gets_no_new_work(self):
        clock, ctrl, worker_b, hb = self._fleet()
        for r in _requests(2, max_new=30):
            ctrl.submit(r)
        clock.advance(1.0)
        ctrl.tick()
        worker_b.endpoint.close()
        clock.advance(1.0)
        ctrl.tick()
        assert hb.state == "suspect"
        routed_before = hb.replica.routed
        for r in _requests(4, max_new=4, seed=9)[2:]:
            r.rid += 100
            ctrl.submit(r)
        for _ in range(3):
            clock.advance(0.1)             # stay inside the grace
            ctrl.tick()
        assert hb.replica.routed == routed_before


# --------------------------------------------- graceful degradation

class TestDegradation:
    def test_shed_factor_raises_retriable_fleet_busy(self):
        clock = ManualClock()
        ctrl = Controller(heartbeat_timeout=4.0, clock=clock,
                          shed_factor=1.0)
        _spawn_fake(ctrl, "w", clock, slots=2)   # capacity 2, limit 2
        reqs = _requests(5, max_new=4)
        ctrl.submit(reqs[0])
        ctrl.submit(reqs[1])
        with pytest.raises(FleetBusy) as ei:
            ctrl.submit(reqs[2])
        assert ei.value.retry_after > 0
        assert ctrl.shed == 1
        # FleetBusy is a FabricError: existing handlers still catch it
        assert isinstance(ei.value, FabricError)
        # the queue drains, admission reopens
        ctrl.run_until_drained(advance=lambda: clock.advance(1.0))
        ctrl.submit(reqs[2])
        ctrl.run_until_drained(advance=lambda: clock.advance(1.0))
        assert sorted(ctrl.completed) == [0, 1, 2]

    def test_malformed_frames_contained_not_fatal(self):
        clock = ManualClock()
        ctrl = Controller(heartbeat_timeout=4.0, clock=clock)
        _spawn_fake(ctrl, "worker-a", clock)
        hb = _spawn_fake(ctrl, "worker-b", clock)
        reqs = _requests(6, max_new=6)
        for r in reqs:
            ctrl.submit(r)
        clock.advance(1.0)
        ctrl.tick()
        # worker-b's stream turns to garbage mid-run
        hb.endpoint._in.append(b"\x00\x00\x00\x04ABCD")
        ctrl.run_until_drained(advance=lambda: clock.advance(1.0))
        assert "worker-b" in ctrl.peer_errors
        assert "worker-b" in ctrl.failures
        assert hb.endpoint.closed
        # the fleet routed around the bad peer with zero loss
        assert sorted(ctrl.completed) == [r.rid for r in reqs]
        for req in reqs:
            assert req.tokens == _expected_stream(req)

    def test_drain_deadline_reports_stragglers(self):
        clock = ManualClock()
        ctrl = Controller(heartbeat_timeout=1e9, clock=clock)

        def hang(tick):
            if tick >= 2:
                raise WorkerFailure("hung mid-drain")

        _spawn_fake(ctrl, "good", clock)
        _spawn_fake(ctrl, "hung", clock, failure_hook=hang)
        clock.advance(1.0)
        ctrl.tick()
        # the hung worker never answers Drained and (with the huge
        # heartbeat window) never dies either: the deadline must fire
        assert ctrl.drain(5.0,
                          advance=lambda: clock.advance(1.0)) is False
        assert ctrl.workers["good"].drained
        assert not ctrl.workers["hung"].drained

    def test_drain_completes_on_a_healthy_fleet(self):
        clock = ManualClock()
        ctrl = Controller(heartbeat_timeout=4.0, clock=clock)
        _spawn_fake(ctrl, "a", clock)
        _spawn_fake(ctrl, "b", clock)
        for r in _requests(4, max_new=3):
            ctrl.submit(r)
        assert ctrl.drain(50.0,
                          advance=lambda: clock.advance(1.0)) is True
        assert all(h.drained for h in ctrl.workers.values())
        assert len(ctrl.completed) == 4


# ------------------------------------------------ controller clocking

class TestControllerClock:
    def test_await_hello_deadline_runs_on_injected_clock(self):
        clock = ManualClock()
        ctrl = Controller(clock=clock, hello_timeout=5.0)
        endpoint, _ = tp.local_pair()       # peer that never speaks

        class MuteDriver:
            dead = False

            def tick(self):
                clock.advance(1.0)          # only the INJECTED clock moves

        with pytest.raises(FabricError, match="never announced"):
            ctrl.add_worker(endpoint, driver=MuteDriver())
        # the deadline fired from ManualClock advances alone — under
        # the old time.monotonic() mixing this would spin ~forever
        assert clock.t <= 7.0

    def test_await_hello_detects_closed_endpoint(self):
        clock = ManualClock()
        ctrl = Controller(clock=clock)
        a, b = tp.local_pair()
        b.close()
        with pytest.raises(FabricError, match="closed before Hello"):
            ctrl.add_worker(a, driver=None)

    def test_await_hello_contains_pre_hello_garbage(self):
        clock = ManualClock()
        ctrl = Controller(clock=clock)
        a, b = tp.local_pair()
        b.send_bytes(b"\x00\x00\x00\x02\xc1\xff")
        with pytest.raises(FabricError, match="garbage before Hello"):
            ctrl.add_worker(a, driver=None)
        assert a.closed


# ------------------------------------------- real-model checkpoint

POLICY = "int4_serving"


def _real_cfg():
    from repro_torch.configs import reduced
    return dataclasses.replace(reduced("qwen2-0.5b"), precision_policy=POLICY)


def _real_engine():
    """The smoke's replica: reduced qwen2 under int4_serving, calibrated,
    weights drawn from numpy seed 0, on the CPU."""
    from repro_torch.models import registry
    from repro_torch.serving.engine import ServingEngine
    cfg = _real_cfg()
    api = registry.build(cfg)
    config = EngineConfig(batch_slots=2, cache_len=64,
                          act_calibration="auto", cost_correction="online")
    return ServingEngine(cfg, api, api.init(0, "cpu", draws="numpy"),
                         config=config, device="cpu")


@pytest.fixture(scope="module")
def real_ckpt(tmp_path_factory):
    """A port-written serve-ready checkpoint and the single engine's
    greedy streams for ``smoke._make_requests(cfg, 8, 8, 0)``."""
    from repro_torch.fabric.checkpoint import (build_engine,
                                               save_engine_checkpoint)
    from repro_torch.fabric.smoke import _engine_streams, _make_requests
    ckpt = str(tmp_path_factory.mktemp("fabric") / "ckpt")
    save_engine_checkpoint(_real_engine(), ckpt, step=0)
    ref = _engine_streams(build_engine(ckpt, device="cpu"),
                          _make_requests(_real_cfg(), 8, 8, 0))
    return ckpt, ref


def _streams_by_prompt(completed):
    return {tuple(int(t) for t in r.prompt): list(r.tokens)
            for r in completed.values()}


class TestEngineCheckpoint:
    def test_prepared_engine_roundtrips_bit_exact(self, tmp_path):
        import torch

        from repro_torch.fabric.checkpoint import (build_engine,
                                                   load_engine_checkpoint,
                                                   save_engine_checkpoint)
        from repro_torch.quant.prepare import PreparedWeight, tree_manifest

        engine = _real_engine()
        save_engine_checkpoint(engine, str(tmp_path), step=0)

        rcfg, rconfig, rparams, rscales, _ = load_engine_checkpoint(
            str(tmp_path), device="cpu")
        assert rcfg == engine.cfg
        assert rconfig == dataclasses.replace(
            engine.config, act_calibration=rscales)
        assert rscales == {k: pytest.approx(float(v))
                           for k, v in engine.act_scales.items()}

        ref_def, ref_leaves = tree_manifest(engine.params)
        got_def, got_leaves = tree_manifest(rparams)
        assert ref_def == got_def
        assert any(isinstance(x, PreparedWeight)
                   for x in _walk(rparams))
        for ref, got in zip(ref_leaves, got_leaves):
            assert ref.dtype == got.dtype
            assert torch.equal(ref, got)

        # the rebuilt engine skipped quantize/pack/calibrate entirely
        restored = build_engine(str(tmp_path), device="cpu")
        assert restored.weight_quant_trace_count() == 0
        assert restored.act_quant_trace_count() == 0


def _walk(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _walk(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _walk(v)
    else:
        yield tree


# ------------------------------------------------- subprocess fleet

@pytest.mark.slow
class TestSubprocessFleet:
    """The real multi-process path: forked ``python -m repro_torch.fabric
    worker --device cpu`` processes dialing the controller's TCP
    listener — one from a local checkpoint, one via the Register ->
    RegisterAck checkpoint handoff. Real sockets, real wall clock, real
    engines."""

    def test_tcp_fleet_handoff_drain_shutdown(self, real_ckpt):
        from repro_torch.fabric.controller import spawn_subprocess_worker
        from repro_torch.fabric.smoke import _make_requests, _streams

        ckpt, ref = real_ckpt
        ctrl = Controller(heartbeat_timeout=120.0, checkpoint_dir=ckpt)
        ctrl.listen("127.0.0.1", 0)
        try:
            spawn_subprocess_worker(ctrl, ckpt, name="proc-a",
                                    device="cpu")
            # fresh host: forked WITHOUT --ckpt, takes its checkpoint
            # directory from the controller's RegisterAck handoff
            spawn_subprocess_worker(ctrl, name="proc-b", register=True,
                                    device="cpu")
            for r in _make_requests(_real_cfg(), 8, 8, 0):
                ctrl.submit(r)
            ctrl.run_until_drained(max_ticks=500_000)
            assert _streams(ctrl.completed) == ref
            assert ctrl.failures == []
            assert all(v > 0 for v in ctrl.routing_counters().values())
            assert ctrl.drain(60.0) is True
        finally:
            ctrl.shutdown()
        for h in ctrl.workers.values():
            assert h.process is not None
            assert h.process.poll() is not None   # actually exited


# ------------------------------------ the wire against the reference

def _ref_twin(msg):
    """The reference's message of the same type and fields."""
    return getattr(ref_tp, type(msg).__name__)(**dataclasses.asdict(msg))


def _same_message(a, b) -> bool:
    return (type(a).__name__ == type(b).__name__
            and dataclasses.asdict(a) == dataclasses.asdict(b))


WIRE = TestWireProtocol.MESSAGES + [
    # as the wire gives it back: tuples as lists
    tp.Hello(name="w1", policy="int8_serving", slots=8,
             model_config=msgpack.unpackb(msgpack.packb(
                 model_config_to_dict(_tiny_cfg(
                     moe=MoESpec(n_experts=4, top_k=2, d_expert=16),
                     rec_pattern=("rec", "attn")))))),
    tp.Resume(name="w1", progress={0: 0, 70000: 129, 2 ** 40: 7}),
    tp.ResumeAck(progress={5: 3, 300: 0}, cancel=[1, 2 ** 33]),
    tp.StatsSnapshot(name="w1", stats={
        "tok_per_s": np.float64(812.25), "queue_depth": 3,
        "active_slots": 2, "p95_ttft_s": np.float64(0.125),
        "ttft_samples": 4, "ticks": 17, "transported": False},
        slots=8, completed=5),
    tp.TokenChunk(rid=2 ** 31, tokens=list(range(300)), start=0),
    tp.SubmitRequest(rid=3, prompt=list(range(70000)), max_new_tokens=1,
                     tags=["a" * 40], temperature=1.0),
    tp.Heartbeat(tick=2 ** 40, time=-1.5),
]


@pytest.mark.parametrize("msg", WIRE, ids=lambda m: type(m).__name__)
def test_encode_bytes_equal_the_references_both_ways(msg):
    mine = tp.encode_message(msg)
    theirs = ref_tp.encode_message(_ref_twin(msg))
    assert mine == theirs
    assert _same_message(ref_tp.decode_message(mine), msg)
    assert tp.decode_message(theirs) == msg
    frame = tp.pack_frame(mine)
    assert frame == ref_tp.pack_frame(theirs)
    assert ref_tp.FrameDecoder().feed(frame) == tp.FrameDecoder().feed(
        frame) == [mine]


def test_every_message_type_is_covered():
    assert set(tp._MESSAGE_TYPES) == set(ref_tp._MESSAGE_TYPES)
    assert {type(m).__name__ for m in WIRE} == set(tp._MESSAGE_TYPES)
    for name, cls in tp._MESSAGE_TYPES.items():
        ref = ref_tp._MESSAGE_TYPES[name]
        assert [(f.name, f.default, f.default_factory)
                for f in dataclasses.fields(cls)] == [
            (f.name, f.default, f.default_factory)
            for f in dataclasses.fields(ref)], name
    assert tp.MAX_FRAME == ref_tp.MAX_FRAME


def test_package_exports_the_references_names():
    import repro.fabric
    import repro_torch.fabric
    assert repro_torch.fabric.__all__ == repro.fabric.__all__
    for name in repro_torch.fabric.__all__:
        assert getattr(repro_torch.fabric, name).__module__.startswith(
            "repro_torch."), name


def test_worker_telemetry_reads_in_the_reference():
    """A port worker's Hello and StatsSnapshot (measured tok/s and p95
    TTFT) decode in the reference and feed its ``model_config_from_dict``
    and ``ReplicaStats.ingest``."""
    from repro.fabric.checkpoint import \
        model_config_from_dict as ref_model_config_from_dict
    from repro.obs import ReplicaStats as RefReplicaStats
    clock = ManualClock()
    engine = FakeEngine(_tiny_cfg(), EngineConfig(batch_slots=2), clock)
    ctrl_ep, worker_ep = tp.local_pair()
    worker = FabricWorker("w", engine, worker_ep, clock=clock)
    worker.announce()
    for i in range(6):
        engine.stats.observe_ttft(0.1 * (i + 1))
    ctrl_ep.send(tp.SubmitRequest(rid=1, prompt=[1, 2], max_new_tokens=4))
    for _ in range(4):
        clock.advance(1.0)
        worker.tick()
    frames = list(ctrl_ep._in)
    msgs = [ref_tp.decode_message(f[4:]) for f in frames]
    hello = msgs[0]
    assert type(hello).__name__ == "Hello"
    cfg = ref_model_config_from_dict(hello.model_config)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(_tiny_cfg())
    snaps = [m for m in msgs if type(m).__name__ == "StatsSnapshot"]
    ref_stats = RefReplicaStats()
    ref_stats.ingest(snaps[-1].stats)
    assert ref_stats.snapshot() == _ingested(snaps[-1].stats)
    assert ref_stats.tok_per_s == engine.stats.tok_per_s
    assert ref_stats.p95_ttft_s == engine.stats.p95_ttft_s


def _ingested(stats):
    s = ReplicaStats()
    s.ingest(stats)
    return s.snapshot()


# ---------------------------------------------- the codec vs msgpack

class _Code(enum.IntEnum):
    BIG = 300


class _Str(str):
    pass


class _List(list):
    pass


_Pair = collections.namedtuple("_Pair", "a b")

SUBCLASSED = [np.float64(1.5), np.float64(-0.0), _Code.BIG, True,
              _Str("hi"), _List([1, _Code.BIG]), _Pair(1, np.float64(2)),
              collections.OrderedDict([("b", 1), ("a", np.float64(3))]),
              {"t": "StatsSnapshot", "f": {"stats": {
                  "tok_per_s": np.float64(1e300)}}}]


@pytest.mark.parametrize("obj", SUBCLASSED, ids=lambda o: type(o).__name__)
def test_subclasses_pack_as_msgpack_packs_them(obj):
    assert _msgpack.packb(obj) == msgpack.packb(obj)


def test_int_keys_read_only_when_asked():
    obj = {1: "a", -5: [1, 2], 2 ** 40: {"x": 1.5}, "s": {3: None}}
    data = _msgpack.packb(obj)
    assert data == msgpack.packb(obj)
    assert _msgpack.unpackb(data, strict_map_key=False) == \
        msgpack.unpackb(data, strict_map_key=False) == obj
    with pytest.raises(ValueError, match="only str keys"):
        _msgpack.unpackb(data)
    with pytest.raises(ValueError):
        msgpack.unpackb(data)


@pytest.mark.parametrize("obj", [np.int64(3), np.bool_(True), object()],
                         ids=lambda o: type(o).__name__)
def test_what_msgpack_refuses_is_refused(obj):
    with pytest.raises(TypeError):
        _msgpack.packb(obj)
    with pytest.raises(TypeError):
        msgpack.packb(obj)


HOSTILE = {
    "empty": b"",
    "reserved byte": b"\xc1",
    "truncated array": b"\x92\x01",
    "truncated str16": b"\xda\x00\x10abc",
    "truncated float": b"\xcb\x00\x00",
    "huge array32": b"\xdd\xff\xff\xff\xff",
    "huge map32": b"\xdf\xff\xff\xff\xff\xa1a",
    "array key": b"\x81\x91\x01\x02",
    "map key": b"\x81\x80\x02",
    "too deep": b"\x91" * 1025 + b"\x01",
    "too deep empty": b"\x91" * 1024 + b"\x90",
    "extra data": b"\x01\x02",
    "bad utf-8": b"\xa2\xff\xfe",
    "frame garbage": b"ABCD",
}


@pytest.mark.parametrize("name", sorted(HOSTILE))
def test_hostile_bytes_raise_value_error(name):
    data = HOSTILE[name]
    with pytest.raises(ValueError):
        _msgpack.unpackb(data, strict_map_key=False)
    with pytest.raises(Exception):
        msgpack.unpackb(data, strict_map_key=False)
    # the reference's decoder and the port's both type it
    with pytest.raises(tp.ProtocolError):
        tp.decode_message(data)
    with pytest.raises(ref_tp.ProtocolError):
        ref_tp.decode_message(data)


def test_deepest_legal_nesting_reads_as_msgpack_reads_it():
    data = b"\x91" * 1024 + b"\x01"
    assert _msgpack.unpackb(data) == msgpack.unpackb(data)


# ------------------------------------- chaos and backoff vs reference

CHAOS_SCHEDULES = {
    "drops+dups+partial": dict(seed=5, drop_rate=0.5, duplicate_every=3,
                               partial_every=4),
    "telemetry only": dict(seed=1, drop_rate=0.3,
                           droppable=("StatsSnapshot",), duplicate_every=2,
                           partial_every=3,
                           stall_heartbeats_between=(6.0, 10.0)),
    "delays": dict(seed=2, delay_msgs=((0, 5.0), (4, 2.0), (7, 0.5))),
    "reset": dict(seed=3, reset_at_msg=20, partial_every=5),
}


def _chaos_run(tp_mod, chaos_mod, kw):
    """40 ticks of (Heartbeat, StatsSnapshot, TokenChunk) sends through
    a ChaosEndpoint under a manual clock: its log, and what the other
    side received on each tick (type name and fields)."""
    clock = ManualClock()
    ctrl_side, worker_side = tp_mod.local_pair()
    ep = chaos_mod.ChaosEndpoint(worker_side, chaos_mod.FaultSchedule(**kw),
                                 clock)
    got = []
    for i in range(40):
        clock.advance(1.0)
        try:
            ep.send(tp_mod.Heartbeat(tick=i, time=clock.t))
            ep.send(tp_mod.StatsSnapshot(
                name="w", stats={"tok_per_s": np.float64(i)}, slots=2))
            ep.send(tp_mod.TokenChunk(rid=1, tokens=[i], start=i))
        except Exception as e:           # each package's TransportClosed
            got.append(("closed", type(e).__name__))
        got.append([(type(m).__name__, dataclasses.asdict(m))
                    for m in ctrl_side.poll()])
    return list(ep.log), got


@pytest.mark.parametrize("name", sorted(CHAOS_SCHEDULES))
def test_chaos_trace_equals_the_references(name):
    kw = CHAOS_SCHEDULES[name]
    mine = _chaos_run(tp, sys.modules["repro_torch.fabric.chaos"], kw)
    theirs = _chaos_run(ref_tp, ref_chaos, kw)
    assert mine == theirs
    assert any(a != "sent" for _, _, a in mine[0])


@pytest.mark.parametrize("kw", [
    dict(seed=0), dict(seed=3), dict(seed=4, base=0.5, factor=3.0),
    dict(seed=9, max_delay=0.3, jitter=0.0), dict(seed=11, jitter=1.0)])
def test_backoff_delays_equal_the_references(kw):
    assert tp.backoff_delays(12, **kw) == ref_tp.backoff_delays(12, **kw)
    assert tp.backoff_delays(0, **kw) == [] == ref_tp.backoff_delays(0, **kw)


# ------------------------------------------------ smoke and chaos CLIs

def test_fabric_smoke_meets_the_contract_on_the_cpu(capsys):
    from repro_torch.fabric.__main__ import main as cli
    assert cli(["smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "failover ok — worker-b died mid-flight" in out
    assert "fabric-smoke: PASS on cpu" in out


def test_fabric_chaos_meets_the_contract_on_the_cpu(capsys):
    from repro_torch.fabric.__main__ import main as cli
    assert cli(["chaos", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "partition ok — resumed in place" in out
    assert "chaos-smoke: PASS on cpu" in out


def test_cli_usage_and_exit_codes(capsys):
    """The reference's usage and exit codes: no command 2, help 0, an
    unknown command 2."""
    from repro.fabric.__main__ import main as ref_cli
    from repro_torch.fabric.__main__ import main as cli
    assert cli([]) == ref_cli([]) == 2
    assert cli(["--help"]) == ref_cli(["--help"]) == 0
    assert cli(["bench"]) == ref_cli(["bench"]) == 2
    assert "usage: python -m repro_torch.fabric" in capsys.readouterr().out


# ------------------------------------------------------ mixed fleets

def _requests_from(base, rid0):
    """Fresh requests with ``base``'s prompts and budgets."""
    return [Request(rid=rid0 + r.rid, prompt=np.array(r.prompt),
                    max_new_tokens=r.max_new_tokens, priority=r.priority)
            for r in base]


def test_jax_worker_and_port_worker_behind_the_ports_controller(real_ckpt):
    """A JAX worker (``python -m repro.fabric worker`` restoring the
    port-written checkpoint) and a port worker serve one wave behind the
    port's controller: every stream equals the single port engine's, and
    both routed. The port worker then dies mid-flight in a second wave:
    its work requeues onto the JAX worker, so every stream of that wave
    is the reference engine's, and still equals the port engine's."""
    from repro_torch.fabric.controller import spawn_local_worker
    from repro_torch.fabric.smoke import _make_requests
    from _torch_parity import _reference_env

    ckpt, ref = real_ckpt
    base = _make_requests(_real_cfg(), 8, 8, 0)
    want = {tuple(int(t) for t in r.prompt): ref[r.rid] for r in base}
    _, env = _reference_env()
    ctrl = Controller(heartbeat_timeout=300.0)
    listener = tp.Listener()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro.fabric", "worker", "--ckpt", ckpt,
         "--name", "jax-worker",
         "--connect", f"{listener.host}:{listener.port}"], env=env)
    try:
        try:
            endpoint = listener.accept(timeout=300.0)
        finally:
            listener.close()
        ctrl.add_worker(endpoint, process=proc, name="jax-worker",
                        hello_timeout=300.0)
        port = spawn_local_worker(ctrl, ckpt, name="port-worker",
                                  device="cpu")
        for r in _requests_from(base, 0):
            ctrl.submit(r)
        ctrl.run_until_drained(max_ticks=1_000_000)
        assert _streams_by_prompt(ctrl.completed) == want
        assert ctrl.routing_counters()["jax-worker"] > 0
        assert ctrl.routing_counters()["port-worker"] > 0
        report = ctrl.routing_report()
        assert all(r["measured"]["transported"]
                   for r in report["replicas"].values())

        for r in _requests_from(base, 100):
            ctrl.submit(r)
        for _ in range(1_000_000):
            ctrl.tick()
            if any(q.tokens is not None and len(q.tokens) > len(q.prompt)
                   for q in port.replica.in_flight.values()):
                break
        port.endpoint.close()          # the port worker's process exits
        ctrl.run_until_drained(max_ticks=1_000_000)
        assert ctrl.failures == ["port-worker"]
        assert ctrl.scheduler.requeued > 0
        second = {rid: q for rid, q in ctrl.completed.items()
                  if rid >= 100}
        assert len(second) == 8
        assert _streams_by_prompt(second) == want
        assert ctrl.drain(120.0) is True
    finally:
        ctrl.shutdown()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0


def _shared_pair(ref_side, port_side):
    """A reference endpoint (controller side) and a port endpoint
    (worker side) over one pair of deques and one closed flag."""
    to_worker, to_ctrl = collections.deque(), collections.deque()
    state = {"closed": False}
    return (ref_side.LocalEndpoint(to_ctrl, to_worker, state),
            port_side.LocalEndpoint(to_worker, to_ctrl, state))


def test_references_controller_drives_port_workers(real_ckpt):
    """The reference's ``Controller`` ticks two port ``FabricWorker``s in
    process over shared deques: it costs them from their Hello, routes
    on their transported stats, and every stream equals the single port
    engine's."""
    from repro.fabric.controller import Controller as RefController
    from repro.fabric.controller import LocalWorkerDriver as RefDriver
    from repro.fabric.controller import ManualClock as RefClock
    from repro.serving.engine import Request as RefRequest
    from repro_torch.fabric.checkpoint import build_engine
    from repro_torch.fabric.smoke import _make_requests

    ckpt, ref = real_ckpt
    clock = RefClock()
    ctrl = RefController(heartbeat_timeout=4.0, clock=clock)
    for name in ("port-a", "port-b"):
        ctrl_ep, worker_ep = _shared_pair(ref_tp, tp)
        engine = build_engine(ckpt, clock=clock, device="cpu")
        worker = FabricWorker(name, engine, worker_ep, clock=clock)
        worker.announce()
        handle = ctrl.add_worker(ctrl_ep, driver=RefDriver(worker),
                                 name=name)
        assert handle.replica.cost["cycles_per_token"] > 0
    reqs = [RefRequest(rid=r.rid, prompt=np.array(r.prompt),
                       max_new_tokens=r.max_new_tokens,
                       priority=r.priority)
            for r in _make_requests(_real_cfg(), 8, 8, 0)]
    for r in reqs:
        ctrl.submit(r)
    ctrl.run_until_drained(advance=lambda: clock.advance(1.0))
    assert {rid: list(r.tokens) for rid, r in ctrl.completed.items()} == ref
    assert all(v > 0 for v in ctrl.routing_counters().values())
    report = ctrl.routing_report()
    assert report["cost_correction"] == "online"
    for r in report["replicas"].values():
        assert r["measured"]["transported"]
        assert r["measured"]["tok_per_s"] is not None
