"""Fabric worker: a checkpoint-restored ServingEngine behind a transport
(the port's copy of ``repro/fabric/worker.py``).

``FabricWorker`` owns one :class:`~repro_torch.serving.engine.ServingEngine`
and one :class:`~repro_torch.fabric.transport.Endpoint` back to the
controller. Its ``tick()`` is the unit the whole fabric schedules in:

  1. fire the injectable ``failure_hook`` (raises
     :class:`repro_torch.runtime.fault_tolerance.WorkerFailure` to simulate a
     died node — the same signal the training runtime injects);
  2. drain the endpoint: ``SubmitRequest`` becomes an engine submit,
     ``Drain``/``Shutdown`` flip lifecycle state;
  3. advance the engine one step when it has pending work;
  4. stream back what changed: per-request ``TokenChunk`` deltas (only
     newly generated tokens cross the wire), one ``StatsSnapshot`` (the
     engine's measured ReplicaStats feed for the router's online cost
     correction), one ``Heartbeat``.

The worker never blocks on the transport; a controller that stops
submitting simply sees heartbeats. A worker that dies raises out of
``tick()`` — in-process drivers catch it and go silent, subprocess
workers exit and the closed socket is the controller's failure signal.
Either way the controller's view is the same: heartbeats stop.

A **resumable** worker (``resumable=True``) treats a severed endpoint
as an outage, not a death: its engine keeps stepping (in-flight
requests keep generating into local state) while disconnected, and
``reconnect(endpoint)`` re-attaches it — it sends a ``Resume`` message
carrying per-rid emitted-token counts, the controller answers a
``ResumeAck`` with the counts it actually *received* plus any rids it
rerouted while the worker was gone, and the worker rewinds each live
request's stream cursor to the controller's count. Tokens the
controller already has are never re-appended (every ``TokenChunk``
carries its generation ``start`` offset); tokens lost in flight are
retransmitted. Nothing restarts from scratch.

``worker_main`` is the subprocess entry (``python -m repro_torch.fabric
worker --ckpt DIR --connect HOST:PORT [--device cpu]``): restore from the
serve-ready checkpoint onto ``--device`` (CUDA by default; without CUDA
that raises before it dials), with zero quantize/calibrate work (see
fabric/checkpoint.py),
dial the controller (with jittered-exponential-backoff retry), announce,
loop. ``--register`` (no ``--ckpt``) is the fresh-host path: the worker
sends ``Register`` first and restores from whatever checkpoint
directory the controller's ``RegisterAck`` hands it. ``--resume`` makes
a dropped connection trigger redial + ``Resume`` instead of exit.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.fabric import transport as tp


class FabricWorker:
    def __init__(self, name: str, engine, endpoint: tp.Endpoint, *,
                 clock: Optional[Callable[[], float]] = None,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 resumable: bool = False):
        self.name = name
        self.engine = engine
        self.endpoint = endpoint
        self.clock = clock if clock is not None else engine.clock
        self.failure_hook = failure_hook
        self.resumable = resumable
        self.tick_count = 0
        self.draining = False
        self._shutdown = False
        # requests this worker received over the fabric that still owe
        # the controller tokens: rid -> (engine Request, tokens sent)
        self._live: Dict[int, tuple] = {}
        self._done_sent: set = set()   # done chunk emitted, unsettled
        self._retired: list = []       # FIFO of finished rids kept live
        self.reconnects = 0

    # ------------------------------------------------------------ protocol

    def announce(self) -> None:
        from repro_torch.fabric.checkpoint import model_config_to_dict
        self.endpoint.send(tp.Hello(
            name=self.name,
            policy=self.engine.cfg.precision_policy,
            slots=self.engine.b,
            model_config=model_config_to_dict(self.engine.cfg),
            cost_correction=self.engine.config.cost_correction,
            resumable=self.resumable))

    @staticmethod
    def _generated(req) -> int:
        return 0 if req.tokens is None \
            else len(req.tokens) - len(req.prompt)

    def reconnect(self, endpoint: tp.Endpoint) -> None:
        """Re-attach after a severed connection: adopt the fresh
        endpoint and open the resume handshake with this worker's
        per-rid emitted-token ledger. The engine state was never lost —
        only the wire was."""
        if not self.resumable:
            raise RuntimeError(
                f"worker {self.name!r} is not resumable — spawn it "
                f"with resumable=True to survive severed endpoints")
        self.endpoint = endpoint
        self.reconnects += 1
        self.endpoint.send(tp.Resume(
            name=self.name,
            progress={int(rid): self._generated(req)
                      for rid, (req, _) in self._live.items()}))

    def _handle(self, msg) -> None:
        from repro_torch.serving.config import SamplingParams
        from repro_torch.serving.engine import Request

        if isinstance(msg, tp.SubmitRequest):
            req = Request(
                rid=msg.rid,
                prompt=np.asarray(msg.prompt, np.int32),
                max_new_tokens=msg.max_new_tokens,
                priority=msg.priority,
                tags=tuple(msg.tags),
                sampling=SamplingParams(
                    temperature=msg.temperature, top_k=msg.top_k,
                    top_p=msg.top_p, stop_ids=tuple(msg.stop_ids),
                    seed=msg.seed))
            self.engine.submit(req)
            self._live[msg.rid] = (req, 0)
        elif isinstance(msg, tp.ResumeAck):
            # rewind each live request's stream cursor to what the
            # controller actually received: anything beyond it was lost
            # in flight and will retransmit; anything at or below is
            # deduped by the cursor itself
            for rid, have in msg.progress.items():
                rid = int(rid)
                if rid in self._live:
                    req, _ = self._live[rid]
                    self._live[rid] = (req, int(have))
                    # the controller still wants this rid: if its done
                    # chunk was lost, let _stream re-emit it
                    self._done_sent.discard(rid)
            for rid in msg.cancel:
                rid = int(rid)
                self._live.pop(rid, None)
                self._done_sent.discard(rid)
                if rid in self._retired:
                    self._retired.remove(rid)
        elif isinstance(msg, tp.Drain):
            self.draining = True
        elif isinstance(msg, tp.Shutdown):
            self._shutdown = True

    # finished-but-unacknowledged retention for resumable workers: a
    # done chunk lost to a severing connection must be replayable from
    # the Resume ledger, so finished requests stay live until a
    # ResumeAck settles them (bounded — the cap only matters across
    # repeated severances)
    RETIRE_KEEP = 256

    def _stream(self) -> None:
        """Send every request's newly generated tokens as one delta
        chunk (stamped with its generation ``start`` offset so the
        receiver can dedup); a finishing request's chunk carries
        ``done`` and the finish metadata, then leaves the live set —
        resumable workers retain it until resume reconciliation
        confirms the controller is settled."""
        finished = []
        for rid, (req, sent) in self._live.items():
            if req.tokens is None:       # still queued / prefilling
                continue
            if req.done and rid in self._done_sent:
                continue
            gen = req.tokens[len(req.prompt) + sent:]
            if gen or req.done:
                self.endpoint.send(tp.TokenChunk(
                    rid=rid, tokens=[int(t) for t in gen],
                    done=req.done, finish_reason=req.finish_reason,
                    truncated=req.truncated, start=sent))
                self._live[rid] = (req, sent + len(gen))
            if req.done:
                finished.append(rid)
        for rid in finished:
            if self.resumable:
                self._done_sent.add(rid)
                if rid not in self._retired:
                    self._retired.append(rid)
                while len(self._retired) > self.RETIRE_KEEP:
                    old = self._retired.pop(0)
                    self._live.pop(old, None)
                    self._done_sent.discard(old)
            else:
                del self._live[rid]

    # ---------------------------------------------------------------- loop

    @property
    def connected(self) -> bool:
        return not self.endpoint.closed

    def tick(self) -> bool:
        """One worker scheduling quantum; returns False after Shutdown.
        Raises WorkerFailure out of an armed ``failure_hook`` — the
        caller decides whether that is a silent death (in-process
        driver) or a process exit (subprocess main). A resumable
        worker whose endpoint is severed (or severs mid-tick) keeps
        stepping its engine offline — in-flight requests keep
        generating into local state — until ``reconnect`` re-attaches
        it; a non-resumable worker raises TransportClosed as before."""
        if self.failure_hook is not None:
            self.failure_hook(self.tick_count)
        self.tick_count += 1
        if self.endpoint.closed:
            if not self.resumable:
                raise tp.TransportClosed(
                    f"worker {self.name!r} lost its controller")
            if self.engine.has_pending():
                self.engine.step()
            return True
        try:
            for msg in self.endpoint.poll():
                self._handle(msg)
            if self._shutdown:
                return False
            if self.engine.has_pending():
                self.engine.step()
            self._stream()
            self.endpoint.send(tp.StatsSnapshot(
                name=self.name, stats=self.engine.stats.snapshot(),
                slots=self.engine.b,
                completed=len(self.engine.completed)))
            self.endpoint.send(tp.Heartbeat(tick=self.tick_count,
                                            time=float(self.clock())))
            if self.draining and not self.engine.has_pending() \
                    and not self._live:
                self.endpoint.send(tp.Drained(
                    completed=len(self.engine.completed)))
                self.draining = False
        except tp.TransportClosed:
            if not self.resumable:
                raise
            # severed mid-tick: stream cursors only advance after a
            # successful send, so nothing is marked delivered that was
            # not; the engine state is intact and resume reconciles
        return True

    def run(self, idle_sleep: float = 0.002) -> None:
        while True:
            busy = self.engine.has_pending()
            if self.endpoint.closed and self.resumable:
                # surface the outage so the caller can redial and
                # reconnect() — the in-process driver path instead
                # keeps ticking through the disconnection
                raise tp.TransportClosed(
                    f"worker {self.name!r} disconnected")
            if not self.tick():
                return
            if not busy and not self.engine.has_pending():
                time.sleep(idle_sleep)      # don't spin an idle worker


def _await_register_ack(endpoint: tp.Endpoint,
                        timeout: float = 60.0) -> tp.RegisterAck:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for msg in endpoint.poll():
            if isinstance(msg, tp.RegisterAck):
                return msg
        time.sleep(0.01)
    raise tp.TransportClosed(
        f"controller never answered Register within {timeout}s")


def worker_main(argv=None) -> int:
    """Subprocess entry: restore a serve-ready engine from a checkpoint
    and serve it over a socket back to the controller.

    ``--register`` (checkpoint handoff): dial in WITHOUT a local
    checkpoint, send ``Register``, restore from the directory the
    controller's ``RegisterAck`` names — the fresh-host deployment
    path. ``--resume``: survive a dropped controller connection by
    redialing (jittered exponential backoff) and resuming in place —
    in-flight requests keep their engine state and already-streamed
    tokens are never re-sent.
    """
    import argparse

    from repro_torch.device import resolve_device
    from repro_torch.fabric.checkpoint import build_engine

    ap = argparse.ArgumentParser(prog="repro_torch.fabric worker")
    ap.add_argument("--ckpt", default=None,
                    help="serve-ready checkpoint directory (omit with "
                    "--register to restore from the controller's "
                    "handoff)")
    ap.add_argument("--name", default="worker")
    ap.add_argument("--connect", required=True, metavar="HOST:PORT")
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--register", action="store_true",
                    help="announce via Register and take the "
                    "checkpoint directory from RegisterAck")
    ap.add_argument("--resume", action="store_true",
                    help="reconnect-and-resume on a dropped "
                    "controller connection instead of exiting")
    ap.add_argument("--retry", type=int, default=8,
                    help="connection attempts (jittered exponential "
                    "backoff between them)")
    ap.add_argument("--seed", type=int, default=0,
                    help="backoff jitter seed")
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine runs on (default cuda; "
                    "--device cpu runs the plain PyTorch versions)")
    args = ap.parse_args(argv)
    if args.ckpt is None and not args.register:
        ap.error("--ckpt is required unless --register is given")
    device = resolve_device(args.device)

    host, port = args.connect.rsplit(":", 1)
    port = int(port)
    endpoint = tp.connect_with_retry(host, port, attempts=args.retry,
                                     seed=args.seed)
    ckpt, step = args.ckpt, args.step
    if args.register:
        endpoint.send(tp.Register(name=args.name,
                                  need_checkpoint=ckpt is None))
        if ckpt is None:
            ack = _await_register_ack(endpoint)
            ckpt, step = ack.ckpt_dir, ack.step
    engine = build_engine(ckpt, step, device=device)
    worker = FabricWorker(args.name, engine, endpoint,
                          resumable=args.resume)
    worker.announce()
    try:
        while True:
            try:
                worker.run()
                return 0                  # orderly Shutdown
            except (tp.TransportClosed, tp.ProtocolError):
                if not args.resume:
                    return 0              # controller went away
            endpoint.close()
            try:
                endpoint = tp.connect_with_retry(
                    host, port, attempts=args.retry, seed=args.seed)
            except tp.TransportClosed:
                return 0                  # controller really is gone
            worker.reconnect(endpoint)
    finally:
        endpoint.close()
    return 0
