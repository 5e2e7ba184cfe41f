"""Fabric controller: the router promoted to a control plane (the port's
copy of ``repro/fabric/controller.py``).

The controller owns the fleet-level waiting line (an
:class:`~repro_torch.serving.scheduler.AdmissionScheduler`), a
:class:`~repro_torch.serving.router.Router` whose replicas are
:class:`RemoteReplica` views over transports, and the failure policy:

  * **placement** — the unchanged Router strategies (plan-aware static
    cost, online measured correction) rank RemoteReplicas exactly like
    in-process ones, because the Replica protocol surface is identical;
    the measured :class:`~repro_torch.obs.ReplicaStats` are *ingested from
    transported StatsSnapshot messages* instead of read off an engine;
  * **streaming** — workers send per-request ``TokenChunk`` deltas; the
    controller accumulates them onto its canonical ``Request`` objects
    (the ones callers submitted), so callers observe finished requests
    exactly as with a local engine;
  * **failure** — liveness is a two-stage suspect -> dead state
    machine. A worker whose heartbeats go stale for ``suspect_after``
    seconds (or whose endpoint closes, if it announced itself
    resumable) becomes SUSPECT: the controller stops routing new work
    to it but HOLDS its in-flight requests — a GC pause, a transient
    partition, or a reconnecting process should not trigger
    rework. A suspect worker that heartbeats again (or dials back in
    with a ``Resume``) returns to the fleet with its in-flight work
    intact; one that stays silent past ``heartbeat_timeout`` (or
    severed past ``resume_grace``) is DEAD: every in-flight request
    requeues at the FRONT of the fleet scheduler
    (``AdmissionScheduler.requeue``) and the router rebuilds over the
    survivors — no request is lost, and because greedy decode streams
    are placement-independent the re-served tokens are identical to
    the no-failure run. A non-resumable worker's closed endpoint is
    still immediate death (a process exit has nothing to resume);
  * **resume** — a reconnecting worker's ``Resume`` carries per-rid
    emitted-token counts; the controller answers with the counts it
    actually *received* (the worker rewinds its stream cursors there —
    already-streamed tokens are never re-appended, lost ones
    retransmit) plus the rids it rerouted while the worker was gone.
    A transient partition therefore recovers IN PLACE: requeued == 0,
    zero token loss, zero duplicated tokens;
  * **degradation** — when ``shed_factor`` is set, admission sheds
    (``FleetBusy`` with a ``retry_after`` estimate) once the fleet
    queue outgrows the routable capacity, instead of growing the
    waiting line without bound while the fleet is degraded;
    ``drain(deadline)`` bounds how long a drain may take, and
    ``shutdown`` force-kills subprocess workers that ignore it;
  * **containment** — a peer that sends malformed frames (corrupt
    msgpack, unknown message type, oversized frame) raises a typed
    :class:`~repro_torch.fabric.transport.ProtocolError` at the decode
    boundary; the controller records it, closes the endpoint, declares
    the worker dead and requeues its work. Garbage never hangs or
    crashes the control plane.

``spawn_local_worker`` runs the worker in-process behind the same wire
codec (a :class:`LocalWorkerDriver` the controller ticks; an injected
:class:`~repro_torch.runtime.fault_tolerance.WorkerFailure` makes it
*silently* dead, exercising the heartbeat-timeout path
deterministically under a :class:`ManualClock`). ``spawn_subprocess_
worker`` is the real multi-process path over TCP (the child runs
``python -m repro_torch.fabric worker`` with this package on its
``PYTHONPATH``). Both take ``device=``: the worker's engine runs there
(CUDA by default). For deployment the
flow inverts: ``listen()`` opens a :class:`~repro_torch.fabric.transport.
Listener` and dial-in workers (``python -m repro_torch.fabric worker
--connect --register [--resume]``) attach themselves whenever they
arrive — including fresh hosts that take their checkpoint directory
from the controller's ``RegisterAck`` handoff (``checkpoint_dir=``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.fabric import transport as tp
from repro_torch.obs import ReplicaStats
from repro_torch.runtime.fault_tolerance import WorkerFailure
from repro_torch.serving.engine import Request
from repro_torch.serving.scheduler import AdmissionScheduler


class FabricError(RuntimeError):
    """Fleet-level failure the controller cannot route around (e.g. no
    alive workers left with work still queued)."""


class FleetBusy(FabricError):
    """Retriable admission shed: the fleet's routable capacity cannot
    absorb more queued work right now (degraded fleet backpressure).
    ``retry_after`` estimates, in controller-clock seconds, when the
    queue should have drained enough to try again."""

    def __init__(self, msg: str, retry_after: float):
        super().__init__(msg)
        self.retry_after = float(retry_after)


class ManualClock:
    """Injectable monotonic clock for deterministic fabric tests: time
    advances only when the test says so."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t


class RemoteReplica:
    """The Router's Replica protocol implemented over a transport.

    ``stats`` is a local :class:`ReplicaStats` mirror fed by
    ``ingest()`` from transported snapshots — the router's online cost
    correction blends transported measurements without knowing the
    engine lives elsewhere. ``in_flight`` is the controller's ledger of
    requests placed on this worker that have not finished; it is what
    failure recovery requeues.
    """

    def __init__(self, name: str, policy_name: str,
                 endpoint: tp.Endpoint, *, slots: int,
                 cost: Optional[Dict] = None,
                 cost_correction: str = "static"):
        self.name = name
        self.policy_name = policy_name
        self.endpoint = endpoint
        self.slots = max(int(slots), 1)
        self.cost = dict(cost) if cost else {}
        self.routed = 0
        self.stats = ReplicaStats()
        self.in_flight: Dict[int, Request] = {}
        self.completed: Dict[int, Request] = {}
        self._cost_correction = cost_correction

    @property
    def cost_correction(self) -> str:
        return self._cost_correction

    @property
    def load(self) -> float:
        """Controller-truth occupancy: requests placed but unfinished
        over slots (the transported queue depth lags one tick)."""
        return len(self.in_flight) / self.slots

    def submit(self, req: Request) -> None:
        sp = req.sampling
        self.endpoint.send(tp.SubmitRequest(
            rid=req.rid,
            prompt=[int(t) for t in req.prompt],
            # the effective budget: sampling.max_new_tokens already
            # folded in (the wire carries one budget field)
            max_new_tokens=req.budget,
            priority=req.priority,
            tags=list(req.tags),
            temperature=sp.temperature, top_k=sp.top_k, top_p=sp.top_p,
            stop_ids=list(sp.stop_ids), seed=sp.seed))
        self.in_flight[req.rid] = req

    def has_pending(self) -> bool:
        return bool(self.in_flight)

    def step(self) -> None:
        """Workers drive their own engines; the controller's tick pump
        moves the tokens. Nothing to do here."""

    def metrics(self) -> Dict:
        return {
            "completed": len(self.completed),
            "in_flight": len(self.in_flight),
            "routed": self.routed,
            "replica_stats": self.stats.snapshot(),
        }


class LocalWorkerDriver:
    """Ticks a FabricWorker in-process. A raised
    :class:`WorkerFailure` kills it SILENTLY: the worker stops
    heartbeating but its endpoint stays open — the shape of a hung or
    partitioned node, which only the controller's heartbeat timeout can
    detect (process death closes the socket and is detected
    immediately)."""

    def __init__(self, worker):
        self.worker = worker
        self.dead = False
        self.failure: Optional[WorkerFailure] = None

    def tick(self) -> None:
        if self.dead:
            return
        try:
            self.worker.tick()
        except WorkerFailure as e:
            self.dead = True
            self.failure = e
        except tp.TransportClosed:
            # the controller-side endpoint is gone: the in-process
            # analogue of a worker whose process lost its socket
            self.dead = True


@dataclasses.dataclass
class WorkerHandle:
    name: str
    endpoint: tp.Endpoint
    replica: RemoteReplica
    driver: Optional[LocalWorkerDriver] = None
    process: Optional[object] = None       # subprocess.Popen, if spawned
    last_heartbeat: Optional[float] = None
    # two-stage liveness: alive -> suspect (stale heartbeats or a
    # severed-but-resumable endpoint; no new work, in-flight HELD) ->
    # dead (grace expired; in-flight requeued). Suspect is reversible.
    state: str = "alive"
    suspect_since: Optional[float] = None
    resumable: bool = False
    drained: bool = False                  # answered the last Drain

    @property
    def alive(self) -> bool:
        """Not declared dead (suspect counts: its work is still held)."""
        return self.state != "dead"

    @property
    def routable(self) -> bool:
        """Eligible for NEW work: alive and not under suspicion."""
        return self.state == "alive"


@dataclasses.dataclass
class PendingEndpoint:
    """An accepted connection that has not identified itself yet (no
    Hello/Resume seen). Dial-in workers and reconnecting workers park
    here until their first protocol message classifies them."""
    endpoint: tp.Endpoint
    since: float
    driver: Optional[LocalWorkerDriver] = None
    process: Optional[object] = None
    backlog: List = dataclasses.field(default_factory=list)


class Controller:
    """Places requests across fabric workers and survives their death."""

    def __init__(self, *, strategy: str = "plan_aware",
                 cost_correction: Optional[str] = None,
                 online_blend: float = 0.75,
                 heartbeat_timeout: float = 5.0,
                 suspect_after: Optional[float] = None,
                 resume_grace: Optional[float] = None,
                 max_queue: int = 1024,
                 shed_factor: Optional[float] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_step: Optional[int] = None,
                 hello_timeout: float = 30.0,
                 shutdown_timeout: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.strategy = strategy
        self._cost_correction = cost_correction
        self.online_blend = online_blend
        self.heartbeat_timeout = heartbeat_timeout
        # suspicion begins at half the death window unless pinned;
        # death timing is unchanged from the one-stage detector
        self.suspect_after = (heartbeat_timeout / 2.0
                              if suspect_after is None else suspect_after)
        if not (0 < self.suspect_after <= heartbeat_timeout):
            raise ValueError(
                f"suspect_after {self.suspect_after} must be in "
                f"(0, heartbeat_timeout={heartbeat_timeout}]")
        # how long a severed resumable worker may stay gone before its
        # work requeues (measured from suspicion, i.e. the severance)
        self.resume_grace = (heartbeat_timeout if resume_grace is None
                             else resume_grace)
        self.clock = clock
        self.scheduler = AdmissionScheduler(max_queue=max_queue)
        # backpressure: shed new submits once the queue exceeds
        # shed_factor x routable slots (None = bounded queue only)
        self.shed_factor = shed_factor
        # checkpoint handoff for dial-in workers that Register without
        # local weights (the fresh-host deployment path)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_step = checkpoint_step
        self.hello_timeout = hello_timeout
        self.shutdown_timeout = shutdown_timeout
        self.workers: Dict[str, WorkerHandle] = {}
        self.listener: Optional[tp.Listener] = None
        self._pending: List[PendingEndpoint] = []
        self.router = None
        self.completed: Dict[int, Request] = {}
        self.requests: Dict[int, Request] = {}
        self.ticks = 0
        self.failures: List[str] = []     # names of workers declared dead
        self.suspects: List[str] = []     # every suspect transition
        self.resumed = 0                  # successful Resume handshakes
        self.shed = 0                     # FleetBusy admission rejections
        self.peer_errors: Dict[str, str] = {}   # name -> ProtocolError

    # ------------------------------------------------------------- fleet

    def _rebuild_router(self) -> None:
        from repro_torch.serving.router import Router
        routable = [h.replica for h in self.workers.values()
                    if h.routable]
        self.router = Router(routable, strategy=self.strategy,
                             cost_correction=self._cost_correction,
                             online_blend=self.online_blend) \
            if routable else None

    def listen(self, host: str = "127.0.0.1",
               port: int = 0) -> tp.Listener:
        """Open the dial-in accept socket: workers that ``connect``
        to (``listener.host``, ``listener.port``) are adopted by the
        tick loop whenever they arrive — worker discovery instead of
        controller-initiated spawn."""
        self.listener = tp.Listener(host, port)
        return self.listener

    def adopt_endpoint(self, endpoint: tp.Endpoint, *,
                       driver: Optional[LocalWorkerDriver] = None,
                       process=None) -> None:
        """Park an unidentified connection; the tick loop classifies
        it by its first protocol message (Hello = new worker, Resume =
        a known worker reconnecting, Register = a fresh host asking
        for the checkpoint handoff)."""
        self._pending.append(PendingEndpoint(
            endpoint=endpoint, since=self.clock(), driver=driver,
            process=process))

    def add_worker(self, endpoint: tp.Endpoint, *,
                   driver: Optional[LocalWorkerDriver] = None,
                   process=None, name: Optional[str] = None,
                   hello_timeout: Optional[float] = None) -> WorkerHandle:
        """Register a worker from its announced identity: wait for its
        ``Hello``, derive the static routing cost from the transported
        model config + policy, add it to the router's fleet."""
        hello, backlog = self._await_hello(
            endpoint, driver,
            self.hello_timeout if hello_timeout is None
            else hello_timeout)
        handle = self._register(endpoint, hello, driver=driver,
                                process=process, name=name)
        for msg in backlog:               # stats/heartbeats behind Hello
            self._handle_message(handle, msg)
        self._rebuild_router()
        return handle

    def _register(self, endpoint: tp.Endpoint, hello: tp.Hello, *,
                  driver=None, process=None,
                  name: Optional[str] = None) -> WorkerHandle:
        wname = name if name is not None else hello.name
        if wname in self.workers:
            n = sum(1 for k in self.workers if k == wname
                    or k.startswith(f"{wname}#"))
            wname = f"{wname}#{n}"
        cost = self._static_cost(hello)
        replica = RemoteReplica(
            wname, hello.policy, endpoint, slots=hello.slots, cost=cost,
            cost_correction=getattr(hello, "cost_correction", "static"))
        handle = WorkerHandle(name=wname, endpoint=endpoint,
                              replica=replica, driver=driver,
                              process=process,
                              last_heartbeat=self.clock(),
                              resumable=bool(getattr(hello, "resumable",
                                                     False)))
        self.workers[wname] = handle
        return handle

    def _answer_register(self, endpoint: tp.Endpoint,
                         msg: tp.Register) -> None:
        """The checkpoint-dir handoff: a fresh host Registers without
        local weights and restores from whatever we hand back."""
        if not msg.need_checkpoint:
            return                        # pure announcement, no reply
        if self.checkpoint_dir is None:
            raise FabricError(
                f"worker {msg.name!r} asked for a checkpoint handoff "
                f"but the controller has no checkpoint_dir configured")
        endpoint.send(tp.RegisterAck(ckpt_dir=self.checkpoint_dir,
                                     step=self.checkpoint_step))

    def _await_hello(self, endpoint, driver, timeout):
        # all deadlines run on the controller's injectable clock —
        # mixing in time.monotonic() here made hello timeouts
        # non-deterministic under a ManualClock
        deadline = self.clock() + timeout
        backlog: List = []
        while True:
            if driver is not None:
                driver.tick()             # let an in-process worker talk
            try:
                msgs = endpoint.poll()
            except tp.ProtocolError as e:
                endpoint.close()
                raise FabricError(
                    f"worker sent garbage before Hello: {e}")
            for msg in msgs:
                if isinstance(msg, tp.Hello):
                    return msg, backlog
                if isinstance(msg, tp.Register):
                    self._answer_register(endpoint, msg)
                    continue
                backlog.append(msg)
            if driver is not None and driver.dead:
                raise FabricError(
                    "worker died before announcing (no Hello)")
            if endpoint.closed:
                raise FabricError(
                    "worker connection closed before Hello")
            if self.clock() > deadline:
                raise FabricError("worker never announced (no Hello "
                                  f"within {timeout}s)")
            if driver is None:
                time.sleep(0.01)

    def _static_cost(self, hello: tp.Hello) -> Dict:
        if not hello.model_config:
            return {}
        from repro_torch.core import policy as policy_mod
        from repro_torch.fabric.checkpoint import model_config_from_dict
        from repro_torch.serving.router import replica_cost
        cfg = model_config_from_dict(hello.model_config)
        cfg = dataclasses.replace(cfg, precision_policy=hello.policy)
        return replica_cost(cfg, policy_mod.get_policy(hello.policy))

    # --------------------------------------------------------- submission

    def submit(self, req: Request) -> None:
        if self.shed_factor is not None:
            capacity = sum(h.replica.slots
                           for h in self.workers.values() if h.routable)
            limit = (max(1, int(self.shed_factor * capacity))
                     if capacity else 0)
            if len(self.scheduler) >= limit:
                self.shed += 1
                raise FleetBusy(
                    f"fleet queue at {len(self.scheduler)} with "
                    f"routable capacity {capacity} (shed_factor="
                    f"{self.shed_factor}); retry later",
                    retry_after=self._retry_after())
        self.scheduler.submit(req, now=self.clock())
        self.requests[req.rid] = req

    def _retry_after(self) -> float:
        """Estimate when the queue should have drained enough to admit:
        pending decode work over the fleet's measured throughput, with
        the heartbeat window as the floor/fallback."""
        tput = sum(h.replica.stats.tok_per_s or 0.0
                   for h in self.workers.values() if h.routable)
        if tput <= 0:
            return self.heartbeat_timeout
        pending = self.scheduler.pending_new_tokens()
        return max(self.heartbeat_timeout / 2.0, pending / tput)

    # --------------------------------------------------------------- tick

    def tick(self) -> int:
        """One control-plane quantum: drive in-process workers, pump
        their messages, detect deaths (requeueing their in-flight
        work), dispatch from the fleet queue. Returns the number of
        inbound messages handled — 0 means the fleet gave us nothing
        this quantum (``run_until_drained`` uses it to pace polling
        of subprocess workers)."""
        self._pump_listener()
        for h in self.workers.values():
            if h.alive and h.driver is not None:
                h.driver.tick()
        handled = 0
        for h in list(self.workers.values()):
            if not h.alive:
                continue
            try:
                msgs = h.endpoint.poll()
            except tp.ProtocolError as e:
                # malformed-frame containment: record, close, declare
                # dead — garbage never hangs the control plane
                self.peer_errors[h.name] = str(e)
                h.endpoint.close()
                self._on_worker_death(h)
                continue
            for msg in msgs:
                self._handle_message(h, msg)
                handled += 1
        handled += self._identify_pending()
        self._detect_failures()
        self._dispatch()
        self.ticks += 1
        return handled

    def _pump_listener(self) -> None:
        if self.listener is None:
            return
        while True:
            ep = self.listener.poll_accept()
            if ep is None:
                return
            self.adopt_endpoint(ep)

    def _identify_pending(self) -> int:
        """Classify parked connections by their first protocol message:
        Hello = new worker joins the fleet, Resume = a known worker
        reconnecting, Register = a fresh host asking for the checkpoint
        handoff (stays pending until its Hello). Garbage or silence past
        ``hello_timeout`` drops the connection."""
        handled = 0
        still: List[PendingEndpoint] = []
        now = self.clock()
        for pe in self._pending:
            if pe.driver is not None:
                pe.driver.tick()
            try:
                msgs = pe.endpoint.poll()
            except tp.ProtocolError as e:
                self.peer_errors[f"<pending@{pe.since:.3f}>"] = str(e)
                pe.endpoint.close()
                continue
            handle: Optional[WorkerHandle] = None
            for msg in msgs:
                handled += 1
                if handle is not None:
                    self._handle_message(handle, msg)
                    continue
                if isinstance(msg, tp.Hello):
                    handle = self._register(pe.endpoint, msg,
                                            driver=pe.driver,
                                            process=pe.process)
                    for m in pe.backlog:
                        self._handle_message(handle, m)
                    pe.backlog.clear()
                    self._rebuild_router()
                elif isinstance(msg, tp.Resume):
                    handle = self._on_resume(pe.endpoint, msg,
                                             driver=pe.driver,
                                             process=pe.process)
                    if handle is None:
                        pe.endpoint.close()
                        break
                elif isinstance(msg, tp.Register):
                    try:
                        self._answer_register(pe.endpoint, msg)
                    except FabricError as e:
                        self.peer_errors[msg.name] = str(e)
                        pe.endpoint.close()
                        break
                else:
                    pe.backlog.append(msg)
            if handle is not None or pe.endpoint.closed:
                continue
            if now - pe.since > self.hello_timeout:
                pe.endpoint.close()       # never identified itself
                continue
            still.append(pe)
        self._pending = still
        return handled

    def _handle_message(self, h: WorkerHandle, msg) -> None:
        if isinstance(msg, tp.TokenChunk):
            self._on_tokens(h, msg)
        elif isinstance(msg, tp.StatsSnapshot):
            h.replica.stats.ingest(msg.stats)
        elif isinstance(msg, tp.Heartbeat):
            h.last_heartbeat = self.clock()
        elif isinstance(msg, tp.Drained):
            h.drained = True
        # Hello is a lifecycle ack; nothing to update

    def _on_tokens(self, h: WorkerHandle, msg: tp.TokenChunk) -> None:
        req = h.replica.in_flight.get(msg.rid)
        if req is None:
            return                        # stale chunk from a past life
        if req.tokens is None:
            req.tokens = [int(t) for t in req.prompt]
            req.admit_time = self.clock()
        toks = msg.tokens or []
        if msg.start >= 0:
            # offset-carrying chunk: dedup against what we already hold.
            # A duplicated frame re-sends tokens we have (skip them); a
            # chunk from the future (gap) means an earlier chunk was
            # lost on a link that will be declared dead — ignore it,
            # Resume or requeue recovers the stream.
            have = len(req.tokens) - len(req.prompt)
            if msg.start > have:
                return
            toks = toks[have - msg.start:]
        if toks:
            if req.first_token_time is None:
                req.first_token_time = self.clock()
            req.tokens.extend(int(t) for t in toks)
        if msg.done:
            req.done = True
            req.finish_reason = msg.finish_reason
            req.truncated = bool(msg.truncated)
            req.finish_time = self.clock()
            del h.replica.in_flight[msg.rid]
            h.replica.completed[msg.rid] = req
            self.completed[msg.rid] = req

    def _detect_failures(self) -> None:
        now = self.clock()
        for h in self.workers.values():
            if not h.alive:
                continue
            if h.endpoint.closed:
                if not h.resumable:
                    # a non-resumable worker's closed endpoint is a
                    # process exit: nothing will ever dial back in
                    self._on_worker_death(h)
                elif h.state == "alive":
                    self._suspect(h, now)
                elif now - h.suspect_since > self.resume_grace:
                    self._on_worker_death(h)
                continue
            if h.last_heartbeat is None:
                continue
            age = now - h.last_heartbeat
            if age > self.heartbeat_timeout:
                self._on_worker_death(h)
            elif age > self.suspect_after:
                if h.state == "alive":
                    self._suspect(h, now)
            elif h.state == "suspect":
                # heartbeats recovered before the grace expired: the
                # pause/partition was transient, resume routing
                h.state = "alive"
                h.suspect_since = None
                self._rebuild_router()

    def _suspect(self, h: WorkerHandle, now: float) -> None:
        h.state = "suspect"
        h.suspect_since = now
        self.suspects.append(h.name)
        self._rebuild_router()            # stop routing NEW work to it

    def _on_worker_death(self, h: WorkerHandle) -> None:
        """Requeue everything the dead worker owed us, then route around
        it. The requeued requests are RESET to their pre-admission state
        (any partially streamed tokens are discarded) — re-serving from
        scratch on a survivor reproduces the same stream because greedy
        decode is placement-independent."""
        h.state = "dead"
        h.suspect_since = None
        self.failures.append(h.name)
        h.endpoint.close()
        for rid in sorted(h.replica.in_flight):
            req = h.replica.in_flight[rid]
            _reset_request(req)
            self.scheduler.requeue(req)
        h.replica.in_flight.clear()
        self._rebuild_router()

    def _on_resume(self, endpoint: tp.Endpoint, msg: tp.Resume, *,
                   driver: Optional[LocalWorkerDriver] = None,
                   process=None) -> Optional[WorkerHandle]:
        """Reconcile a reconnecting worker's progress ledger with ours.

        The worker reports how many tokens it has GENERATED per rid; we
        answer with how many we RECEIVED (it rewinds its stream cursors
        there — lost chunks retransmit, delivered ones never repeat) and
        which rids to cancel (requeued elsewhere, finished, or unknown).
        A suspect worker resumes IN PLACE: in-flight work intact,
        requeued == 0. A worker that comes back after being declared
        dead rejoins empty-handed — its work already requeued."""
        h = self.workers.get(msg.name)
        if h is None:
            return None                   # never knew this name
        was_dead = h.state == "dead"
        progress: Dict[int, int] = {}
        cancel: List[int] = []
        if was_dead:
            # everything it thinks it owns was already requeued or
            # finished elsewhere; it rejoins with a clean slate
            cancel = sorted(int(r) for r in msg.progress)
        else:
            for rid, req in list(h.replica.in_flight.items()):
                if rid not in msg.progress:
                    # the worker lost this request entirely (e.g. it
                    # restarted): re-serve it from scratch elsewhere
                    _reset_request(req)
                    self.scheduler.requeue(req)
                    del h.replica.in_flight[rid]
                    continue
                have = (0 if req.tokens is None
                        else len(req.tokens) - len(req.prompt))
                progress[int(rid)] = int(have)
            for rid in msg.progress:
                if int(rid) not in h.replica.in_flight:
                    cancel.append(int(rid))
        # adopt the fresh endpoint on both views of the worker
        old = h.endpoint
        h.endpoint = endpoint
        h.replica.endpoint = endpoint
        if old is not endpoint:
            old.close()
        if driver is not None:
            h.driver = driver
        if process is not None:
            h.process = process
        h.state = "alive"
        h.suspect_since = None
        h.last_heartbeat = self.clock()
        endpoint.send(tp.ResumeAck(progress=progress,
                                   cancel=sorted(cancel)))
        self.resumed += 1
        self._rebuild_router()
        return h

    def _dispatch(self) -> None:
        if not any(h.alive for h in self.workers.values()):
            if len(self.scheduler) > 0:
                raise FabricError(
                    f"no alive workers and {len(self.scheduler)} "
                    f"requests queued — the fleet cannot make progress")
            return
        # only fully-alive workers take NEW work; suspects hold theirs
        routable = [h.replica for h in self.workers.values()
                    if h.routable]
        if not routable:
            return                        # whole fleet under suspicion
        free = sum(max(0, r.slots - len(r.in_flight)) for r in routable)
        if free <= 0 or len(self.scheduler) == 0:
            return
        for req in self.scheduler.select(free, self.clock()):
            rep = self.router.route(req)
            if len(rep.in_flight) >= rep.slots:
                rep = min(routable,
                          key=lambda r: (len(r.in_flight) / r.slots,
                                         r.name))
            rep.routed += 1
            rep.submit(req)

    # ---------------------------------------------------------- execution

    def has_pending(self) -> bool:
        return (len(self.scheduler) > 0
                or any(h.replica.in_flight
                       for h in self.workers.values() if h.alive))

    def run_until_drained(self, max_ticks: int = 10_000,
                          advance: Optional[Callable[[], None]] = None,
                          idle_sleep: float = 0.002) -> int:
        """Drive the fleet until every submitted request completed.
        ``advance`` runs once per tick — under a :class:`ManualClock`
        pass ``lambda: clock.advance(dt)`` so heartbeat windows and
        throughput EWMAs see time moving.

        A tick that handled zero messages while a subprocess worker
        (no local driver) is in the fleet sleeps ``idle_sleep``
        seconds: remote workers make progress on wall clock, not on
        our tick count, and spinning would burn ``max_ticks`` before
        a freshly-restored engine finishes compiling its first step.
        Purely local fleets never sleep — their ticks ARE the work."""
        ticks = 0
        remote = any(h.driver is None for h in self.workers.values())
        while self.has_pending():
            if advance is not None:
                advance()
            handled = self.tick()
            ticks += 1
            if ticks > max_ticks:
                raise FabricError("fleet did not drain "
                                  f"({max_ticks} ticks)")
            if handled == 0 and remote and idle_sleep:
                time.sleep(idle_sleep)
        return ticks

    def drain(self, deadline: float,
              advance: Optional[Callable[[], None]] = None,
              idle_sleep: float = 0.002) -> bool:
        """Ask every live worker to finish in-flight work and stop
        admitting, then tick until all have answered ``Drained`` or
        ``deadline`` controller-clock seconds elapse. Returns True if
        the whole fleet drained in time; False means the caller should
        escalate to ``shutdown()`` (which force-kills stragglers)."""
        for h in self.workers.values():
            h.drained = False
        limit = self.clock() + deadline
        remote = any(h.driver is None for h in self.workers.values())
        targets: List[WorkerHandle] = []
        asked = False
        while True:
            if not asked and len(self.scheduler) == 0:
                # nothing left to hand out: NOW tell workers to finish
                # what they hold and stop; asking earlier would let an
                # idle worker answer Drained before its share of the
                # queue ever reached it
                for h in self.workers.values():
                    if h.alive and not h.endpoint.closed:
                        try:
                            h.endpoint.send(tp.Drain())
                            targets.append(h)
                        except tp.TransportClosed:
                            pass
                asked = True
            if asked and all(h.drained or not h.alive
                             for h in targets):
                return True
            if self.clock() > limit:
                return False
            if advance is not None:
                advance()
            if self.tick() == 0 and remote and idle_sleep:
                time.sleep(idle_sleep)

    def shutdown(self) -> None:
        for h in self.workers.values():
            if h.alive and not h.endpoint.closed:
                try:
                    h.endpoint.send(tp.Shutdown())
                except tp.TransportClosed:
                    pass
            if h.driver is not None:
                h.driver.tick()           # let it see the Shutdown
            h.endpoint.close()
            if h.process is not None:
                try:
                    h.process.wait(timeout=self.shutdown_timeout)
                except Exception:
                    # a worker that ignores Shutdown past the deadline
                    # is force-killed: drain deadlines stay deadlines
                    h.process.kill()
                    h.process.wait(timeout=5)
        for pe in self._pending:
            pe.endpoint.close()
        self._pending.clear()
        if self.listener is not None:
            self.listener.close()
            self.listener = None

    # ------------------------------------------------------ observability

    def routing_report(self) -> Dict:
        if self.router is None:
            raise FabricError("no alive workers to report on")
        return self.router.routing_report()

    def routing_counters(self) -> Dict[str, int]:
        return {h.name: h.replica.routed for h in self.workers.values()}

    def report(self) -> Dict:
        return {
            "strategy": self.strategy,
            "ticks": self.ticks,
            "failures": list(self.failures),
            "suspects": list(self.suspects),
            "resumed": self.resumed,
            "shed": self.shed,
            "peer_errors": dict(self.peer_errors),
            "requeued": self.scheduler.requeued,
            "completed": len(self.completed),
            "workers": {
                h.name: {
                    "alive": h.alive,
                    "state": h.state,
                    "policy": h.replica.policy_name,
                    **h.replica.metrics(),
                } for h in self.workers.values()
            },
        }


def _reset_request(req: Request) -> None:
    """Back to the pre-admission state ``AdmissionScheduler.requeue``
    expects: only identity (rid/prompt/budget/sampling/priority/tags)
    and ``submit_time`` survive — promotion counts from the original
    submission."""
    req.tokens = None
    req.done = False
    req.error = None
    req.next_input = None
    req.admit_time = None
    req.first_token_time = None
    req.finish_time = None
    req.finish_reason = None
    req.truncated = False
    req.prefill_pos = 0


# ------------------------------------------------------------------ spawn

def spawn_local_worker(controller: Controller, ckpt_dir: str, *,
                       name: str, step: Optional[int] = None,
                       failure_hook: Optional[Callable[[int], None]]
                       = None,
                       config_overrides: Optional[Dict] = None,
                       resumable: bool = False,
                       device=None) -> WorkerHandle:
    """Restore a worker from a serve-ready checkpoint onto ``device``
    (CUDA unless ``device="cpu"``) and attach it in-process: same wire
    codec as a subprocess worker, but ticked by the controller and
    killable via an injected WorkerFailure. With ``resumable=True`` the
    worker survives a severed endpoint and can be re-attached via
    ``reattach_local_worker``."""
    from repro_torch.fabric.checkpoint import build_engine
    from repro_torch.fabric.worker import FabricWorker

    ctrl_ep, worker_ep = tp.local_pair()
    engine = build_engine(ckpt_dir, step, clock=controller.clock,
                          config_overrides=config_overrides, device=device)
    worker = FabricWorker(name, engine, worker_ep,
                          clock=controller.clock,
                          failure_hook=failure_hook,
                          resumable=resumable)
    worker.announce()
    driver = LocalWorkerDriver(worker)
    return controller.add_worker(ctrl_ep, driver=driver, name=name)


def reattach_local_worker(controller: Controller, worker) -> None:
    """Heal a severed in-process worker: make a fresh local pair, have
    the worker open the Resume handshake on it, and park the controller
    side for the tick loop to reconcile. The in-memory analogue of a
    subprocess worker redialing the controller's listener."""
    ctrl_ep, worker_ep = tp.local_pair()
    worker.reconnect(worker_ep)
    driver = LocalWorkerDriver(worker)
    controller.adopt_endpoint(ctrl_ep, driver=driver)


def spawn_subprocess_worker(controller: Controller,
                            ckpt_dir: Optional[str] = None, *,
                            name: str, step: Optional[int] = None,
                            listener: Optional[tp.Listener] = None,
                            resumable: bool = False,
                            register: bool = False,
                            timeout: float = 120.0,
                            device=None) -> WorkerHandle:
    """The real multi-process path: fork ``python -m repro_torch.fabric
    worker`` against the checkpoint, accept its TCP connection, wait
    for its Hello. The child finds this package through its
    ``PYTHONPATH`` (the directory above ``repro_torch`` comes first) and
    runs its engine on ``device`` (its ``--device``; the child's default,
    CUDA, when None).

    ``register=True`` is the fresh-host path: fork WITHOUT ``--ckpt``
    and let the worker take its checkpoint directory from the
    controller's ``RegisterAck`` handoff (requires the controller's
    ``checkpoint_dir``). ``resumable=True`` starts the worker with
    ``--resume`` so a dropped connection redials the listener —
    pass the controller's persistent ``listen()`` socket in that case
    (an ephemeral one closes after the first accept and the redial
    would find nobody home)."""
    import os
    import subprocess
    import sys

    import repro_torch

    if ckpt_dir is None and not register:
        raise ValueError("ckpt_dir is required unless register=True")
    own_listener = listener is None
    if own_listener:
        listener = controller.listener or tp.Listener()
        own_listener = listener is not controller.listener
    cmd = [sys.executable, "-m", "repro_torch.fabric", "worker",
           "--name", name,
           "--connect", f"{listener.host}:{listener.port}"]
    if ckpt_dir is not None:
        cmd += ["--ckpt", ckpt_dir]
    if register:
        cmd += ["--register"]
    if resumable:
        cmd += ["--resume"]
    if step is not None:
        cmd += ["--step", str(step)]
    if device is not None:
        cmd += ["--device", str(device)]
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(cmd, env=env)
    try:
        endpoint = listener.accept(timeout=timeout)
    finally:
        if own_listener:
            listener.close()
    return controller.add_worker(endpoint, process=proc, name=name,
                                 hello_timeout=timeout)
