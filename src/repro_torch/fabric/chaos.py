"""Deterministic fault injection for the serving fabric (the port's copy
of ``repro/fabric/chaos.py``).

:class:`ChaosEndpoint` wraps any :class:`~repro_torch.fabric.transport.
Endpoint` and applies a declarative :class:`FaultSchedule` to its SEND
path. Faults are a pure function of (seed, message index, clock), so a
chaos run under a :class:`~repro_torch.fabric.controller.ManualClock` is
bit-reproducible: the same schedule produces the same delivery trace,
every time. To fault both directions of a link, wrap both sides with
their own schedules.

The fault vocabulary mirrors how real networks actually fail *above*
TCP:

  * **drop / delay / duplicate** apply (by default) only to telemetry
    — ``Heartbeat`` and ``StatsSnapshot`` — because those messages are
    idempotent by design: the fabric's liveness and cost-correction
    state machines tolerate losing or repeating them. Data-plane
    messages ride a reliable stream; TCP does not drop *individual*
    frames — real data loss manifests as a severed connection, which
    is exactly what ``reset_at_msg`` models (and what the
    reconnect-and-resume machinery recovers from with zero token
    loss). ``TokenChunk`` duplication is additionally safe because
    chunks carry a ``start`` offset the controller dedups on, so
    ``duplicate_every`` applies to every type.
  * **partial writes** (``partial_every``) split a frame's bytes across
    two delivery quanta — the second half arrives on a LATER poll —
    exercising :class:`~repro_torch.fabric.transport.FrameDecoder`
    reassembly on the live path, not just in unit tests.
  * **connection reset** (``reset_at_msg``) severs the link after N
    sends, optionally leaking a truncated half-frame first
    (``reset_truncates``) the way a dying TCP peer does.
  * **heartbeat stalls** (``stall_heartbeats_between``) suppress
    ``Heartbeat`` messages inside a clock window — the shape of a GC
    pause or network partition, which must drive the controller's
    suspect -> dead state machine without any process dying.
  * **scheduled worker death** (``kill_at_tick``) is carried here for
    declarative completeness; the harness turns it into a
    ``failure_hook`` via :func:`fail_at` (the same
    :class:`~repro_torch.runtime.fault_tolerance.WorkerFailure` signal the
    training runtime injects).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from repro_torch.fabric import transport as tp

# message types that are safe to silently lose or reorder: the
# receiving state machines treat them as idempotent samples
TELEMETRY_TYPES = ("Heartbeat", "StatsSnapshot")


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Declarative description of what goes wrong on one endpoint's
    send path. All indices count the endpoint's sends (0-based); all
    times are in the injected clock's domain."""
    seed: int = 0
    # telemetry loss: probability of dropping a droppable message
    drop_rate: float = 0.0
    # explicit send indices to drop (droppable types only)
    drop_msgs: Tuple[int, ...] = ()
    # delay: droppable message indices -> seconds of clock delay
    delay_msgs: Tuple[Tuple[int, float], ...] = ()
    # duplicate every Nth send (0 = never); safe for ALL types
    duplicate_every: int = 0
    # split every Nth frame across two delivery quanta (0 = never)
    partial_every: int = 0
    # sever the connection after this many sends (None = never)
    reset_at_msg: Optional[int] = None
    # leak half a frame before the reset (a mid-write peer death)
    reset_truncates: bool = True
    # suppress Heartbeats while t0 <= clock() < t1
    stall_heartbeats_between: Optional[Tuple[float, float]] = None
    # declarative worker death (see fail_at); the endpoint ignores it
    kill_at_tick: Optional[int] = None
    # which message types drop/delay may touch
    droppable: Tuple[str, ...] = TELEMETRY_TYPES

    def __post_init__(self):
        if not (0.0 <= self.drop_rate <= 1.0):
            raise ValueError(f"drop_rate {self.drop_rate} not in [0,1]")
        for knob in ("duplicate_every", "partial_every"):
            if getattr(self, knob) < 0:
                raise ValueError(f"{knob} must be >= 0")


def fail_at(tick: Optional[int]) -> Optional[Callable[[int], None]]:
    """Turn a schedule's ``kill_at_tick`` into the ``failure_hook``
    workers take: raises WorkerFailure at exactly that worker tick —
    the same injectable-death path the training runtime uses."""
    if tick is None:
        return None
    from repro_torch.runtime.fault_tolerance import fail_at_step
    return fail_at_step(tick, reason="chaos: scheduled death")


class ChaosEndpoint(tp.Endpoint):
    """A fault-injecting wrapper over any Endpoint.

    Send-path interception only: ``poll``/``closed`` pass through.
    Deterministic by construction — the RNG is seeded, indices count
    sends, and time comes from the injected clock (pass the fleet's
    ManualClock for bit-reproducible runs).
    """

    def __init__(self, inner: tp.Endpoint, schedule: FaultSchedule,
                 clock: Callable[[], float]):
        self.inner = inner
        self.schedule = schedule
        self.clock = clock
        self._rng = np.random.default_rng(schedule.seed)
        self._sent = 0                 # message send index
        self._frames = 0               # frame emission index
        self._delayed: List[Tuple[float, int, bytes]] = []   # heap
        self._held: List[bytes] = []   # partial-write tails
        self._seq = 0
        self.tripped = False           # reset_at_msg fired
        # delivery trace for determinism assertions:
        # (index, type, action) — 'sent'|'dropped'|'delayed'|
        # 'duplicated'|'partial'|'reset'
        self.log: List[Tuple[int, str, str]] = []

    # ------------------------------------------------------------ faults

    def _droppable(self, tname: str) -> bool:
        return tname in self.schedule.droppable

    def _stalled(self, tname: str) -> bool:
        win = self.schedule.stall_heartbeats_between
        if win is None or tname != "Heartbeat":
            return False
        t = self.clock()
        return win[0] <= t < win[1]

    def _emit(self, data: bytes) -> None:
        """One frame toward the peer, possibly split: the head goes now,
        the tail is held until the NEXT interaction with this endpoint,
        so the receiver's FrameDecoder must reassemble across polls."""
        self._frames += 1
        s = self.schedule
        if self._held:
            # a split frame's tail is in flight: later frames must
            # queue BEHIND it or the byte stream desyncs the decoder
            self._held.append(data)
            return
        if s.partial_every and self._frames % s.partial_every == 0 \
                and len(data) > 4:
            cut = len(data) // 2
            self.inner.send_bytes(data[:cut])
            self._held.append(data[cut:])
            self.log.append((self._sent, "frame", "partial"))
        else:
            self.inner.send_bytes(data)

    def _flush(self) -> None:
        """Release matured delayed messages and held partial tails."""
        if self.inner.closed:
            return
        while self._held:
            self.inner.send_bytes(self._held.pop(0))
        now = self.clock()
        while self._delayed and self._delayed[0][0] <= now:
            _, _, data = heapq.heappop(self._delayed)
            self._emit(data)

    def _reset(self) -> None:
        self.tripped = True
        self.log.append((self._sent, "link", "reset"))
        if self.schedule.reset_truncates and not self.inner.closed:
            # half a frame escapes, then the connection dies: the
            # peer's decoder holds truncated bytes forever
            junk = tp.pack_frame(b"\x00" * 32)[:10]
            try:
                self.inner.send_bytes(junk)
            except tp.TransportClosed:
                pass
        self.inner.close()

    # ---------------------------------------------------------- endpoint

    def send(self, msg: Any) -> None:
        if self.inner.closed and not self.tripped:
            raise tp.TransportClosed("chaos inner endpoint closed")
        self._flush()
        s = self.schedule
        idx = self._sent
        self._sent += 1
        tname = type(msg).__name__
        if s.reset_at_msg is not None and idx >= s.reset_at_msg \
                and not self.tripped:
            self._reset()
            raise tp.TransportClosed(
                f"chaos: connection reset at message {idx}")
        if self.tripped:
            raise tp.TransportClosed("chaos: link was reset")
        if self._stalled(tname):
            self.log.append((idx, tname, "stalled"))
            return
        if self._droppable(tname):
            if idx in s.drop_msgs:
                self.log.append((idx, tname, "dropped"))
                return
            if s.drop_rate and self._rng.random() < s.drop_rate:
                self.log.append((idx, tname, "dropped"))
                return
            delay = dict(s.delay_msgs).get(idx)
            if delay is not None:
                self._seq += 1
                heapq.heappush(
                    self._delayed,
                    (self.clock() + float(delay), self._seq,
                     tp.pack_frame(tp.encode_message(msg))))
                self.log.append((idx, tname, "delayed"))
                return
        data = tp.pack_frame(tp.encode_message(msg))
        self._emit(data)
        self.log.append((idx, tname, "sent"))
        if s.duplicate_every and (idx + 1) % s.duplicate_every == 0:
            self._emit(data)
            self.log.append((idx, tname, "duplicated"))

    def send_bytes(self, data: bytes) -> None:
        self.inner.send_bytes(data)

    def poll(self) -> List[Any]:
        if not self.inner.closed:
            self._flush()
        return self.inner.poll()

    def close(self) -> None:
        self.inner.close()

    @property
    def closed(self) -> bool:
        return self.inner.closed
