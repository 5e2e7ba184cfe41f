"""Per-replica measured serving statistics.

:class:`ReplicaStats` follows an engine's tick loop: every tick the
engine feeds ``on_tick(now, new_tokens, queue_depth)`` and every first
token feeds ``observe_ttft``; ``snapshot()`` reads the EWMA throughput,
current queue depth and sliding-window p95 TTFT (the reference's router
blends them into its cost model; the port's router waits for a later
slice).

EWMA over per-tick instantaneous rates (``new_tokens / dt``) rather
than a cumulative average: the router must react to a replica that
*became* slow (noisy neighbor, thermal, bigger requests), and a
cumulative mean would take the whole history to move. All timestamps
come from the caller's clock (the engine's injected one), so tests
drive the statistics with synthetic time.
"""
from __future__ import annotations

import collections
from typing import Deque, Dict, Optional

import numpy as np


class ReplicaStats:
    """EWMA tok/s + queue depth + sliding-window TTFT percentiles.

    ``alpha`` is the EWMA weight of the newest per-tick rate sample;
    ``window`` bounds the TTFT reservoir (p95 over the last ``window``
    first tokens). Idle ticks (zero active slots and zero new tokens)
    are excluded from the throughput EWMA — an engine waiting for
    traffic is not a slow engine.
    """

    __slots__ = ("alpha", "window", "tok_per_s", "queue_depth",
                 "active_slots", "ticks", "transported", "_last_time",
                 "_ttfts", "_p95_override", "_ttft_count_override")

    def __init__(self, alpha: float = 0.2, window: int = 64):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.window = window
        self.tok_per_s: Optional[float] = None    # None until measured
        self.queue_depth: int = 0
        self.active_slots: int = 0
        self.ticks: int = 0
        # True once ingest() ran: this instance mirrors a REMOTE
        # engine's stats transported over the fabric rather than
        # observing a local tick loop
        self.transported: bool = False
        self._last_time: Optional[float] = None
        self._ttfts: Deque[float] = collections.deque(maxlen=window)
        self._p95_override: Optional[float] = None
        self._ttft_count_override: int = 0

    def on_tick(self, now: float, new_tokens: int, queue_depth: int,
                active_slots: int = 0):
        """One engine tick: ``new_tokens`` generated since the last
        call, current queue depth and busy slots."""
        self.ticks += 1
        self.queue_depth = int(queue_depth)
        self.active_slots = int(active_slots)
        last, self._last_time = self._last_time, now
        if last is None:
            return
        dt = now - last
        if dt <= 0:
            return                      # synthetic clocks may not advance
        if new_tokens == 0 and active_slots == 0:
            return                      # idle tick: no throughput signal
        rate = new_tokens / dt
        if self.tok_per_s is None:
            self.tok_per_s = rate
        else:
            self.tok_per_s = (self.alpha * rate
                              + (1.0 - self.alpha) * self.tok_per_s)

    def observe_ttft(self, ttft_s: float):
        self._ttfts.append(float(ttft_s))

    def ingest(self, snapshot: Dict):
        """Overwrite the measured state from a transported ``snapshot()``
        dict — the fabric controller's view of a remote engine's stats.

        The remote reservoir of raw TTFT samples never crosses the wire,
        only its p95; ``p95_ttft_s`` reports the transported value until
        a fresher snapshot lands. The blend inputs the router reads
        (``tok_per_s``, ``measured``, queue depth, active slots) carry
        over directly, so a Router over transported stats ranks exactly
        like one holding the engines in-process.
        """
        self.tok_per_s = snapshot.get("tok_per_s")
        self.queue_depth = int(snapshot.get("queue_depth") or 0)
        self.active_slots = int(snapshot.get("active_slots") or 0)
        self.ticks = int(snapshot.get("ticks") or 0)
        self._p95_override = snapshot.get("p95_ttft_s")
        self._ttft_count_override = int(snapshot.get("ttft_samples") or 0)
        self.transported = True

    @property
    def p95_ttft_s(self) -> Optional[float]:
        if self.transported:
            return self._p95_override
        if not self._ttfts:
            return None
        return float(np.percentile(np.asarray(self._ttfts), 95))

    @property
    def measured(self) -> bool:
        """Has at least one throughput sample landed?"""
        return self.tok_per_s is not None

    def snapshot(self) -> Dict:
        return {
            "tok_per_s": self.tok_per_s,
            "queue_depth": self.queue_depth,
            "active_slots": self.active_slots,
            "p95_ttft_s": self.p95_ttft_s,
            "ttft_samples": (self._ttft_count_override if self.transported
                            else len(self._ttfts)),
            "ticks": self.ticks,
            "transported": self.transported,
        }

    def __repr__(self):
        tps = "unmeasured" if self.tok_per_s is None \
            else f"{self.tok_per_s:.1f} tok/s"
        return (f"ReplicaStats({tps}, queue={self.queue_depth}, "
                f"ticks={self.ticks})")
