"""Admission scheduling: bounded queue, priorities, starvation control.

The scheduler owns the waiting line in front of a ``ServingEngine``'s
decode slots. It is deliberately clock-free — every entry point takes
``now`` from the caller (the engine injects its own clock), so tests can
drive promotion and queue-delay behavior with synthetic timestamps.

Three policies compose in ``select``:

  * **priority** — lower ``Request.priority`` admits first (FIFO within
    a priority class);
  * **max-waiting-time promotion** — a request waiting longer than
    ``max_wait`` seconds jumps every priority class (FIFO among the
    promoted), so low-priority traffic cannot starve;
  * **prefill/decode interleaving** — ``prefill_budget`` caps the prompt
    tokens admitted per wave. A wave that already admitted one request
    defers prompts that exceed the remaining budget to a later tick, so
    a burst of long prompts cannot monopolize the engine while decode
    slots sit idle; the first pick is always admitted (progress
    guarantee) and promoted requests bypass the budget.

With the chunked-prefill continuous engine the budget's role softens:
an admitted long prompt no longer stalls decode (it streams through
fixed-size prefill waves while other slots generate), so the budget now
paces how much *prefill bandwidth per tick* admission can commit rather
than protecting decode from a prefill monopoly. Queue depth also feeds
back into the engine's block-length choice (mid-block admission): a
non-empty waiting line shortens decode blocks so ``select`` runs again
sooner.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.serving.engine import Request


class SchedulerFull(RuntimeError):
    """Raised when the bounded admission queue rejects a submit."""


@dataclasses.dataclass
class AdmissionScheduler:
    max_queue: int = 256           # bounded queue: submits beyond raise
    max_wait: float = 5.0          # seconds before promotion to the front
    prefill_budget: Optional[int] = None   # prompt tokens per admit wave

    def __post_init__(self):
        self._waiting: List[Tuple[int, Request]] = []
        self._seq = 0              # FIFO tiebreaker within a class
        # requeued entries draw seqs from a far-negative counter: all
        # outrank normal submits, FIFO among themselves
        self._front = -(1 << 31)
        self.depth_highwater = 0   # deepest the queue has ever been
        self.requeued = 0          # failure-recovery re-entries

    def __len__(self) -> int:
        return len(self._waiting)

    @property
    def pending(self) -> List[Request]:
        return [r for _, r in self._waiting]

    def pending_new_tokens(self) -> int:
        """Upper bound on decode tokens the waiting line still owes —
        what a backpressure retry-after estimate divides by fleet
        throughput."""
        return sum(r.budget for _, r in self._waiting)

    def submit(self, req: Request, now: Optional[float] = None) -> None:
        if len(self._waiting) >= self.max_queue:
            raise SchedulerFull(
                f"admission queue full ({self.max_queue} waiting)")
        if now is not None and req.submit_time is None:
            req.submit_time = now
        self._waiting.append((self._seq, req))
        self._seq += 1
        if len(self._waiting) > self.depth_highwater:
            self.depth_highwater = len(self._waiting)

    def requeue(self, req: Request) -> None:
        """Failure-recovery re-entry: put back a request that was
        already admitted somewhere that died.

        Differs from ``submit`` in exactly the ways recovery demands:
        the bounded-queue check is bypassed (recovery must never drop
        admitted work — the queue bound protects against NEW load, and
        a requeue adds back work the fleet already accepted), the entry
        goes to the FRONT of its priority class (increasing negative
        seq: FIFO among requeued, ahead of every normal submit), and
        ``submit_time`` is preserved so max-wait promotion counts from
        the original submission.
        """
        self._waiting.append((self._front, req))
        self._front += 1
        self.requeued += 1
        if len(self._waiting) > self.depth_highwater:
            self.depth_highwater = len(self._waiting)

    def _promoted(self, req: Request, now: float) -> bool:
        return (req.submit_time is not None
                and now - req.submit_time >= self.max_wait)

    def select(self, n_slots: int, now: float) -> List[Request]:
        """Pop up to ``n_slots`` requests for this admission wave."""
        if n_slots <= 0 or not self._waiting:
            return []

        def key(item):
            seq, r = item
            return (0 if self._promoted(r, now) else 1, r.priority, seq)

        picked: List[Tuple[int, Request]] = []
        budget = self.prefill_budget
        for item in sorted(self._waiting, key=key):
            if len(picked) >= n_slots:
                break
            _, req = item
            cost = max(len(req.prompt) - 1, 0)
            if (budget is not None and picked and cost > budget
                    and not self._promoted(req, now)):
                continue    # defer the long prompt; decode keeps running
            picked.append(item)
            if budget is not None:
                budget -= cost
        for item in picked:
            self._waiting.remove(item)
        return [r for _, r in picked]
