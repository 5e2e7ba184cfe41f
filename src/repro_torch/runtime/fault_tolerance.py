"""Fault-tolerant runtime: checkpoint/restart, failure injection,
straggler mitigation (the port's copy of
``repro/runtime/fault_tolerance.py``).

The failure signals are injectable, so every path is testable on one
host:

  * ``FaultTolerantLoop`` — drives (data -> step -> checkpoint) with
    retry-from-checkpoint on WorkerFailure, bounded restarts, and a
    deterministic data stream (resume replays the exact batch order).
    Its state is any tree of tensors, saved and restored by
    :class:`repro_torch.checkpoint.CheckpointManager`.
  * ``StragglerMonitor`` — per-step deadline tracking: steps slower than
    ``deadline_factor`` x the rolling median are flagged; the policy
    hook decides (log | skip-and-redispatch | re-mesh).
  * ``elastic_reshard`` — re-place a tree (a restored checkpoint's
    params and optimizer state) onto another mesh: a run checkpointed on
    one topology resumes on another.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint import CheckpointManager


class WorkerFailure(RuntimeError):
    """Simulated node failure (preemption, interconnect error, kernel
    crash).

    The one injectable death signal shared across the port: the
    training loop's retry-from-checkpoint path catches it, and the
    serving fabric's workers die on it (``repro_torch.fabric`` requeues
    or resumes their work; ``repro_torch.fabric.chaos`` schedules it
    declaratively via ``FaultSchedule.kill_at_tick``)."""


def fail_at_step(step: int,
                 reason: str = "injected failure") -> Callable[[int], None]:
    """The canonical ``failure_hook``: raise :class:`WorkerFailure` at
    exactly ``step``. Used directly by training-loop tests and wrapped
    by the fabric chaos harness (:func:`repro_torch.fabric.chaos.fail_at`)
    so both runtimes inject death through one code path."""
    def hook(t: int) -> None:
        if t == step:
            raise WorkerFailure(f"{reason} at step {step}")
    return hook


@dataclasses.dataclass
class FTConfig:
    checkpoint_every: int = 50
    max_restarts: int = 5
    keep_checkpoints: int = 3
    deadline_factor: float = 3.0     # straggler threshold vs median
    straggler_window: int = 32


class StragglerMonitor:
    def __init__(self, cfg: FTConfig):
        self.cfg = cfg
        self.durations: List[float] = []
        self.flagged: List[int] = []

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        window = self.durations[-self.cfg.straggler_window:]
        self.durations.append(seconds)
        if len(window) < 8:
            return False
        med = float(np.median(window))
        if seconds > self.cfg.deadline_factor * med:
            self.flagged.append(step)
            return True
        return False


class FaultTolerantLoop:
    """Run ``step_fn(state, batch) -> (state, metrics)`` with automatic
    checkpoint/restart.

    ``state`` is any tree of tensors (params, optimizer state, loss
    scale, ...). ``batch_fn`` must be a pure function of the step index
    so that restarts replay identically. ``failure_hook(step)`` may
    raise WorkerFailure to inject faults.
    """

    def __init__(self, step_fn: Callable, batch_fn: Callable,
                 ckpt_dir: str, cfg: FTConfig = FTConfig(),
                 failure_hook: Optional[Callable[[int], None]] = None,
                 straggler_hook: Optional[Callable[[int], None]] = None):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.cfg = cfg
        self.manager = CheckpointManager(ckpt_dir, keep=cfg.keep_checkpoints)
        self.failure_hook = failure_hook
        self.straggler_hook = straggler_hook
        self.monitor = StragglerMonitor(cfg)
        self.restarts = 0
        self.history: List[Dict] = []

    def run(self, state: Any, start_step: int, num_steps: int,
            shardings: Any = None, device=None) -> Any:
        """Returns ``(state, step)``. Checkpoints restore onto ``device``
        (CUDA unless ``device="cpu"``; without CUDA that default
        raises), or with ``shardings`` (a ``NamedSharding`` tree of the
        state) onto their meshes at their placements (a sharded run;
        every rank runs the loop)."""
        from repro_torch.device import resolve_device
        if shardings is None:
            device = resolve_device(device)
        step = start_step
        init_state = state      # step_fn is pure: safe to re-enter from
        # resume if checkpoints exist
        ck_step, ck_state, _ = self.manager.restore_latest(
            state, shardings, missing_ok=True, device=device)
        if ck_step is not None and ck_step >= step:
            state, step = ck_state, ck_step
        end = start_step + num_steps
        while step < end:
            try:
                if self.failure_hook:
                    self.failure_hook(step)
                t0 = time.monotonic()
                batch = self.batch_fn(step)
                state, metrics = self.step_fn(state, batch)
                dt = time.monotonic() - t0
                if self.monitor.observe(step, dt) and self.straggler_hook:
                    self.straggler_hook(step)
                self.history.append({"step": step, **{
                    k: float(v) for k, v in metrics.items()}})
                step += 1
                if step % self.cfg.checkpoint_every == 0 or step == end:
                    self.manager.save(step, state, {"restarts":
                                                    self.restarts})
            except WorkerFailure:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                ck_step, ck_state, _ = self.manager.restore_latest(
                    state, shardings, missing_ok=True, device=device)
                if ck_step is None:
                    # no checkpoint yet: replay from the start — with
                    # the INITIAL state, or the replayed steps would
                    # apply on top of the partial progress
                    state, step = init_state, start_step
                else:
                    state, step = ck_state, ck_step
        return state, step


def elastic_reshard(tree: Any, mesh, spec_tree: Any) -> Any:
    """Each tensor of ``tree`` (plain or a DTensor on another mesh) as a
    DTensor on ``mesh`` at the spec ``spec_tree`` holds at its place
    (spec tuples as ``parallel.sharding``'s rules give them). Every rank
    calls it; a DTensor is gathered whole first (a collective)."""
    from repro_torch.parallel import sharding as shd

    def place(x, spec):
        if shd.has_dtensor(x):
            x = x.full_tensor()
        return shd.place(x, shd.NamedSharding(mesh, spec))

    return shd.zip_map(place, tree, spec_tree)
