"""The port's ``runtime.fault_tolerance`` on tensor state, on the CPU.

Mirrors ``tests/test_fault_tolerance.py`` case for case on the port
(exact batch-order replay across restarts, resume from disk, the restart
count in the checkpoint metadata, a failure before the first checkpoint,
the straggler hook and the monitor's warm-up and window), over a tree of
torch tensors saved by the port's ``CheckpointManager``. Then against
the reference: the same hooks give the reference loop's batch order,
state and restart count, and the port's checkpoints restore in
``repro.checkpoint``.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.runtime.fault_tolerance import (FTConfig, FaultTolerantLoop,
                                                 StragglerMonitor,
                                                 WorkerFailure, fail_at_step)


def _loop(tmp_path, calls, failure_hook=None, straggler_hook=None,
          checkpoint_every=4, max_restarts=3):
    def step_fn(state, batch):
        return {"w": state["w"] + batch["tokens"].sum()}, {"loss": 0.0}

    def batch_fn(step):
        calls.append(step)
        return {"tokens": torch.full((2,), step, dtype=torch.int32)}

    return FaultTolerantLoop(
        step_fn, batch_fn, str(tmp_path),
        FTConfig(checkpoint_every=checkpoint_every,
                 max_restarts=max_restarts),
        failure_hook=failure_hook, straggler_hook=straggler_hook)


def _w0():
    return {"w": torch.zeros((), dtype=torch.int64)}


class TestResumeReplay:
    def test_resume_replays_exact_batch_order(self, tmp_path):
        """After a failure the loop restores the last checkpoint and
        re-consumes the data stream from that step."""
        calls = []
        fired = {"done": False}

        def fail_at_6(step):
            if step == 6 and not fired["done"]:
                fired["done"] = True
                raise WorkerFailure("injected")

        loop = _loop(tmp_path, calls, failure_hook=fail_at_6)
        state, step = loop.run(_w0(), 0, 10, device="cpu")
        assert step == 10
        # ran 0..5, failed at 6 (before batch_fn), restored step-4
        # checkpoint, replayed 4 and 5, then continued
        assert calls == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7, 8, 9]
        assert int(state["w"]) == sum(2 * s for s in range(10))
        assert state["w"].dtype == torch.int64

    def test_fresh_loop_resumes_from_disk(self, tmp_path):
        """A NEW loop over the same directory (the restarted-process
        case) resumes at the checkpointed step instead of step 0."""
        calls = []
        loop = _loop(tmp_path, calls)
        loop.run(_w0(), 0, 8, device="cpu")       # checkpoints at 4, 8
        calls2 = []
        loop2 = _loop(tmp_path, calls2)
        state, step = loop2.run(_w0(), 0, 12, device="cpu")
        assert step == 12
        assert calls2 == [8, 9, 10, 11]          # nothing before 8 reran
        assert int(state["w"]) == sum(2 * s for s in range(12))

    def test_restart_count_persisted_in_metadata(self, tmp_path):
        calls = []
        fired = {"n": 0}

        def fail_twice(step):
            if step == 5 and fired["n"] < 2:
                fired["n"] += 1
                raise WorkerFailure("injected")

        loop = _loop(tmp_path, calls, failure_hook=fail_twice)
        state, step = loop.run(_w0(), 0, 8, device="cpu")
        assert step == 8 and loop.restarts == 2
        _, _, meta = CheckpointManager(str(tmp_path)).restore_latest(
            _w0(), device="cpu")
        assert meta["restarts"] == 2

    def test_failure_before_first_checkpoint_replays_from_start(
            self, tmp_path):
        calls = []
        fired = {"done": False}

        def fail_at_2(step):
            if step == 2 and not fired["done"]:
                fired["done"] = True
                raise WorkerFailure("injected")

        loop = _loop(tmp_path, calls, failure_hook=fail_at_2,
                     checkpoint_every=50)
        state, step = loop.run(_w0(), 0, 5, device="cpu")
        assert step == 5
        assert calls == [0, 1, 0, 1, 2, 3, 4]    # full replay from 0
        assert int(state["w"]) == sum(2 * s for s in range(5))

    def test_restarts_past_the_bound_raise(self, tmp_path):
        loop = _loop(tmp_path, [], failure_hook=fail_at_step(3),
                     max_restarts=2)
        with pytest.raises(WorkerFailure, match="injected failure at "
                           "step 3"):
            loop.run(_w0(), 0, 6, device="cpu")
        assert loop.restarts == 3


class TestStraggler:
    def test_hook_fires_on_flagged_step(self, tmp_path, monkeypatch):
        import repro_torch.runtime.fault_tolerance as ft

        flagged = []
        calls = []
        loop = _loop(tmp_path, calls,
                     straggler_hook=lambda s: flagged.append(s))
        # scripted clock: the loop reads monotonic() twice per step
        # (t0, then t0 + duration); step 9 takes 10x the median
        durations = [1.0] * 9 + [10.0] + [1.0] * 4
        seq, t = [], 0.0
        for d in durations:
            seq += [t, t + d]
            t += d + 1.0
        it = iter(seq)

        class _ScriptedTime:
            monotonic = staticmethod(lambda: next(it))

        # swap the module's `time` reference, not the global time module
        monkeypatch.setattr(ft, "time", _ScriptedTime)
        loop.run(_w0(), 0, len(durations), device="cpu")
        assert loop.monitor.flagged == [9]
        assert flagged == [9]

    def test_monitor_warmup_and_window(self):
        mon = StragglerMonitor(FTConfig(deadline_factor=2.0,
                                        straggler_window=8))
        # fewer than 8 observations: never flags, even huge outliers
        for i in range(7):
            assert not mon.observe(i, 100.0 if i == 3 else 1.0)
        for i in range(7, 30):
            mon.observe(i, 1.0)
        # median of the trailing window is 1.0 now: 2.5 flags
        assert mon.observe(30, 2.5)
        assert 30 in mon.flagged


def test_run_raises_without_cuda_unless_asked_for_cpu(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _loop(tmp_path, []).run(_w0(), 0, 2)


# ------------------------------------------------- against the reference

def _schedules():
    """(name, failure steps fired once each, checkpoint_every)."""
    return [("none", (), 4), ("one", (6,), 4), ("twice", (5, 5), 4),
            ("early", (2,), 50), ("many", (1, 3, 7, 9), 3)]


def _hook(steps, exc):
    left = list(steps)

    def hook(step):
        if step in left:
            left.remove(step)
            raise exc("injected")
    return hook


@pytest.mark.parametrize("name,steps,every",
                         _schedules(), ids=[s[0] for s in _schedules()])
def test_same_hooks_replay_as_the_reference(tmp_path, name, steps, every):
    import jax.numpy as jnp

    from repro.checkpoint import CheckpointManager as RefManager
    from repro.runtime import fault_tolerance as ref_ft

    port_calls, ref_calls = [], []
    port = _loop(tmp_path / "port", port_calls,
                 failure_hook=_hook(steps, WorkerFailure),
                 checkpoint_every=every, max_restarts=5)
    state, step = port.run(_w0(), 0, 12, device="cpu")

    def ref_step(state, batch):
        return {"w": state["w"] + batch["tokens"].sum()}, {"loss": 0.0}

    def ref_batch(step):
        ref_calls.append(step)
        return {"tokens": jnp.full((2,), step, jnp.int32)}

    ref = ref_ft.FaultTolerantLoop(
        ref_step, ref_batch, str(tmp_path / "ref"),
        ref_ft.FTConfig(checkpoint_every=every, max_restarts=5),
        failure_hook=_hook(steps, ref_ft.WorkerFailure))
    ref_state, ref_step_n = ref.run({"w": jnp.zeros((), jnp.int32)}, 0, 12)
    assert port_calls == ref_calls
    assert (step, port.restarts) == (ref_step_n, ref.restarts)
    assert int(state["w"]) == int(ref_state["w"])
    assert [h["step"] for h in port.history] == \
        [h["step"] for h in ref.history]
    # the port's last checkpoint reads in the reference, restarts and all
    ck_step, tree, meta = RefManager(str(tmp_path / "port")).restore_latest()
    assert ck_step == 12 and meta == {"restarts": port.restarts}
    assert int(np.asarray(tree["w"])) == int(state["w"])
