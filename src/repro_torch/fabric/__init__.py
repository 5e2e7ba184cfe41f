"""Multi-host serving fabric: checkpoint-restored workers behind a
router-driven controller (the port's copy of ``repro/fabric``, on the
same wire and checkpoint format: either package's controller drives the
other's workers).

The serving stack so far lived in one process: ``Router`` held its
``ServingEngine`` replicas as Python objects. The fabric promotes
replicas to *addressable workers*:

  * ``fabric.checkpoint`` — serve-ready checkpoints: prepared
    (quantized/packed/calibrated) engine state that restores bit-exactly
    with zero re-quantization work;
  * ``fabric.transport`` — typed messages over framed MessagePack
    endpoints, written by the port's own codec (deterministic in-memory
    pair / TCP sockets);
  * ``fabric.worker`` — the engine tick loop behind an endpoint;
  * ``fabric.controller`` — fleet admission + routing + failure
    recovery (suspect -> dead liveness, reconnect-and-resume
    reconciliation, requeue, admission shed, drain deadlines);
  * ``fabric.chaos`` — seeded, clock-driven fault injection
    (:class:`FaultSchedule` + :class:`ChaosEndpoint`): every failure
    mode above is a deterministic, replayable test input.

``python -m repro_torch.fabric smoke`` runs the kill-a-worker-mid-flight CI
contract; ``python -m repro_torch.fabric chaos`` runs the seeded
drops+partition+kill contract (zero loss, resume in place);
``python -m repro_torch.fabric worker`` is the subprocess entry. Each
takes ``--device`` (``cuda`` by default; without CUDA they raise, and
``--device cpu`` runs the plain PyTorch versions).

Multi-host deployment walkthrough
---------------------------------

The controller is the only fixed address; workers dial IN (discovery,
not spawn)::

    # host A — the control plane
    ctrl = Controller(checkpoint_dir="/shared/ckpt",   # handoff source
                      shed_factor=4.0)                 # backpressure
    lst = ctrl.listen("0.0.0.0", 7000)
    ...
    while True:                       # serve loop
        ctrl.tick()                   # accepts + classifies dial-ins

    # host B..N — workers, started any time, in any order
    #   fresh host, no local weights: Register -> RegisterAck hands it
    #   the checkpoint directory, then it announces with Hello
    python -m repro_torch.fabric worker --register --resume \
        --name worker-b --connect hostA:7000
    #   host with a local checkpoint copy:
    python -m repro_torch.fabric worker --ckpt /local/ckpt --resume \
        --name worker-c --connect hostA:7000

``--resume`` makes a dropped connection redial (jittered exponential
backoff, seeded) and reconcile via ``Resume``/``ResumeAck`` — the
engine and its in-flight requests never reset, already-streamed tokens
are never re-sent. Without it a disconnect is a clean exit and the
controller requeues. ``ctrl.drain(deadline)`` bounds shutdown;
``ctrl.shutdown()`` force-kills workers that ignore it.
"""
from repro_torch.fabric.chaos import ChaosEndpoint, FaultSchedule, fail_at
from repro_torch.fabric.checkpoint import (build_engine,
                                           load_engine_checkpoint,
                                           save_engine_checkpoint)
from repro_torch.fabric.controller import (Controller, FabricError,
                                           FleetBusy, LocalWorkerDriver,
                                           ManualClock, RemoteReplica,
                                           WorkerHandle,
                                           reattach_local_worker,
                                           spawn_local_worker,
                                           spawn_subprocess_worker)
from repro_torch.fabric.transport import (Drain, Drained, Endpoint,
                                          FrameDecoder, FrameTooLarge,
                                          Heartbeat, Hello, Listener,
                                          LocalEndpoint, ProtocolError,
                                          Register, RegisterAck, Resume,
                                          ResumeAck, Shutdown,
                                          SocketEndpoint, StatsSnapshot,
                                          SubmitRequest, TokenChunk,
                                          TransportClosed, backoff_delays,
                                          connect, connect_with_retry,
                                          decode_message, encode_message,
                                          local_pair, pack_frame)
from repro_torch.fabric.worker import FabricWorker, worker_main

__all__ = [
    "ChaosEndpoint", "Controller", "Drain", "Drained", "Endpoint",
    "FabricError", "FabricWorker", "FaultSchedule", "FleetBusy",
    "FrameDecoder", "FrameTooLarge", "Heartbeat", "Hello", "Listener",
    "LocalEndpoint", "LocalWorkerDriver", "ManualClock",
    "ProtocolError", "Register", "RegisterAck", "RemoteReplica",
    "Resume", "ResumeAck", "Shutdown", "SocketEndpoint",
    "StatsSnapshot", "SubmitRequest", "TokenChunk", "TransportClosed",
    "WorkerHandle", "backoff_delays", "build_engine", "connect",
    "connect_with_retry", "decode_message", "encode_message",
    "fail_at", "load_engine_checkpoint", "local_pair", "pack_frame",
    "reattach_local_worker", "save_engine_checkpoint",
    "spawn_local_worker", "spawn_subprocess_worker", "worker_main",
]
