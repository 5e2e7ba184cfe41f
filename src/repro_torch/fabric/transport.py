"""Fabric wire protocol: typed messages + framed transports (the port's
copy of ``repro/fabric/transport.py``, on the same wire).

The controller and its workers speak a small, explicit protocol:

  * ``Hello``          worker -> controller, once after restore: replica
                       identity (name, policy, slots, model config);
  * ``SubmitRequest``  controller -> worker: one request placement;
  * ``TokenChunk``     worker -> controller: newly generated tokens of
                       one request (``done`` carries the finish);
  * ``StatsSnapshot``  worker -> controller: the engine's measured
                       :class:`repro_torch.obs.ReplicaStats` feed — what the
                       router's online cost correction blends instead of
                       reading engine objects directly;
  * ``Heartbeat``      worker -> controller: liveness (a missed-
                       heartbeat window is the failure signal);
  * ``Drain``/``Drained``, ``Shutdown`` — lifecycle control.

Reconnect-and-resume extends the protocol with three messages:

  * ``Register``       worker -> controller, before it has an engine:
                       dial-in registration (the controller's
                       ``RegisterAck`` hands back the checkpoint
                       directory a fresh host should restore from);
  * ``Resume``         worker -> controller, after a severed
                       connection: per-rid emitted-token counts for
                       every request the worker still holds;
  * ``ResumeAck``      controller -> worker: per-rid *received* counts
                       (the worker rewinds its stream cursor to them,
                       retransmitting anything lost in flight) plus the
                       rids the controller already rerouted (cancel).

``TokenChunk.start`` carries the generation offset of the chunk's
first token so the controller can trim duplicates and ignore stale
retransmissions — token streams stay exact under duplicated or
re-sent frames.

Every message crosses an :class:`Endpoint` as a length-prefixed
MessagePack frame — including the in-memory pair used by tests and the
single-host controller, so the wire codec is exercised on every path,
not just the multi-process one. The port's own codec
(``repro_torch.checkpoint._msgpack``) writes the bytes the reference's
``msgpack.packb`` writes, so either package's controller drives the
other's workers. ``local_pair()`` gives two connected in-memory
endpoints (deterministic, single-threaded); :class:`SocketEndpoint`
wraps a non-blocking TCP socket for real multi-process runs
(``python -m repro_torch.fabric worker`` connects one back to the
controller's listener).

Hostile input is a typed failure, never a hang: a corrupt MessagePack
payload, an unregistered message type, a field mismatch, or an
oversized frame all raise :class:`ProtocolError` (a ``ValueError``) at
the decode boundary, so a peer feeding garbage can be contained by
closing its endpoint.
"""
from __future__ import annotations

import collections
import dataclasses
import socket
import struct
from typing import Any, Deque, Dict, List, Optional, Type

from repro_torch.checkpoint import _msgpack

# ----------------------------------------------------------------- errors

class ProtocolError(ValueError):
    """A peer sent bytes that are not a valid fabric message: corrupt
    MessagePack, an unknown message type, mismatched fields, or an
    oversized frame. Typed so the receiving loop can contain the bad
    peer (close its endpoint) instead of crashing or hanging."""


class FrameTooLarge(ProtocolError):
    """A frame header announced a payload beyond ``MAX_FRAME``."""


# --------------------------------------------------------------- messages

_MESSAGE_TYPES: Dict[str, Type] = {}


def message(cls):
    """Register a dataclass as a wire message (its class name is the
    type tag)."""
    _MESSAGE_TYPES[cls.__name__] = cls
    return cls


@message
@dataclasses.dataclass(frozen=True)
class Hello:
    name: str
    policy: str
    slots: int
    model_config: Optional[Dict] = None
    cost_correction: str = "static"
    # a resumable worker keeps its engine (and every in-flight
    # request's state) across a severed connection and will dial back
    # in with a Resume — the controller holds its work through a grace
    # window instead of requeueing on endpoint death
    resumable: bool = False


@message
@dataclasses.dataclass(frozen=True)
class Register:
    """Dial-in registration from a worker that may not have an engine
    yet. ``need_checkpoint`` asks the controller to answer with a
    ``RegisterAck`` naming the checkpoint directory to restore from
    (the fresh-host handoff); the worker follows up with a normal
    ``Hello`` once its engine is serve-ready."""
    name: str
    need_checkpoint: bool = False


@message
@dataclasses.dataclass(frozen=True)
class RegisterAck:
    ckpt_dir: str
    step: Optional[int] = None


@message
@dataclasses.dataclass(frozen=True)
class Resume:
    """A reconnecting worker's ledger: for every request it still
    holds, how many generation tokens its engine has emitted so far
    (streamed or not — the controller answers with what it actually
    received)."""
    name: str
    progress: Dict[int, int] = dataclasses.field(default_factory=dict)


@message
@dataclasses.dataclass(frozen=True)
class ResumeAck:
    """Controller -> worker reconciliation: ``progress`` maps each
    still-wanted rid to the generation-token count the controller has
    received (the worker rewinds its stream cursor there and
    retransmits the rest); ``cancel`` lists rids the controller no
    longer wants from this worker (requeued elsewhere or finished)."""
    progress: Dict[int, int] = dataclasses.field(default_factory=dict)
    cancel: List[int] = dataclasses.field(default_factory=list)


@message
@dataclasses.dataclass(frozen=True)
class SubmitRequest:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    priority: int = 0
    tags: List[str] = dataclasses.field(default_factory=list)
    # SamplingParams fields (flat: the wire format has no nested types)
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    stop_ids: List[int] = dataclasses.field(default_factory=list)
    seed: Optional[int] = None


@message
@dataclasses.dataclass(frozen=True)
class TokenChunk:
    rid: int
    tokens: List[int]                  # delta since the last chunk
    done: bool = False
    finish_reason: Optional[str] = None
    truncated: bool = False
    # generation offset of tokens[0] (0 = the first generated token).
    # Lets the receiver trim duplicated/retransmitted chunks exactly;
    # -1 means "unknown" (pre-resume senders) and is appended blindly.
    start: int = -1


@message
@dataclasses.dataclass(frozen=True)
class StatsSnapshot:
    name: str
    stats: Dict                        # ReplicaStats.snapshot()
    slots: int = 0
    completed: int = 0


@message
@dataclasses.dataclass(frozen=True)
class Heartbeat:
    tick: int
    time: float


@message
@dataclasses.dataclass(frozen=True)
class Drain:
    """Finish everything in flight, answer ``Drained``, keep serving."""


@message
@dataclasses.dataclass(frozen=True)
class Drained:
    completed: int = 0


@message
@dataclasses.dataclass(frozen=True)
class Shutdown:
    """Stop the worker loop after the current tick."""


def encode_message(msg: Any) -> bytes:
    name = type(msg).__name__
    if name not in _MESSAGE_TYPES:
        raise TypeError(f"{name} is not a registered fabric message")
    return _msgpack.packb({"t": name, "f": dataclasses.asdict(msg)})


def decode_message(data: bytes) -> Any:
    try:
        # int map keys are legal on this wire (Resume/ResumeAck carry
        # rid -> count ledgers), so strict_map_key must be off
        obj = _msgpack.unpackb(data, strict_map_key=False)
    except ValueError as e:              # the codec's every malformed input
        raise ProtocolError(f"malformed fabric frame: {e}") from e
    if not isinstance(obj, dict) or "t" not in obj or "f" not in obj:
        raise ProtocolError(
            f"fabric frame is not a typed message envelope: "
            f"{type(obj).__name__}")
    cls = _MESSAGE_TYPES.get(obj.get("t"))
    if cls is None:
        raise ProtocolError(
            f"unknown fabric message type {obj.get('t')!r}")
    fields = obj["f"]
    if not isinstance(fields, dict):
        raise ProtocolError(
            f"{obj['t']} fields are {type(fields).__name__}, not a map")
    try:
        return cls(**fields)
    except TypeError as e:
        raise ProtocolError(f"bad {obj['t']} fields: {e}") from e


# ---------------------------------------------------------------- framing

_LEN = struct.Struct(">I")
MAX_FRAME = 64 * 1024 * 1024


def pack_frame(payload: bytes) -> bytes:
    if len(payload) > MAX_FRAME:
        raise FrameTooLarge(f"frame of {len(payload)} bytes exceeds "
                            f"MAX_FRAME ({MAX_FRAME})")
    return _LEN.pack(len(payload)) + payload


class FrameDecoder:
    """Incremental length-prefixed frame reassembly (feed arbitrary
    byte chunks, iterate complete frames)."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[bytes]:
        self._buf.extend(data)
        frames = []
        while len(self._buf) >= _LEN.size:
            (n,) = _LEN.unpack_from(self._buf)
            if n > MAX_FRAME:
                raise FrameTooLarge(
                    f"incoming frame of {n} bytes exceeds "
                    f"MAX_FRAME ({MAX_FRAME})")
            if len(self._buf) < _LEN.size + n:
                break
            frames.append(bytes(self._buf[_LEN.size:_LEN.size + n]))
            del self._buf[:_LEN.size + n]
        return frames

    @property
    def pending_bytes(self) -> int:
        """Bytes buffered toward an incomplete frame (a non-zero value
        at connection close means the stream was truncated mid-frame)."""
        return len(self._buf)


# ------------------------------------------------------------- endpoints

class TransportClosed(RuntimeError):
    """Send on a closed endpoint (the peer is gone)."""


class Endpoint:
    """One side of a bidirectional message channel."""

    def send(self, msg: Any) -> None:
        raise NotImplementedError

    def send_bytes(self, data: bytes) -> None:
        """Ship raw bytes (need not align to frame boundaries). The
        chaos layer uses this to model partial writes and corrupt
        frames; everything else should use ``send``."""
        raise NotImplementedError

    def poll(self) -> List[Any]:
        """Drain every message currently available (non-blocking)."""
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    @property
    def closed(self) -> bool:
        raise NotImplementedError


class LocalEndpoint(Endpoint):
    """In-memory endpoint: deterministic, single-threaded, but every
    message still round-trips through the framed wire encoding so the
    in-process fabric exercises the same codec as the socket one."""

    def __init__(self, inbox: Deque[bytes], outbox: Deque[bytes],
                 state: Dict):
        self._in = inbox
        self._out = outbox
        self._state = state           # shared {'closed': bool}
        self._decoder = FrameDecoder()

    def send(self, msg: Any) -> None:
        if self._state["closed"]:
            raise TransportClosed("endpoint is closed")
        self._out.append(pack_frame(encode_message(msg)))

    def send_bytes(self, data: bytes) -> None:
        if self._state["closed"]:
            raise TransportClosed("endpoint is closed")
        self._out.append(bytes(data))

    def poll(self) -> List[Any]:
        out: List[Any] = []
        while self._in:
            for frame in self._decoder.feed(self._in.popleft()):
                out.append(decode_message(frame))
        return out

    def close(self) -> None:
        self._state["closed"] = True

    @property
    def closed(self) -> bool:
        return self._state["closed"]


def local_pair() -> tuple:
    """Two connected in-memory endpoints (controller side, worker side).
    Closing either side closes both — the fabric's stand-in for a dead
    TCP connection."""
    a_to_b: Deque[bytes] = collections.deque()
    b_to_a: Deque[bytes] = collections.deque()
    state = {"closed": False}
    return (LocalEndpoint(b_to_a, a_to_b, state),
            LocalEndpoint(a_to_b, b_to_a, state))


class SocketEndpoint(Endpoint):
    """Framed messages over a non-blocking TCP socket (the real
    multi-process transport)."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._sock.setblocking(False)
        self._decoder = FrameDecoder()
        self._closed = False

    def send(self, msg: Any) -> None:
        self.send_bytes(pack_frame(encode_message(msg)))

    def send_bytes(self, data: bytes) -> None:
        if self._closed:
            raise TransportClosed("socket endpoint is closed")
        try:
            self._sock.setblocking(True)
            self._sock.sendall(data)
        except OSError as e:
            self.close()
            raise TransportClosed(f"peer went away during send: {e}")
        finally:
            if not self._closed:
                self._sock.setblocking(False)

    def poll(self) -> List[Any]:
        out: List[Any] = []
        if self._closed:
            return out
        while True:
            try:
                chunk = self._sock.recv(1 << 16)
            except BlockingIOError:
                break
            except OSError:
                self.close()
                break
            if not chunk:              # orderly EOF: peer closed
                self.close()
                break
            for frame in self._decoder.feed(chunk):
                out.append(decode_message(frame))
        return out

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._sock.close()
            except OSError:
                pass

    @property
    def closed(self) -> bool:
        return self._closed


def connect(host: str, port: int, timeout: float = 30.0) -> SocketEndpoint:
    """Dial the controller's listener (worker side)."""
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.settimeout(None)
    return SocketEndpoint(sock)


def backoff_delays(attempts: int, *, base: float = 0.1,
                   factor: float = 2.0, max_delay: float = 5.0,
                   jitter: float = 0.5, seed: int = 0) -> List[float]:
    """The jittered-exponential-backoff schedule ``connect_with_retry``
    sleeps through, as a pure function of the seed — so a fleet of
    workers retrying a restarted controller neither thunders in
    lock-step nor behaves differently run to run."""
    import random
    rng = random.Random(seed)
    out = []
    for k in range(max(attempts, 0)):
        d = min(base * (factor ** k), max_delay)
        out.append(d * (1.0 - jitter * rng.random()))
    return out


def connect_with_retry(host: str, port: int, *, attempts: int = 8,
                       base: float = 0.1, factor: float = 2.0,
                       max_delay: float = 5.0, jitter: float = 0.5,
                       seed: int = 0, timeout: float = 30.0,
                       sleep=None) -> SocketEndpoint:
    """Dial-in with jittered exponential backoff: the deployment-path
    worker keeps trying until the controller's listener answers.
    ``sleep`` is injectable for deterministic tests."""
    import time as _time
    sleep = _time.sleep if sleep is None else sleep
    delays = backoff_delays(attempts, base=base, factor=factor,
                            max_delay=max_delay, jitter=jitter,
                            seed=seed)
    last: Optional[Exception] = None
    for i in range(max(attempts, 1)):
        try:
            return connect(host, port, timeout=timeout)
        except OSError as e:
            last = e
            if i < len(delays):
                sleep(delays[i])
    raise TransportClosed(
        f"could not reach controller at {host}:{port} after "
        f"{attempts} attempts: {last}")


class Listener:
    """Controller-side accept socket: bind an ephemeral port, hand out
    one :class:`SocketEndpoint` per connecting worker."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen()
        self.host, self.port = self._sock.getsockname()[:2]

    def accept(self, timeout: float = 30.0) -> SocketEndpoint:
        self._sock.settimeout(timeout)
        conn, _ = self._sock.accept()
        return SocketEndpoint(conn)

    def poll_accept(self) -> Optional[SocketEndpoint]:
        """Non-blocking accept: one pending connection or ``None``.
        The controller's tick loop calls this every quantum — dial-in
        workers attach whenever they arrive, no dedicated accept
        thread."""
        self._sock.settimeout(0.0)
        try:
            conn, _ = self._sock.accept()
        except (BlockingIOError, socket.timeout):
            return None
        except OSError:
            return None
        return SocketEndpoint(conn)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
