"""Explicit-clock span tracing exported as Chrome trace-event JSON.

A :class:`Tracer` records three kinds of timeline rows, all stamped
from an injected clock (the engine passes its own ``clock`` so tests
drive spans with synthetic timestamps and get byte-identical traces):

* **complete spans** (``ph="X"``) — the per-tick engine phases
  (admission, prefill dispatch, block dispatch, host sync, harvest)
  and ``compile:*`` spans from :func:`traced_call`;
* **begin/end pairs** (``ph="B"``/``"E"``) — long-lived request
  lifecycle stages (queued → prefill → decode) that span many ticks,
  one lane (``tid``) per request so pairs never interleave;
* **instants** (``ph="i"``) — point events (first token, finish,
  first-call markers).

``dump()`` writes ``{"traceEvents": [...]}`` with timestamps in
microseconds — the Chrome trace-event format Perfetto
(https://ui.perfetto.dev) and ``chrome://tracing`` load directly;
the reference's ``tools/trace_report.py`` renders the same file as a
terminal summary.

A disabled tracer (``enabled=False``) is free: ``span()`` hands back a
shared no-op context manager and every record method returns before
touching the clock, so the engine can construct one unconditionally.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional

# lane (tid) layout inside the single engine process (pid): the tick
# phases share lane 0, request lifecycles get REQUEST_LANE_BASE + rid
TICK_LANE = 0
REQUEST_LANE_BASE = 1000
# the trace-event phases a valid trace may hold
_EVENT_PHASES = ("X", "B", "E", "i", "M", "C")

class _NullSpan:
    """Shared no-op context manager returned by a disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Open complete-span: records an ``X`` event on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_tid", "_args", "_t0")

    def __init__(self, tracer, name, cat, tid, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._tid = tid
        self._args = args
        self._t0 = None

    def __enter__(self):
        self._t0 = self._tracer.clock()
        return self

    def __exit__(self, *exc):
        self._tracer.complete(self._name, self._t0, self._tracer.clock(),
                              cat=self._cat, tid=self._tid,
                              args=self._args)
        return False


class Tracer:
    """Span recorder with an injectable clock and a bounded buffer.

    ``max_events`` caps the in-memory buffer (a long-running engine
    must not grow without bound); events past the cap are counted in
    ``dropped`` and surfaced as an instant in the exported trace.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 enabled: bool = True, pid: int = 1,
                 process: str = "engine", max_events: int = 200_000):
        self.clock = clock
        self.enabled = enabled
        self.pid = pid
        self.events: List[Dict] = []
        self.dropped = 0
        self._max_events = max_events
        self._lane_names: Dict[int, str] = {}
        if enabled:
            self._meta("process_name", TICK_LANE, {"name": process})
            self.name_lane(TICK_LANE, "tick phases")

    # ------------------------------------------------------------ recording

    def _push(self, ev: Dict):
        if len(self.events) >= self._max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def _meta(self, name: str, tid: int, args: Dict):
        self._push({"name": name, "ph": "M", "ts": 0, "pid": self.pid,
                    "tid": tid, "args": args})

    def name_lane(self, tid: int, name: str):
        """Label a lane (Chrome thread_name metadata), once per tid."""
        if not self.enabled or tid in self._lane_names:
            return
        self._lane_names[tid] = name
        self._meta("thread_name", tid, {"name": name})

    def span(self, name: str, cat: str = "engine", tid: int = TICK_LANE,
             args: Optional[Dict] = None):
        """Context manager recording one complete (``X``) span."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, tid, args)

    def complete(self, name: str, t0: float, t1: float,
                 cat: str = "engine", tid: int = TICK_LANE,
                 args: Optional[Dict] = None):
        """Record a finished span from explicit begin/end timestamps."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "X", "ts": t0 * 1e6,
              "dur": max(t1 - t0, 0.0) * 1e6, "pid": self.pid, "tid": tid}
        if args:
            ev["args"] = args
        self._push(ev)

    def begin(self, name: str, tid: int, cat: str = "request",
              args: Optional[Dict] = None):
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "B",
              "ts": self.clock() * 1e6, "pid": self.pid, "tid": tid}
        if args:
            ev["args"] = args
        self._push(ev)

    def end(self, name: str, tid: int, cat: str = "request"):
        if not self.enabled:
            return
        self._push({"name": name, "cat": cat, "ph": "E",
                    "ts": self.clock() * 1e6, "pid": self.pid,
                    "tid": tid})

    def instant(self, name: str, cat: str = "engine",
                tid: int = TICK_LANE, args: Optional[Dict] = None):
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": self.clock() * 1e6, "pid": self.pid, "tid": tid}
        if args:
            ev["args"] = args
        self._push(ev)

    # ----------------------------------------------- request lifecycle sugar

    def request_lane(self, rid: int) -> int:
        tid = REQUEST_LANE_BASE + (rid if rid >= 0 else
                                   REQUEST_LANE_BASE - rid)
        self.name_lane(tid, f"req {rid}")
        return tid

    def req_begin(self, rid: int, stage: str,
                  args: Optional[Dict] = None):
        if not self.enabled:
            return
        self.begin(stage, self.request_lane(rid), args=args)

    def req_end(self, rid: int, stage: str):
        if not self.enabled:
            return
        self.end(stage, self.request_lane(rid))

    def req_instant(self, rid: int, name: str,
                    args: Optional[Dict] = None):
        if not self.enabled:
            return
        self.instant(name, cat="request", tid=self.request_lane(rid),
                     args=args)

    # -------------------------------------------------------------- export

    def to_chrome(self) -> Dict:
        """The Chrome trace-event JSON object (``dump()`` serializes
        exactly this)."""
        events = list(self.events)
        if self.dropped:
            events.append({"name": f"tracer dropped {self.dropped} events",
                           "cat": "tracer", "ph": "i", "s": "g", "ts": 0,
                           "pid": self.pid, "tid": TICK_LANE})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, default=float)
        return path


def traced_call(fn: Callable, name: str,
                tracer: Optional[Tracer]) -> Callable:
    """Wrap a program so its compilations surface as ``compile:<name>``
    spans — the port's counterpart of the reference's ``traced_jit``.

    When ``fn`` exposes ``_cache_size`` (the engine's program cache,
    ``serving.graphs``: one CUDA graph per input signature), every call
    whose cache grew is spanned: the eager warm-up and the capture of a
    new signature (on the CPU, the first eager call of a signature).
    Otherwise the first call is. The span times the call on the host
    clock. With tracing disabled the raw callable is returned: zero
    per-call overhead. The wrapper keeps ``fn`` as ``__wrapped__``.
    """
    if tracer is None or not tracer.enabled:
        return fn
    cache_size = getattr(fn, "_cache_size", None)
    state = {"called": False}

    def wrapped(*args, **kwargs):
        before = cache_size() if cache_size is not None else None
        t0 = tracer.clock()
        out = fn(*args, **kwargs)
        compiled = (cache_size() > before if cache_size is not None
                    else not state["called"])
        state["called"] = True
        if compiled:
            tracer.complete(f"compile:{name}", t0, tracer.clock(),
                            cat="compile")
        return out

    wrapped.__wrapped__ = fn
    return wrapped


def validate_chrome_trace(data) -> List[str]:
    """Schema-check a Chrome trace-event object: a list of error strings,
    empty when valid. Takes the ``{"traceEvents": [...]}`` object or a
    bare event list; stops after about 20 errors."""
    errors: List[str] = []
    if isinstance(data, dict):
        events = data.get("traceEvents")
        if not isinstance(events, list):
            return ["top-level object lacks a 'traceEvents' list"]
    elif isinstance(data, list):
        events = data
    else:
        return [f"trace must be an object or list, got {type(data).__name__}"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                errors.append(f"event {i}: missing {key!r}")
        ph = ev.get("ph")
        if ph not in _EVENT_PHASES:
            errors.append(f"event {i}: unknown phase {ph!r}")
        if ph == "X" and not (isinstance(ev.get("dur"), (int, float))
                              and ev["dur"] >= 0):
            errors.append(f"event {i}: X event needs dur >= 0")
        if not isinstance(ev.get("ts"), (int, float)):
            errors.append(f"event {i}: ts must be a number")
        if len(errors) > 20:
            errors.append("... (truncated)")
            break
    return errors
