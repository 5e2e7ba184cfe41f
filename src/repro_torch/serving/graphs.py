"""The engine's program cache: one compiled program per input signature
(the port's counterpart of the reference's ``jax.jit``).

A :class:`Program` wraps ``fn(*static, *dynamic)``:

* **static** arguments (the params tree and the caches dict) are bound
  by identity. The first call of a signature records each tensor leaf's
  ``data_ptr()``, strides, shape, dtype and device; every later call
  checks them and raises on a change. A captured graph reads its static
  tensors by address, so a swapped tensor is refused, never recaptured.
* **dynamic** arguments (tokens, positions, offsets, lengths, the
  ``DecodeCarry``: host arrays or tensors) key the cache by their tree
  paths, shapes and dtypes; a non-tensor leaf (a static Python argument)
  keys it by value. On a CUDA device each signature owns static input
  buffers, and a call copies its dynamic arguments into them.

On a CUDA device the first call of a signature runs ``fn`` eagerly on a
side stream (as ``torch.cuda.graph`` asks of a warm-up: it builds the
kernels, fills the wrappers' plan caches and sets their shared-memory
attributes), and its results are the call's results. Then the same call
is captured into a ``torch.cuda.CUDAGraph``; a capture runs nothing on
the device. Later calls replay the graph and return its static outputs,
which the next replay overwrites. Every graph of one engine shares one
memory pool, and each keeps its own static inputs and outputs alive. A
capture or replay that fails raises: nothing carries on eagerly.
Python's garbage collector is held off during a capture: a collection
there could destroy an unreachable engine's graph, and the memory that
frees would invalidate the capture.

The capture moves the kernel wrappers' launch counts
(``kernels.ops.launch_counts``) but launches nothing, so the program
takes that delta back and adds it again on every replay: the counts then
read what the same requests launch eagerly.

On the CPU a call is the eager call, its host arrays copied into fresh
tensors; signatures and static bindings are kept all the same, so the
rules above hold on both devices.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops

Path = Tuple[Any, ...]


def tree_map(fn: Callable[[Path, Any], Any], tree, path: Path = ()):
    """Rebuild ``tree`` (dicts, lists, tuples, NamedTuples, dataclass
    instances) with ``fn(path, leaf)`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), path + (f.name,))
            for f in dataclasses.fields(tree) if f.init})
    return fn(path, tree)


def leaves(tree) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs of ``tree`` in :func:`tree_map`'s order."""
    out: List[Tuple[Path, Any]] = []
    tree_map(lambda p, x: out.append((p, x)), tree)
    return out


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _torch_dtype(x) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.from_numpy(np.empty(0, x.dtype)).dtype


def signature(dynamic) -> tuple:
    """The cache key of a call's dynamic arguments: per leaf its path and,
    for a tensor or host array, its shape and torch dtype (a host array
    and a tensor of the same shape and dtype share a key), else its value
    (which must be hashable)."""
    return tuple((p, "array", tuple(x.shape), _torch_dtype(x))
                 if _is_array(x) else (p, "value", x)
                 for p, x in leaves(dynamic))


def _identity(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", x.data_ptr(), tuple(x.shape), x.stride(), x.dtype,
                str(x.device))
    return ("value", x)


class StaticBinding:
    """What a program bound of its static arguments at a signature's first
    call: per leaf its path and a tensor's address, strides, shape, dtype
    and device (a non-tensor leaf's value)."""

    def __init__(self, static):
        self.record = [(p, _identity(x)) for p, x in leaves(static)]

    def check(self, static, name: str) -> None:
        """Raise when ``static`` is not the tree bound at capture."""
        now = [(p, _identity(x)) for p, x in leaves(static)]
        if now == self.record:
            return
        for (p0, was), (p1, got) in zip(self.record, now):
            if p0 != p1 or was != got:
                raise RuntimeError(
                    f"{name}: static argument {'/'.join(map(str, p1))} is "
                    f"not the one its graph was captured with ({was} -> "
                    f"{got}); a captured graph reads its static tensors "
                    f"by address")
        raise RuntimeError(f"{name}: the static arguments' tree changed "
                           f"since capture ({len(self.record)} leaves -> "
                           f"{len(now)})")


def count_delta(before: Dict[str, int], after: Dict[str, int]
                ) -> Dict[str, int]:
    """The launch counts that moved from ``before`` to ``after`` (kernel
    name -> launches; unmoved names left out)."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def same_bits(a, b) -> bool:
    """True when two leaves are equal bit for bit (tensors: shape, dtype
    and every byte; anything else by ``==``)."""
    if not isinstance(a, torch.Tensor) or not isinstance(b, torch.Tensor):
        return a == b
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.detach().reshape(-1).contiguous().view(torch.uint8),
                       b.detach().reshape(-1).contiguous()
                       .to(a.device).view(torch.uint8))


def clone_tree(tree):
    """A copy of ``tree`` with every tensor leaf cloned."""
    return tree_map(lambda p, x: x.clone() if isinstance(x, torch.Tensor)
                    else x, tree)


@dataclasses.dataclass
class _Entry:
    """One signature: its static binding and, on CUDA, its graph, input
    buffers (one per array leaf, in leaf order), outputs and launch-count
    delta."""
    binding: StaticBinding
    graph: Optional[Any] = None
    buffers: Sequence[torch.Tensor] = ()
    outputs: Any = None
    delta: Dict[str, int] = dataclasses.field(default_factory=dict)
    warmup_s: float = 0.0
    capture_s: float = 0.0


class Programs:
    """One engine's program cache: its device and, on CUDA, the memory
    pool every graph of the engine shares."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.pool = (torch.cuda.graph_pool_handle()
                     if self.device.type == "cuda" else None)
        self.programs: List["Program"] = []
        # shared with every program (a program holds no reference back,
        # so a dropped engine frees its graphs at once)
        self._eager = [False]

    def program(self, fn: Callable, n_static: int, name: str) -> "Program":
        prog = Program(fn, n_static, self.device, self.pool, self._eager,
                       name)
        self.programs.append(prog)
        return prog

    @contextlib.contextmanager
    def _eager_calls(self):
        """While open, every program runs ``fn`` eagerly on fresh copies
        of its dynamic arguments and touches no cache (a comparison
        against the graphs; the engine never opens it)."""
        prev, self._eager[0] = self._eager[0], True
        try:
            yield
        finally:
            self._eager[0] = prev

    def stats(self) -> Dict[str, Any]:
        """Signatures compiled, graphs captured (none on the CPU), graph
        replays, and per program and captured signature the seconds of
        its eager warm-up and of its capture."""
        out = {"signatures": 0, "captures": 0, "replays": 0, "programs": {}}
        for p in self.programs:
            if not p._entries:
                continue
            graphed = [e for e in p._entries.values() if e.graph is not None]
            out["signatures"] += p._cache_size()
            out["captures"] += len(graphed)
            out["replays"] += p.replays
            out["programs"][p.name] = {
                "signatures": p._cache_size(), "captures": len(graphed),
                "replays": p.replays,
                "warmup_s": [e.warmup_s for e in graphed],
                "capture_s": [e.capture_s for e in graphed]}
        return out


class Program:
    """``fn(*static, *dynamic)`` compiled once per input signature: a
    CUDA graph on a CUDA device, the eager call on the CPU (see the
    module docstring). ``_cache_size()`` is the number of signatures
    compiled; ``replays`` counts graph replays."""

    def __init__(self, fn: Callable, n_static: int, device: torch.device,
                 pool, eager: List[bool], name: str):
        self.fn = fn
        self.n_static = n_static
        self.device = device
        self.pool = pool
        self._eager_flag = eager
        self.name = name
        self.replays = 0
        self._entries: Dict[tuple, _Entry] = {}

    def _cache_size(self) -> int:
        return len(self._entries)

    def _fresh(self, x):
        """A device COPY of a host array (never an alias of it); tensors
        move to the device only if they lie elsewhere."""
        if isinstance(x, np.ndarray):
            return torch.tensor(x, device=self.device)
        if isinstance(x, torch.Tensor) and x.device != self.device:
            return x.to(self.device)
        return x

    def _eager(self, *args):
        """``fn`` run eagerly on ``args`` (dynamic arguments copied to the
        device), bypassing the cache."""
        static, dynamic = args[:self.n_static], args[self.n_static:]
        return self.fn(*static, *tree_map(lambda p, x: self._fresh(x),
                                          dynamic))

    def __call__(self, *args):
        if self._eager_flag[0]:
            return self._eager(*args)
        static, dynamic = args[:self.n_static], args[self.n_static:]
        key = signature(dynamic)
        entry = self._entries.get(key)
        if entry is None:
            if self.device.type != "cuda":
                self._entries[key] = _Entry(StaticBinding(static))
                return self._eager(*args)
            return self._compile(key, static, dynamic)
        entry.binding.check(static, self.name)
        if entry.graph is None:
            return self._eager(*args)
        arrays = [x for _, x in leaves(dynamic) if _is_array(x)]
        for buf, x in zip(entry.buffers, arrays):
            buf.copy_(torch.as_tensor(x))
        entry.graph.replay()
        ops.add_launch_counts(entry.delta)
        self.replays += 1
        return entry.outputs

    def _buffers(self, dynamic):
        """(the dynamic tree over new device buffers holding its values,
        the buffers in leaf order)."""
        bufs: List[torch.Tensor] = []

        def buffer(path, x):
            if not _is_array(x):
                return x
            buf = torch.empty(tuple(x.shape), dtype=_torch_dtype(x),
                              device=self.device)
            buf.copy_(torch.as_tensor(x))
            bufs.append(buf)
            return buf

        return tree_map(buffer, dynamic), bufs

    def _compile(self, key, static, dynamic):
        """The first call of a signature on CUDA: eager warm-up on a side
        stream (its results are returned), then the capture."""
        t0 = time.perf_counter()
        inputs, bufs = self._buffers(dynamic)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            result = self.fn(*static, *inputs)
        current.wait_stream(side)
        torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        before = ops.launch_counts()
        collecting = gc.isenabled()
        gc.disable()         # torch.cuda.graph collects once, before
        try:
            # the outer context restores the current stream even when a
            # failed capture's exit raises before its own would
            with torch.cuda.stream(current), \
                    torch.cuda.graph(graph, pool=self.pool):
                outputs = self.fn(*static, *inputs)
        finally:
            if collecting:
                gc.enable()
            # the capture launched nothing: take back what it counted
            delta = count_delta(before, ops.launch_counts())
            ops.add_launch_counts({k: -v for k, v in delta.items()})
        self._entries[key] = _Entry(
            StaticBinding(static), graph, bufs, outputs, delta,
            t1 - t0, time.perf_counter() - t1)
        return result


def check_replay(program: Program, *args) -> List[str]:
    """Replay ``program`` on ``args`` (compiling the signature first if
    it is new) and run it eagerly on a clone of every static argument;
    return the paths of the outputs and static leaves that differ bit for
    bit between the two (empty: identical). The static arguments hold the
    replay's state afterwards."""
    static, dynamic = args[:program.n_static], args[program.n_static:]
    if signature(dynamic) not in program._entries:
        program(*args)
    clones = clone_tree(static)
    replays = program.replays
    replayed = clone_tree(program(*args))
    if program.device.type == "cuda" and program.replays != replays + 1:
        raise RuntimeError(f"{program.name}: the call did not replay")
    eager = program._eager(*clones, *dynamic)
    bad = [("out",) + p for (p, a), (_, b)
           in zip(leaves(replayed), leaves(eager)) if not same_bits(a, b)]
    bad += [("static",) + p for (p, a), (_, b)
            in zip(leaves(static), leaves(clones)) if not same_bits(a, b)]
    return ["/".join(map(str, p)) for p in bad]
