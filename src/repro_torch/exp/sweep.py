"""Sweep declaration and expansion (mirror of ``repro/exp/sweep.py``).

A :class:`SweepSpec` names an evaluation function (as an importable
``"pkg.module:function"`` path so points survive pickling into worker
processes) and a set of named axes. Expansion produces
:class:`ExperimentPoint`s — frozen, hashable, canonically-encodable
parameter bindings — in a deterministic order: cartesian products
iterate the *last* axis fastest (like nested for-loops in declaration
order); zipped sweeps pair axes element-wise.

Axis values must be canonically encodable (see :func:`encode`):
primitives, sequences, mappings, and frozen dataclasses such as
``TileConfig``. Unencodable objects (open-ended class instances, numpy
arrays) are rejected at expansion time so cache keys can never silently
depend on ``repr`` quirks — pass a name and resolve it inside the eval
function instead.

The same spec gives the same points, in the same order, with the same
encoding of every primitive parameter as the reference's; a dataclass
value is tagged with its own class's path, so a port class never
encodes like the reference's class of the same name.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
from typing import Any, Callable, Dict, Iterator, Mapping, Sequence, Tuple


def encode(value: Any) -> Any:
    """Canonical JSON-able encoding of a parameter value.

    The encoding is injective on the supported domain (type tags keep
    ``(1, 2)`` distinct from ``[1, 2]`` and ``True`` from ``1``) and
    stable across processes and interpreter restarts — it is the basis
    of the cache key.
    """
    # numpy scalars subclass python numbers (np.float64 is a float) —
    # normalize them first or their repr leaks into the key
    if type(value).__module__.startswith("numpy") and hasattr(value, "item"):
        return encode(value.item())
    if value is None or isinstance(value, (str, int)) \
            and not isinstance(value, bool):
        return value
    if isinstance(value, bool):
        return ["bool", int(value)]
    if isinstance(value, float):
        return ["f", repr(value)]
    if isinstance(value, (list, tuple)):
        tag = "tuple" if isinstance(value, tuple) else "list"
        return [tag, [encode(v) for v in value]]
    if isinstance(value, Mapping):
        # keys are encoded too (so {1: v} != {"1": v}); sort on the
        # JSON form since encoded keys may be strings or tagged lists
        items = sorted(([encode(k), encode(v)] for k, v in value.items()),
                       key=lambda kv: json.dumps(kv[0], sort_keys=True))
        return ["map", items]
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        cls = type(value)
        fields = [(f.name, encode(getattr(value, f.name)))
                  for f in dataclasses.fields(value)]
        return ["dc", f"{cls.__module__}.{cls.__qualname__}", fields]
    raise TypeError(
        f"cannot canonically encode {type(value).__name__!r} ({value!r}); "
        "pass a name/primitive and resolve the object inside the eval fn")


@dataclasses.dataclass(frozen=True)
class ExperimentPoint:
    """One evaluation: ``fn(**params)``.

    ``fn`` is an importable ``"pkg.module:function"`` path; ``params``
    a tuple of (name, value) pairs in axis declaration order.
    """

    fn: str
    params: Tuple[Tuple[str, Any], ...]

    @property
    def kwargs(self) -> Dict[str, Any]:
        return dict(self.params)

    def canonical(self) -> Any:
        """Order-independent encodable form (sorted by param name)."""
        return [self.fn, sorted((k, encode(v)) for k, v in self.params)]

    def label(self) -> str:
        return "/".join(f"{k}={v}" for k, v in self.params)


def fn_path(fn: Callable) -> str:
    """Importable path of a module-level callable."""
    if "<locals>" in fn.__qualname__:
        raise ValueError(f"{fn.__qualname__} is not module-level; sweep "
                         "eval functions must be importable by workers")
    return f"{fn.__module__}:{fn.__qualname__}"


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A named parameter sweep over one eval function.

    Attributes:
      name: sweep identifier (used in progress lines and result rows).
      fn: ``"pkg.module:function"`` path or a module-level callable.
      axes: ordered mapping axis name -> sequence of values.
      mode: 'product' (cartesian, last axis fastest) or 'zip'
        (element-wise; all axes must have equal length).
      fixed: extra params bound identically on every point.
      filters: predicates on the full param dict; points failing any
        are dropped at expansion time (never evaluated, never cached).
    """

    name: str
    fn: Any
    axes: Mapping[str, Sequence[Any]]
    mode: str = "product"
    fixed: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    filters: Sequence[Callable[[Dict[str, Any]], bool]] = ()

    def __post_init__(self):
        if self.mode not in ("product", "zip"):
            raise ValueError(f"bad sweep mode {self.mode!r}")
        if not self.axes:
            raise ValueError("sweep needs at least one axis")
        overlap = set(self.axes) & set(self.fixed)
        if overlap:
            raise ValueError(f"params both swept and fixed: {sorted(overlap)}")
        if self.mode == "zip":
            lengths = {k: len(v) for k, v in self.axes.items()}
            if len(set(lengths.values())) > 1:
                raise ValueError(f"zip axes differ in length: {lengths}")

    @property
    def fn_ref(self) -> str:
        return self.fn if isinstance(self.fn, str) else fn_path(self.fn)

    def _combos(self) -> Iterator[Tuple[Any, ...]]:
        names = list(self.axes)
        if self.mode == "zip":
            yield from zip(*(self.axes[n] for n in names))
        else:
            yield from itertools.product(*(self.axes[n] for n in names))

    def points(self) -> Tuple[ExperimentPoint, ...]:
        """Expand to points in deterministic order (filters applied)."""
        names = list(self.axes)
        fixed = tuple(self.fixed.items())
        ref = self.fn_ref
        out = []
        for combo in self._combos():
            params = dict(zip(names, combo), **self.fixed)
            if any(not flt(params) for flt in self.filters):
                continue
            point = ExperimentPoint(ref, tuple(zip(names, combo)) + fixed)
            point.canonical()  # reject unencodable values eagerly
            out.append(point)
        return tuple(out)

    def __len__(self) -> int:
        return len(self.points())
