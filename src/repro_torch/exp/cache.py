"""Content-addressed on-disk result store for experiment points (mirror
of ``repro/exp/cache.py``).

Key = SHA-256 of the canonical encoding of (schema version, salt,
eval-module source hash, eval-function path, sorted params). The salt
defaults to a hash of the ``repro_torch.core`` + ``repro_torch.exp`` +
``repro_torch.autotune`` source trees, so editing the numerics or the
engine invalidates every cached result; the per-point module hash does
the same for the study module that defines the eval function. The store
stays append-only (stale entries are simply never addressed again).

The port's schema tag differs from the reference's, so a key of one
package can never address an entry of the other, even in a shared
directory; the port's default directory is its own as well.

Entries are one JSON file per key, sharded by the first two hex chars,
written atomically (tmp file + rename) so concurrent writers — the
process-pool runner, or two scripts sharing a cache — can never leave a
torn entry. Values must be JSON-serializable; that is exactly the
"structured rows" contract the study scripts emit.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import importlib.util
import json
import os
import tempfile
from typing import Any, Optional, Tuple

from repro_torch.exp.sweep import ExperimentPoint

DEFAULT_CACHE_DIR = os.environ.get("REPRO_TORCH_EXP_CACHE",
                                   "results/expcache_torch")
_SCHEMA = "exp-torch-v1"

# Packages whose source text feeds the default code-version salt.
# repro_torch.autotune is registered here so editing the planner's
# objectives orphans every cached score (same contract as the simulator
# itself); its __init__ imports no model, so hashing it never pulls the
# model stack.
_SALT_PACKAGES = ("repro_torch.core", "repro_torch.exp",
                  "repro_torch.autotune")


@functools.lru_cache(maxsize=None)
def code_salt() -> str:
    """Hash of the numerics + engine sources (the code-version salt)."""
    h = hashlib.sha256()
    for pkg_name in _SALT_PACKAGES:
        pkg = __import__(pkg_name, fromlist=["__path__"])
        for path in sorted(pkg.__path__):
            for fname in sorted(os.listdir(path)):
                if not fname.endswith(".py"):
                    continue
                h.update(fname.encode())
                with open(os.path.join(path, fname), "rb") as f:
                    h.update(f.read())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def _module_salt(mod_name: str) -> str:
    """Hash of the eval function's defining module source. Keyed per
    point, this invalidates a study's cached results when its eval code
    changes even though the module lives outside _SALT_PACKAGES. Uses
    find_spec so the module is never executed just to compute a key."""
    try:
        spec = importlib.util.find_spec(mod_name)
    except (ImportError, ValueError):
        return ""
    origin = getattr(spec, "origin", None) if spec else None
    if not origin or not os.path.exists(origin):
        return ""
    h = hashlib.sha256()
    with open(origin, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def point_key(point: ExperimentPoint, salt: Optional[str] = None) -> str:
    """Stable cache key for a point (hex SHA-256)."""
    payload = [_SCHEMA, salt if salt is not None else code_salt(),
               _module_salt(point.fn.partition(":")[0]),
               point.canonical()]
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


_MISS = object()


@dataclasses.dataclass
class ResultCache:
    """Filesystem-backed point-result store.

    ``salt=None`` uses :func:`code_salt`; tests inject explicit salts to
    exercise invalidation.
    """

    root: str = DEFAULT_CACHE_DIR
    salt: Optional[str] = None

    def __post_init__(self):
        # fail at construction, not after the sweep has simulated
        if os.path.exists(self.root) and not os.path.isdir(self.root):
            raise ValueError(f"cache dir {self.root!r} is not a directory")

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key[:2], key + ".json")

    def get(self, point: ExperimentPoint) -> Tuple[bool, Any]:
        """(hit, value). A corrupt/unreadable entry counts as a miss."""
        path = self._path(point_key(point, self.salt))
        try:
            with open(path) as f:
                entry = json.load(f)
        except (OSError, ValueError):
            return False, None
        if "result" not in entry:
            return False, None
        return True, entry["result"]

    def put(self, point: ExperimentPoint, result: Any) -> None:
        key = point_key(point, self.salt)
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        entry = {"key": key, "fn": point.fn, "params": point.label(),
                 "result": result}
        blob = json.dumps(entry, indent=1, sort_keys=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   prefix=".tmp-", suffix=".json")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(blob)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def __len__(self) -> int:
        if not os.path.isdir(self.root):
            return 0
        return sum(1 for _, _, files in os.walk(self.root)
                   for f in files if f.endswith(".json")
                   and not f.startswith(".tmp-"))
