"""Fault-tolerant checkpointing (the port's copy of
``repro/checkpoint/checkpoint.py``): atomic writes, a content manifest,
keep-last-k GC and restore-latest, on the reference's on-disk format,
so a checkpoint either package writes, the other restores.

Layout:
    <dir>/step_000000123/
        manifest.msgpack   (tree spec, paths, shapes, dtypes, metadata,
                            checksums; version 2)
        arrays.npz         (leaf i -> 'a<i>')
    <dir>/step_000000123.tmp   (staging; atomic rename on completion)

Leaves are torch tensors (or anything numpy takes). bf16 is stored as
its ``uint16`` bits, with ``"bfloat16"`` in ``dtypes``; every other
dtype is spelled as numpy spells it. ``paths`` are the strings the
reference's ``jax.tree_util.keystr`` gives for the same tree
(``['blocks']['b0']['attn']['wq']['w'].data``; a NamedTuple's fields by
attribute, ``.opt.m['embed']['w']``), built here without JAX, so both
packages name a damaged leaf alike. The manifest is written and
read by the port's own MessagePack codec (``_msgpack``).

Two restore paths share the format:

  * **self-describing** (``like=None``): the tree structure, container
    kinds and exact leaf dtypes come from the manifest's tree spec
    (``quant.prepare.tree_manifest``); a prepared tree (packed nibbles,
    int8 rows, scales, act scales) restores bit for bit;
  * **template-based** (``like=`` a tree): leaves restore into its
    structure (its NamedTuples included: a training state restores as
    the ``TrainState`` it was) and are cast to each reference leaf's
    dtype.

Every leaf's full sha256 (over its true-dtype bytes) is verified before
the tree is rebuilt: a damaged checkpoint raises :class:`ChecksumError`
naming the leaf. A missing step raises :class:`CheckpointNotFound`.
Restored leaves go to host numpy, then onto ``device`` (CUDA unless the
caller passes ``device="cpu"``; without CUDA that default raises).

Sharded trees (DTensor leaves, ``parallel.sharding``): saving gathers
every leaf whole (``full_tensor``, a collective every rank joins), rank
0 writes the same bytes a plain save writes, and the other ranks wait at
a barrier, so either package restores it. ``shardings=`` (a
``NamedSharding`` tree) restores each leaf onto its mesh at its
placements, each rank keeping its own shard; the topology may differ
from the one that saved.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.device import resolve_device
from repro_torch.parallel import sharding as shd

MANIFEST_VERSION = 2


class CheckpointError(RuntimeError):
    """Base class for checkpoint failures."""


class ChecksumError(CheckpointError):
    """A restored leaf's bytes do not match its recorded sha256."""


class CheckpointNotFound(CheckpointError, FileNotFoundError):
    """The requested step (or any step at all) does not exist."""


def _tree_paths(tree) -> List[str]:
    """Each leaf's ``jax.tree_util.keystr`` path, in leaf order (the
    order of ``quant.prepare.tree_manifest``)."""
    from repro_torch.quant.prepare import PreparedWeight
    paths: List[str] = []

    def walk(node, prefix: str):
        if node is None:
            return
        if isinstance(node, PreparedWeight):
            for field in ("data", "scale", "act_scale"):
                if getattr(node, field) is not None:
                    paths.append(f"{prefix}.{field}")
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}[{k!r}]")
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for k, v in zip(node._fields, node):
                walk(v, f"{prefix}.{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}[{i}]")
        else:
            paths.append(prefix)

    walk(tree, "")
    return paths


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf, host: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(host.dtype)


def _leaf_bytes(arr: np.ndarray) -> bytes:
    return np.ascontiguousarray(arr).tobytes()


def _writer(tree) -> bool:
    """False on the ranks other than 0 of a sharded tree's save."""
    import torch.distributed as dist
    return not (shd.has_dtensor(tree) and dist.is_initialized()
                and dist.get_rank() != 0)


def save_checkpoint(directory: str, step: int, tree: Any,
                    metadata: Optional[Dict] = None) -> str:
    """Atomic: stage into .tmp, write arrays + manifest, rename. A
    sharded tree is gathered whole on every rank and written by rank 0
    alone; every rank returns after the write."""
    final = os.path.join(directory, f"step_{step:09d}")
    if shd.has_dtensor(tree):
        import torch.distributed as dist
        writer = _writer(tree)
        full = shd.undistribute(tree)
        if writer:
            _write(directory, final, step, full, metadata)
        if dist.is_initialized():
            dist.barrier()
        return final
    _write(directory, final, step, tree, metadata)
    return final


def _write(directory: str, final: str, step: int, tree: Any,
           metadata: Optional[Dict]):
    from repro_torch.quant.prepare import tree_manifest
    os.makedirs(directory, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    spec, leaves = tree_manifest(tree)
    host = [_host(lf) for lf in leaves]
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"a{i}": a for i, a in enumerate(host)})
    manifest = {
        "version": MANIFEST_VERSION,
        "step": step,
        "n_leaves": len(host),
        "paths": _tree_paths(tree),
        "shapes": [[int(d) for d in a.shape] for a in host],
        "dtypes": [_dtype_name(lf, a) for lf, a in zip(leaves, host)],
        "checksums": [hashlib.sha256(_leaf_bytes(a)).hexdigest()
                      for a in host],
        "tree_spec": spec,
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(_msgpack.packb(manifest))
    if os.path.isdir(final):
        # a directory rename cannot overwrite a non-empty target: drop
        # the old step first (the staged copy is complete)
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic on POSIX


def list_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name,
                                             "manifest.msgpack")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def _leaf_path(manifest: Dict, i: int) -> str:
    paths = manifest.get("paths") or []
    return paths[i] if i < len(paths) else f"leaf[{i}]"


def _load_step(directory: str, step: int) -> Tuple[Dict, List[np.ndarray]]:
    path = os.path.join(directory, f"step_{step:09d}")
    man = os.path.join(path, "manifest.msgpack")
    if not os.path.exists(man):
        raise CheckpointNotFound(
            f"no checkpoint for step {step} under {directory!r} "
            f"(have steps {list_steps(directory)})")
    with open(man, "rb") as f:
        manifest = _msgpack.unpackb(f.read())
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = [data[f"a{i}"] for i in range(manifest["n_leaves"])]
    return manifest, arrays


def _verify_leaf(manifest: Dict, i: int, arr: np.ndarray):
    """Check leaf ``i``'s full sha256 against the manifest (pre-v2
    manifests carried nothing per leaf to verify)."""
    sums = manifest.get("checksums")
    if not sums:
        return
    got = hashlib.sha256(_leaf_bytes(arr)).hexdigest()
    if got != sums[i]:
        raise ChecksumError(
            f"checkpoint leaf {_leaf_path(manifest, i)!r} (index {i}) is "
            f"corrupted: sha256 {got[:12]}... != recorded "
            f"{sums[i][:12]}...")


def _to_tensor(manifest: Dict, i: int, arr: np.ndarray,
               device: torch.device) -> torch.Tensor:
    """Leaf ``i`` in its true dtype on ``device`` (bf16 from its bits)."""
    if manifest["dtypes"][i] == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def restore_checkpoint(directory: str, step: int, like: Any = None,
                       shardings: Any = None, verify: bool = True,
                       device=None) -> Tuple[Any, Dict]:
    """Restore step ``step`` onto ``device`` as ``(tree, metadata)``;
    raises :class:`CheckpointNotFound` if it does not exist and
    :class:`ChecksumError` on a damaged leaf.

    With ``like=None`` the tree rebuilds from the manifest's spec with
    the exact stored dtypes (prepared containers included). With ``like``
    (a tree of tensors) leaves restore into its structure, cast to each
    reference leaf's dtype. With ``shardings`` (a ``NamedSharding`` tree
    in ``like``'s structure) each leaf is then placed on its mesh, on
    the mesh's device type unless ``device`` says otherwise."""
    from repro_torch.quant.prepare import tree_from_manifest, tree_manifest
    if shardings is not None and device is None:
        device = _mesh_device(shardings)
    device = resolve_device(device)
    manifest, arrays = _load_step(directory, step)
    if verify:
        for i, arr in enumerate(arrays):
            _verify_leaf(manifest, i, arr)
    if like is None:
        spec = manifest.get("tree_spec")
        if spec is None:
            raise CheckpointError(
                f"checkpoint step {step} under {directory!r} predates "
                "the self-describing manifest (v2); pass a 'like' "
                "template to restore it")
        leaves = [_to_tensor(manifest, i, a, device)
                  for i, a in enumerate(arrays)]
        return tree_from_manifest(spec, leaves), manifest["metadata"]

    spec, refs = tree_manifest(like)
    if manifest["n_leaves"] != len(refs):
        raise CheckpointError(
            f"checkpoint has {manifest['n_leaves']} leaves, "
            f"expected {len(refs)}")
    restored = []
    for i, (ref, arr) in enumerate(zip(refs, arrays)):
        if list(arr.shape) != list(ref.shape):
            raise CheckpointError(
                f"leaf {_leaf_path(manifest, i)!r}: shape "
                f"{tuple(arr.shape)} != {tuple(ref.shape)}")
        restored.append(_to_tensor(manifest, i, arr, device).to(ref.dtype))
    tree = tree_from_manifest(spec, restored, like)
    if shardings is not None:
        tree = shd.distribute(tree, shardings)
    return tree, manifest["metadata"]


def _mesh_device(shardings) -> str:
    """The device type of the first mesh in a ``NamedSharding`` tree."""
    found = []
    shd.tree_map_with_path(lambda _, s: found.append(s), shardings)
    return found[0].mesh.device_type


class CheckpointManager:
    """save/restore with keep-last-k garbage collection."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep

    def save(self, step: int, tree: Any, metadata: Optional[Dict] = None):
        path = save_checkpoint(self.directory, step, tree, metadata)
        if _writer(tree):
            self._gc()
        return path

    def _gc(self):
        steps = list_steps(self.directory)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)
        # a writer that crashed mid-save leaves step_*.tmp behind;
        # list_steps ignores them, and GC removes them
        for name in os.listdir(self.directory):
            if re.fullmatch(r"step_\d+\.tmp", name):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def restore_latest(self, like: Any = None, shardings: Any = None,
                       missing_ok: bool = False, device=None):
        """Restore the newest step as ``(step, tree, metadata)``, placed
        by ``shardings`` when given (``restore_checkpoint``).

        Raises :class:`CheckpointNotFound` when the directory holds no
        checkpoint; ``missing_ok=True`` returns ``(None, None, {})``
        instead."""
        step = latest_step(self.directory)
        if step is None:
            if missing_ok:
                return None, None, {}
            raise CheckpointNotFound(
                f"no checkpoint under {self.directory!r}")
        tree, meta = restore_checkpoint(self.directory, step, like,
                                        shardings, device=device)
        return step, tree, meta
