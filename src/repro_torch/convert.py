"""Weight bridge: the reference's parameter trees -> the port's tensors.

The input is a nested dict of numpy arrays (``jax.tree.map(np.asarray,
params)`` on the reference side), with the reference's paths and
layouts, stacked layer axes included. bf16 arrays travel as their
``uint16`` bits (as ``repro/checkpoint/checkpoint.py`` stores them), so
the conversion is exact. Prepared trees convert too: a prepared weight
arrives as ``{data, scale, kind, act_scale}`` (a dict, or any object
with those attributes) and becomes a ``quant.prepare.PreparedWeight``.
A decode-state NamedTuple (the reference's ``KVCache``, ``RWKVState``
or ``RGLRUState``) becomes the port's class with the same fields, also
inside a plain tuple (encdec's ``(KVCache, enc_out)``).

``to_numpy`` goes the other way for comparisons (bf16 widens to f32,
which is exact).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.layers.attention import KVCache
from repro_torch.layers.rglru import RGLRUState
from repro_torch.layers.rwkv6 import RWKVState
from repro_torch.quant.prepare import PreparedWeight

_PREPARED_FIELDS = ("data", "scale", "kind", "act_scale")
# the reference's decode-state NamedTuples, by their fields -> the port's
_STATES = {t._fields: t for t in (KVCache, RWKVState, RGLRUState)}


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _prepared_fields(node):
    if isinstance(node, dict) and "kind" in node and "data" in node \
            and set(node) <= set(_PREPARED_FIELDS):
        return node
    if all(hasattr(node, f) for f in _PREPARED_FIELDS) \
            and isinstance(getattr(node, "kind"), str):
        return {f: getattr(node, f) for f in _PREPARED_FIELDS}
    return None


def params_from_numpy(tree, device=None):
    """Convert a nested dict/list of numpy arrays (and prepared-weight
    records, and decode states: KV caches, RWKV and RG-LRU states) into
torch tensors on ``device`` (CUDA by default)."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, np.ndarray):
            return tensor_from_numpy(node, device)
        fields = _prepared_fields(node)
        if fields is not None:
            opt = {k: (None if fields.get(k) is None
                       else tensor_from_numpy(fields[k], device))
                   for k in ("scale", "act_scale")}
            return PreparedWeight(tensor_from_numpy(fields["data"], device),
                                  opt["scale"], fields["kind"],
                                  opt["act_scale"])
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        fields = getattr(node, "_fields", None)
        if fields is not None:
            return _STATES.get(tuple(fields), type(node))(
                *(conv(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        if node is None:
            return None
        return tensor_from_numpy(node, device)

    return conv(tree)


def to_numpy(tree) -> Any:
    """torch tree -> numpy tree (bf16 -> f32; PreparedWeight -> dict; a
    decode state (KVCache, RWKVState, RGLRUState) -> a tuple of its
    fields)."""
    if isinstance(tree, PreparedWeight):
        return {f: to_numpy(getattr(tree, f)) if f != "kind" else tree.kind
                for f in _PREPARED_FIELDS}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return tuple(to_numpy(t) for t in tree)
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        # a copy: the port updates caches in place, and a CPU tensor's
        # .numpy() would alias them
        return t.numpy().copy()
    return tree


def tree_to(tree, device):
    """Move every tensor of a tree (PreparedWeight and states included)
    to ``device``; tensors already there pass through uncopied."""
    if isinstance(tree, PreparedWeight):
        return PreparedWeight(
            tree.data.to(device),
            None if tree.scale is None else tree.scale.to(device),
            tree.kind,
            None if tree.act_scale is None else tree.act_scale.to(device))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_to(t, device) for t in tree))
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree
