"""Sharding rules (mirror of ``repro/parallel/sharding.py``): the
partition spec of every parameter, optimizer-state, batch and cache
leaf of every family, and its DTensor placements.

Scheme: batch shards over the data axes ('pod', 'data'); tensor
parallelism over 'model'; parameters and optimizer state shard over
'data' (FSDP within a pod; they replicate across pods) and 'model'; MoE
experts shard over 'model' when it divides their count, else d_ff; KV
caches shard batch over data and capacity over 'model'.

A spec is a tuple with one entry per tensor dim, each ``None``, an axis
name or a tuple of names: the counterpart of ``PartitionSpec``. The
rules are the reference's, regex for regex in the same order, on the
same ``jax.tree_util.keystr`` paths (``['blocks']['b0']['attn']['wq']
['w']``, ``.m['embed']['w']``, ``[1]``), so the port places every leaf
where the reference does. An axis that does not divide its dim is
dropped (``_fit``), so no placement is ever uneven.

:func:`placements` turns a spec into DTensor placements on a mesh: a
dim sharded over ('pod', 'data') is ``Shard(d)`` on both mesh dims,
in mesh order. The ``*_shardings`` functions give a tree of
``NamedSharding`` (a mesh and a spec) in the shape of theirs;
:func:`distribute` places a tree of tensors by such a tree. The rules need only the mesh's axis names and
sizes (``mesh_dim_names`` and ``shape`` of a ``DeviceMesh`` or of
``launch.mesh.AbstractMesh``).
"""
from __future__ import annotations

import math
import re
import sys
from typing import Any, Callable, Dict, Tuple

Spec = Tuple[Any, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def fsdp_axes(mesh) -> Tuple[str, ...]:
    """Parameter and optimizer sharding axes: FSDP within a pod only;
    parameters replicate across pods."""
    return tuple(a for a in ("data",) if a in mesh.mesh_dim_names)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _fit(mesh, shape, spec) -> Spec:
    """Drop axes that don't divide their dim; pad spec to rank."""
    spec = (None,) * (len(shape) - len(spec)) + tuple(spec)
    return tuple(ax if ax is not None and dim % _axis_size(mesh, ax) == 0
                 else None for dim, ax in zip(shape, spec))


def param_pspec(path: str, shape, mesh) -> Spec:
    """Spec of one parameter leaf (``path`` as ``keystr`` spells it)."""
    D = fsdp_axes(mesh)
    D = D if len(D) > 1 else (D[0] if D else None)
    M = "model" if "model" in mesh.mesh_dim_names else None
    nd = len(shape)

    def fit(*spec):
        return _fit(mesh, shape, spec)

    if re.search(r"embed", path):
        return fit(M, D)
    if re.search(r"lm_head", path):
        return fit(D, M) if nd >= 2 else fit(M)
    # MoE expert stacks: (L, E, d, f) / (L, E, f, d)
    if re.search(r"moe.*(w_gate|w_up|w_down)", path) and nd == 4:
        e = shape[1]
        ep = e % _axis_size(mesh, M) == 0 if M else False
        if re.search(r"w_down", path):
            return fit(None, M, None, D) if ep else fit(None, None, M, D)
        return fit(None, M, D, None) if ep else fit(None, None, D, M)
    if re.search(r"router", path):
        return fit(D, None)
    # attention / rwkv / mlp projections: in -> out
    if re.search(r"(wq|wk|wv|w_r|w_k|w_v|w_g|w_gate|w_up|c_key|c_rec|"
                 r"w_in_rnn|w_in_gate|w_a|w_x|frontend_proj|fc1)", path):
        if path.endswith("['b']") or nd == 1 or (nd == 2 and "blocks" in
                                                 path and shape[0] < 256):
            return fit(M)  # bias on the sharded output dim
        return fit(D, M)
    if re.search(r"(wo|w_down|c_val|w_out|fc2)", path):
        if path.endswith("['b']"):
            return fit(D) if nd == 1 else fit(None, D)
        return fit(M, D)
    if re.search(r"w_lora_a", path):
        return fit(D, None)
    if re.search(r"w_lora_b", path):
        return fit(None, M)
    if re.search(r"\['u'\]", path):
        return fit(M, None)
    if re.search(r"conv_w", path):
        return fit(None, M)
    if re.search(r"(w_bias|conv_b|b_a|b_x|lambda)", path):
        return fit(M)
    # norms, mixing coefficients, scalars: replicated
    return ()


def tree_map_with_path(fn: Callable[[str, Any], Any], tree, prefix=""):
    """``fn(keystr path, leaf)`` over a tree of dicts (keys sorted, as
    ``jax.tree_util`` orders them), NamedTuples (``.field``), lists and
    tuples (``[i]``); the containers are rebuilt around the results and
    ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], f"{prefix}[{k!r}]")
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, f"{prefix}.{k}")
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _opt_pspec(path: str, leaf, mesh) -> Spec:
    return () if len(leaf.shape) == 0 else param_pspec(
        re.sub(r"^\[[01]\]", "", path), tuple(leaf.shape), mesh)


def batch_pspec(path: str, shape, mesh) -> Spec:
    D = data_axes(mesh)
    D = D if len(D) > 1 else (D[0] if D else None)
    return _fit(mesh, shape, (D,) + (None,) * (len(shape) - 1))


def cache_pspec(path: str, shape, mesh) -> Spec:
    """KV caches: (G, B, C, H, Dh) -> batch over data, capacity over
    model. Recurrent states: (L, B, ...) -> batch over data, feature over
    model. Encoder outputs (B, T, d): batch over data, d over model."""
    D = data_axes(mesh)
    D = D if len(D) > 1 else (D[0] if D else None)
    M = "model" if "model" in mesh.mesh_dim_names else None
    nd = len(shape)
    if re.search(r"\.k'?\]|\.v'?\]|\['k'\]|\['v'\]", path) or nd == 5:
        return _fit(mesh, shape, (None, D, M, None, None))
    if nd == 4:   # rglru conv tails (L, B, W-1, dr)
        return _fit(mesh, shape, (None, D, None, M))
    if nd == 3:
        # encdec decode state: ([0]=kv caches, [1]=enc_out (B, T, d))
        if re.fullmatch(r"\[1\]", path):
            return _fit(mesh, shape, (D, None, M))
        # cache pos (G, B, C) / recurrent states (L, B, d)
        return _fit(mesh, shape, (None, D, M))
    if nd == 2:
        return _fit(mesh, shape, (D, M))
    return _fit(mesh, shape, (D,))


# ---------------------------------------------------------- placements

def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements (one per mesh dim) of a spec: ``Shard(d)`` on
    every mesh dim that names tensor dim ``d``, ``Replicate()``
    elsewhere. A dim sharded over several axes takes them in mesh order
    (the major axis first, as a ``PartitionSpec`` tuple does)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


class NamedSharding:
    """A mesh and a spec: where one tensor lives (the counterpart of
    ``jax.sharding.NamedSharding``). ``placements`` are its DTensor
    placements on ``mesh``."""

    def __init__(self, mesh, spec: Spec):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.placements = placements(self.spec, mesh)

    def __repr__(self):
        return f"NamedSharding({self.spec})"


def _named(rule: Callable, tree, mesh):
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, rule(path, leaf)), tree)


def param_shardings(params, mesh):
    """``NamedSharding`` tree of a parameter tree (leaves with
    ``shape``: tensors, or shapes from an init on the meta device)."""
    return _named(lambda path, leaf: param_pspec(
        path, tuple(leaf.shape), mesh), params, mesh)


def opt_shardings(opt_state, mesh):
    """AdamW's m and v shard like the params; scalars (the step)
    replicate. The path's ``^\\[[01]\\]`` strip is the reference's; on an
    ``AdamWState`` (``.step``, ``.m[...]``, ``.v[...]``) it never fires
    there either, and the rules see the ``.m``/``.v`` prefix as the
    reference's do."""
    return _named(lambda path, leaf: _opt_pspec(path, leaf, mesh),
                  opt_state, mesh)


def batch_shardings(batch, mesh):
    return _named(lambda path, leaf: batch_pspec(
        path, tuple(leaf.shape), mesh), batch, mesh)


def cache_shardings(caches, mesh):
    return _named(lambda path, leaf: cache_pspec(
        path, tuple(leaf.shape), mesh), caches, mesh)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def zip_map(fn: Callable[[Any, Any], Any], tree, other):
    """``fn(leaf, node)`` over the leaves of ``tree``, ``node`` being
    what ``other`` holds at the same place (a ``NamedSharding`` or a
    spec tuple, taken whole)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: zip_map(fn, tree[k], other[k]) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(zip_map(fn, v, o) for v, o in zip(tree, other)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(zip_map(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


def place(x, sharding: NamedSharding):
    """``x`` as a DTensor at ``sharding``. A plain tensor is the same
    full tensor on every rank; each keeps its own shard (no collective).
    A DTensor is redistributed (nothing moves if it is there already)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(x, DTensor):
        if tuple(x.placements) == sharding.placements and \
                x.device_mesh == sharding.mesh:
            return x
        return x.redistribute(sharding.mesh, sharding.placements)
    return distribute_tensor(x, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def distribute(tree, shardings):
    """Every tensor of ``tree`` placed at its ``NamedSharding`` in the
    tree ``shardings`` (:func:`place`): the counterpart of
    ``jax.device_put(tree, shardings)``."""
    return zip_map(place, tree, shardings)


def undistribute(tree):
    """Each DTensor of ``tree`` as its full tensor (a collective: every
    rank calls it); other leaves as they are."""
    from torch.distributed.tensor import DTensor
    return tree_map_with_path(
        lambda _, x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


def has_dtensor(tree) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    if mod is None:
        return False
    found = []
    tree_map_with_path(
        lambda _, x: found.append(isinstance(x, mod.DTensor)), tree)
    return any(found)
