"""Activation sharding constraints (mirror of
``repro/parallel/act_sharding.py``): the canonical activation layout on
a mesh, Megatron style:

    tokens/activations: batch over ('pod','data'), features unsharded
    q/k/v:              batch over dp, heads over 'model' iff divisible
    mlp hidden:         batch over dp, d_ff over 'model'
    logits:             batch over dp, vocab over 'model'

:func:`constrain` redistributes a DTensor onto that layout on its own
``device_mesh`` (the counterpart of ``with_sharding_constraint`` under
the ambient mesh); on a plain tensor it is the identity, so a model on
one device runs exactly as without it. An axis that does not divide
its dim is dropped.

Where XLA's SPMD partitioner finds a layout for any op, DTensor needs
a rule per op, and its rules are missing, version-dependent or costly
for some of the models' ops. So the port also runs regions on local
tensors, each exact against one device and each a plain call on plain
tensors: :func:`local_rows` (per batch row: attention, MoE routing and combine,
the WKV and RG-LRU recurrences, the loss, the embedding lookup),
:func:`local_last_dim` (norms, RoPE), :func:`local_pointwise` and
:func:`local_sum` (elementwise updates and their sums: the MLP gate,
AdamW), :func:`assign` (in-place state writes).
"""
from __future__ import annotations

import math
import os
import sys

import torch

from repro_torch.parallel.sharding import (axis_sizes, placements,
                                          tree_map_with_path)

DP = "__dp__"        # sentinel: the data-parallel axes ('pod','data')
MDL = "__model__"    # sentinel: the tensor-parallel axis


def dtensor_type():
    """``DTensor``, or None while ``torch.distributed.tensor`` is not
    imported (then no tensor can be one): plain tensors never pay for
    the import."""
    mod = sys.modules.get("torch.distributed.tensor")
    return getattr(mod, "DTensor", None)


def is_dtensor(x) -> bool:
    cls = dtensor_type()
    return cls is not None and isinstance(x, cls)


def _resolve(axis, names):
    if axis == DP:
        axes = tuple(a for a in ("pod", "data") if a in names)
        return axes if len(axes) > 1 else (axes[0] if axes else None)
    if axis == MDL:
        return "model" if "model" in names else None
    return axis


def _size(sizes, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def spec_for(x, *axes) -> tuple:
    """The spec ``constrain`` pins ``x`` to on its mesh."""
    mesh = x.device_mesh
    names, sizes = tuple(mesh.mesh_dim_names), axis_sizes(mesh)
    spec = []
    for dim, ax in zip(x.shape, axes):
        r = _resolve(ax, names)
        spec.append(r if r is not None and dim % _size(sizes, r) == 0
                    else None)
    return tuple(spec) + (None,) * (x.dim() - len(spec))


def axis_size(x, axis) -> int:
    """Size of ``axis`` (a sentinel or a name) on a DTensor's mesh; 1
    where the mesh lacks it."""
    mesh = x.device_mesh
    return _size(axis_sizes(mesh), _resolve(axis, tuple(mesh.mesh_dim_names)))


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """``x`` redistributed to the spec ``axes`` (sentinels resolved,
    non-dividing axes dropped) on its own mesh; a plain tensor as is."""
    if not is_dtensor(x):
        return x
    target = placements(spec_for(x, *axes), x.device_mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def batch_seq(x: torch.Tensor) -> torch.Tensor:
    """(B, S, ...) block-boundary activations: batch over dp and, by
    default, sequence over 'model' (Megatron-style sequence
    parallelism). ``REPRO_SP=0`` drops the sequence axis."""
    if x.dim() >= 2 and os.environ.get("REPRO_SP", "1") == "1":
        return constrain(x, DP, MDL)
    return constrain(x, DP)


def heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D): batch over dp, heads over model iff divisible."""
    return constrain(x, DP, None, MDL, None)


def ffn_hidden(x: torch.Tensor) -> torch.Tensor:
    """(B, S, F): batch over dp, d_ff over model."""
    return constrain(x, DP, None, MDL)


def logits(x: torch.Tensor) -> torch.Tensor:
    """(B, S, V) or (B, V): batch over dp, vocab over model."""
    if x.dim() == 3:
        return constrain(x, DP, None, MDL)
    return constrain(x, DP, MDL)


def expert_parallel(x: torch.Tensor) -> torch.Tensor:
    """(E, C, d) MoE expert-major activations: experts over model."""
    return constrain(x, MDL, DP, None)


def assign(dst: torch.Tensor, src: torch.Tensor):
    """``dst.copy_(src)`` in place; on a DTensor ``dst`` each rank
    copies its own shard of ``src`` (redistributed to ``dst``'s
    placements)."""
    if not is_dtensor(dst):
        dst.copy_(src)
        return
    if not is_dtensor(src):
        from torch.distributed.tensor import Replicate
        src = dtensor_type().from_local(
            src, dst.device_mesh, [Replicate()] * dst.device_mesh.ndim,
            run_check=False)
    dst.to_local().copy_(
        src.redistribute(dst.device_mesh, dst.placements).to_local())


def local_at(x, placements, grad_placements=None) -> torch.Tensor:
    """The local tensor of DTensor ``x`` redistributed to ``placements``
    (no call where it is there already), its gradient arriving at
    ``grad_placements`` (those placements by default)."""
    if tuple(x.placements) != tuple(placements):
        x = x.redistribute(x.device_mesh, placements)
    return x.to_local(grad_placements=grad_placements)


def local_shape_and_offset(shape, mesh, placements):
    """This rank's block of a ``shape`` tensor at ``placements``: its
    local shape and global offset, as DTensor cuts it. torch computes
    the offsets with tensors, which a ``FakeTensorMode`` (the dry-run's)
    would turn into values it cannot read, so they are computed outside
    any such mode."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    with unset_fake_temporarily():
        return compute_local_shape_and_global_offset(shape, mesh,
                                                     placements)


def plain_block(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """A plain tensor, the same on every rank, cut to this rank's block
    at ``placements`` as DTensor cuts it (no collective, no DTensor)."""
    shape, off = local_shape_and_offset(x.shape, mesh, placements)
    for d, (n, o) in enumerate(zip(shape, off)):
        if n != x.shape[d]:
            x = x.narrow(d, o, n)
    return x


def _leaves(tree) -> list:
    out = []
    tree_map_with_path(lambda _, x: out.append(x), tree)
    return out


def _tree_map(fn, tree):
    return tree_map_with_path(lambda _, x: fn(x), tree)


def local_rows(fn, rows: tuple, shared: tuple = ()):
    """``fn(*rows, *shared)`` on local tensors, for a computation that
    is independent per row (dim 0) of every tensor in ``rows``: attention
    over its heads, a recurrence over its sequence, MoE routing within a
    group, a loss over the vocabulary.

    With no DTensor among the inputs it is ``fn`` itself. Otherwise the
    rows split over the data axes ('pod', 'data') when those divide
    every row tensor's dim 0, and everything else (the other dims of the
    rows, the ``shared`` tensors, the 'model' axis) is gathered whole:
    each rank computes its rows exactly as one device computes them.
    Every tensor ``fn`` returns is a row tensor and comes back as a
    DTensor sharded so. ``shared`` tensors' gradients are partial over
    the axes the rows split on. (pytrees of tensors are accepted.)"""
    cls = dtensor_type()
    leaves = _leaves((rows, shared)) if cls is not None else []
    dts = [x for x in leaves if isinstance(x, cls)]
    if not dts:
        return fn(*rows, *shared)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = dts[0].device_mesh
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    dp = [i for i, n in enumerate(names) if n in ("pod", "data")]
    n_dp = math.prod(sizes[names[i]] for i in dp)
    row_leaves = [x for x in _leaves(rows) if isinstance(x, torch.Tensor)]
    split = dp if all(x.dim() and x.shape[0] % n_dp == 0
                      for x in row_leaves) else []
    rep = [Replicate()] * mesh.ndim
    at_rows = [Shard(0) if i in split else Replicate()
               for i in range(mesh.ndim)]
    grad_shared = [Partial() if i in split else Replicate()
                   for i in range(mesh.ndim)]

    def to_local(x, target, grad):
        if not isinstance(x, torch.Tensor):
            return x
        if not isinstance(x, cls):
            return plain_block(x, mesh, target)
        return local_at(x, target, grad)

    loc_rows = _tree_map(lambda x: to_local(x, at_rows, at_rows), rows)
    loc_shared = _tree_map(lambda x: to_local(x, rep, grad_shared), shared)
    out = fn(*loc_rows, *loc_shared)
    n_split = math.prod(sizes[names[i]] for i in split)

    def wrap(y):
        if not isinstance(y, torch.Tensor):
            return y
        shape = (y.shape[0] * n_split, *y.shape[1:])
        return cls.from_local(y, mesh, at_rows, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_strides(shape))

    return _tree_map(wrap, out)


def contiguous_strides(shape) -> tuple:
    strides, acc = [], 1
    for n in reversed(shape):
        strides.append(acc)
        acc *= n
    return tuple(reversed(strides))


def local_pointwise(fn, *xs):
    """``fn(*xs)`` for an elementwise ``fn`` over tensors of one shape, on
    local shards: with DTensors of one mesh and placements among ``xs``
    (0-dim replicated ones and plain scalars may ride along) ``fn`` runs
    on their local tensors, which is what DTensor itself would run, and
    each result comes back at the same placements. Without DTensors it
    is ``fn``."""
    cls = dtensor_type()
    if cls is None:
        return fn(*xs)
    first = next((x for x in xs if isinstance(x, cls) and x.dim()), None)
    if first is None:
        return fn(*xs)
    mesh, pl = first.device_mesh, tuple(first.placements)

    def local(x):
        if not isinstance(x, cls):
            return x
        if x.dim() and (tuple(x.placements) != pl or x.shape != first.shape):
            x = x.redistribute(mesh, pl)
        return x.to_local()

    out = fn(*(local(x) for x in xs))

    def wrap(y):
        return cls.from_local(y, mesh, pl, run_check=False,
                              shape=first.shape,
                              stride=contiguous_strides(first.shape))

    return tuple(wrap(y) for y in out) if isinstance(out, tuple) \
        else wrap(out)


def local_sum(x: torch.Tensor, fn) -> torch.Tensor:
    """``fn(x)``, a sum of elementwise terms of ``x`` to a 0-dim tensor,
    taken on local shards: each rank sums its shard and the partial sums
    add over the mesh dims that shard ``x`` (a replicated dim adds
    nothing). The result is a replicated 0-dim DTensor, or ``fn(x)``
    for a plain tensor."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    part = [Partial() if isinstance(p, Shard) else Replicate()
            for p in x.placements]
    s = dtensor_type().from_local(fn(x.to_local()), mesh, part,
                                  run_check=False)
    return s.redistribute(mesh, [Replicate()] * mesh.ndim)


def local_last_dim(fn, x: torch.Tensor, shared=(), rows=()):
    """``fn(x, *shared, *rows)`` for a computation along x's last dim
    alone (a norm, RoPE), its result shaped as ``x``: on a DTensor ``x``
    whose last dim is whole it runs on x's local block (a partial sum
    settled first) with ``shared`` (weights) gathered whole and ``rows``
    (positions, indexed by x's leading dims) cut as x is, and the result
    keeps x's placements; the weights' gradients are partial over the
    mesh dims that split x. Otherwise it is ``fn`` on what it is
    given."""
    cls = dtensor_type()
    if cls is None or not isinstance(x, cls):
        return fn(x, *shared, *rows)
    from torch.distributed.tensor import Partial, Replicate, Shard
    if any(isinstance(p, Shard) and p.dim == x.dim() - 1
           for p in x.placements):
        return fn(x, *shared, *rows)
    mesh = x.device_mesh
    if any(isinstance(p, Partial) for p in x.placements):
        # settle a pending sum first: carried through the norm's mean
        # it would round differently from one device
        x = x.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                  else p for p in x.placements])
    rep = [Replicate()] * mesh.ndim
    grad = [Partial() if isinstance(p, Shard) else Replicate()
            for p in x.placements]

    def local(w):
        if not isinstance(w, cls):
            return w
        return local_at(w, rep, grad)

    def row(r):
        at = [p if isinstance(p, Shard) and p.dim < r.dim() else Replicate()
              for p in x.placements]
        return local_at(r, at) if isinstance(r, cls) else \
            plain_block(r, mesh, at)

    y = fn(x.to_local(), *_tree_map(local, tuple(shared)),
           *(row(r) for r in rows))
    return cls.from_local(y, mesh, x.placements, run_check=False,
                          shape=x.shape, stride=contiguous_strides(x.shape))
