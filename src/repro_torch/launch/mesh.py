"""Device meshes (mirror of ``repro/launch/mesh.py``): functions, not
module constants, so importing this module touches no process group.

Single pod: 16 x 16 = 256 devices, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 devices, axes (pod, data, model): the
batch shards over (pod, data); parameters replicate across pods.

Each mesh is a ``torch.distributed.DeviceMesh`` from ``init_device_mesh``
with ``mesh_dim_names``, over the ranks of the default process group
(which the caller starts). The device type is CUDA unless the caller
passes ``device="cpu"`` (gloo ranks); a CUDA mesh needs the NCCL
backend and raises without it. A shape whose size is not the world size
raises naming both.

:func:`abstract_mesh` is the counterpart of ``jax.sharding.AbstractMesh``:
axis names and sizes only, enough for the sharding rules
(``parallel.sharding``), with no process group behind it.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

from repro_torch.device import DeviceLike, resolve_device


class AbstractMesh(NamedTuple):
    """A mesh's shape and axis names, without devices or a process
    group (``DeviceMesh``'s ``shape`` and ``mesh_dim_names``)."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def abstract_mesh(shape, names) -> AbstractMesh:
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} "
                         f"differ in length")
    return AbstractMesh(shape, names)


def make_mesh(shape, names, device: DeviceLike = None):
    """``init_device_mesh`` over the default process group's ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh {names} needs a started process group "
            f"(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} {names} needs "
                         f"{math.prod(shape)} ranks; the world size is "
                         f"{world}")
    backend = dist.get_backend()
    if dev.type == "cuda" and "nccl" not in str(backend):
        raise RuntimeError(f"a CUDA mesh needs the NCCL backend; the "
                           f"process group runs {backend!r}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def _axes(multi_pod: bool):
    return ("pod", "data", "model") if multi_pod else ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return make_mesh(shape, _axes(multi_pod), device)


def make_test_mesh(*, multi_pod: bool = False, device: DeviceLike = None):
    """Small mesh for the 8-rank tests."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    return make_mesh(shape, _axes(multi_pod), device)


def make_single_device_mesh(device: DeviceLike = None):
    return make_mesh((1, 1), ("data", "model"), device)
