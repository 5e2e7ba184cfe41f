"""Roofline terms of a traced program (mirror of
``repro/launch/roofline.py``; no card needed):

    compute term    = FLOPs / (chips * peak FLOP/s)
    memory term     = bytes / (chips * HBM bytes/s)
    collective term = collective bytes / (chips * link bytes/s)

The reference reads FLOPs and bytes from XLA's cost analysis and the
collectives from the compiled HLO's text. torch has no HLO: the port
counts what the program issues as it runs (``launch.dryrun`` runs it on
fake tensors). :class:`CollectiveRecorder` is a ``TorchDispatchMode``
that sees every collective on local tensors (``c10d.*`` as
``torch.distributed`` issues them, ``_c10d_functional.*`` as DTensor
does) and adds its per-rank link bytes: the per-rank payload (an
all-gather's output bytes divided by its group's size, any other's
input bytes) times the ring factor of its group's size, as the
reference's ``parse_collectives`` weighs each HLO collective.

Hardware constants: one NVIDIA H100 SXM (the port's card), from its
data sheet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core FLOP/s
PEAK_FLOPS = 989e12
# the same data sheet: HBM3 bytes/s
HBM_BW = 3.35e12
# one NDR 400 Gb/s InfiniBand port per card (the DGX H100's one
# ConnectX-7 port per GPU): every axis of a 16x16 mesh crosses nodes
# of 8 cards
LINK_BW = 50e9


def _ring_factor(op: str, group: int) -> float:
    """Per-chip link traffic as a multiple of the (per-chip) payload,
    assuming ring algorithms: all-reduce moves 2(n-1)/n, gather/scatter
    (n-1)/n, all-to-all (n-1)/n, permute 1."""
    if group <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (group - 1) / group
    if op == "collective-permute":
        return 1.0
    return (group - 1) / group


@dataclasses.dataclass
class CollectiveStats:
    total_bytes: float = 0.0            # per-chip link bytes
    by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    count: int = 0

    def add(self, op: str, nbytes: float):
        self.total_bytes += nbytes
        self.by_op[op] = self.by_op.get(op, 0.0) + nbytes
        self.count += 1


# the collectives the recorder weighs, by op name (namespace.name)
COLLECTIVES = {
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
}


def _op_name(func) -> str:
    return f"{func.namespace}.{func._opname}"


def _nbytes(x) -> int:
    """Bytes of the tensors in ``x`` (a tensor, or lists and tuples of
    them and of other values)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def _bound(func, args, kwargs) -> Dict:
    """{argument name: value} of an op call, by its schema."""
    named = dict(kwargs)
    for a, v in zip(func._schema.arguments, args):
        named[a.name] = v
    return named


def _first(named, *keys):
    return next(named[k] for k in keys if k in named)


def _group_size(named) -> int:
    if "process_group" in named:     # a boxed ProcessGroup
        import torch.distributed as dist
        return int(dist.ProcessGroup.unbox(named["process_group"]).size())
    if "group_size" in named:
        return int(named["group_size"])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return int(_resolve_process_group(named["group_name"]).size())


def collective_bytes(func, args, kwargs, out) -> Optional[Tuple[str, float,
                                                                  int]]:
    """``(op, per-rank link bytes, group size)`` of a collective op
    call, ``None`` for any other op. The payload is an all-gather's
    gathered bytes over the group's size, an all-reduce's tensors, a
    reduce-scatter's or all-to-all's input."""
    name = _op_name(func)
    op = COLLECTIVES.get(name)
    if op is None:
        return None
    named = _bound(func, args, kwargs or {})
    group = _group_size(named)
    if op == "all-gather":
        gathered = out if name.startswith("_c10d_functional.") else \
            _first(named, "output_tensors", "output_tensor", "outputs")
        payload = _nbytes(gathered) / group
    else:
        payload = _nbytes(_first(named, "tensors", "input_tensors",
                                 "input_tensor", "inputs", "input"))
    return op, payload * _ring_factor(op, group), group


class CollectiveRecorder(TorchDispatchMode):
    """Records every collective issued on local tensors while open, in
    ``stats`` (a :class:`CollectiveStats`). An op on DTensors is left to
    DTensor (``NotImplemented``), which issues its collectives on local
    tensors, seen here. DTensor's sharding propagation may run ops on
    tensors of a fake mode of its own: those are not the program's and
    are skipped, as ``MemTracker`` skips them."""

    def __init__(self):
        super().__init__()
        self.stats = CollectiveStats()
        self._entry_mode = None

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._entry_mode = active_fake_mode()
        return super().__enter__()

    def _is_program_op(self) -> bool:
        from torch._guards import active_fake_mode
        return active_fake_mode() is self._entry_mode

    def record(self, func, args, kwargs, out):
        hit = collective_bytes(func, args, kwargs, out)
        if hit is not None:
            self.stats.add(hit[0], hit[1])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._is_program_op():
            self.record(func, args, kwargs, out)
        return out


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # global (all chips)
    hlo_bytes: float            # global HBM traffic
    collective_bytes: float     # global link traffic
    model_flops: float
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / bound time: how close the dominant term
        lets us get to the MODEL_FLOPS roofline."""
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        bound = max(self.compute_s, self.memory_s, self.collective_s)
        return ideal / bound if bound > 0 else 0.0

    @property
    def flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: the useful fraction of the
        program's compute (catches remat and replicated work)."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    def to_dict(self) -> Dict:
        return {**dataclasses.asdict(self),
                "bottleneck": self.bottleneck,
                "roofline_fraction": self.roofline_fraction,
                "flops_ratio": self.flops_ratio}


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D train (N active params, D tokens); 2*N*D
    prefill; 2*N per decoded token x batch."""
    n = cfg.active_params_count()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch  # one decode step


def terms_from_counts(arch: str, shape, mesh_name: str, chips: int,
                      per_dev_flops: float, per_dev_bytes: float,
                      coll: CollectiveStats, cfg) -> RooflineTerms:
    """The terms of a program from one rank's counts (the reference's
    ``terms_from_compiled`` with the counts in place of XLA's cost
    analysis and HLO): every rank runs the same program, so the global
    figures are the per-rank ones times ``chips``."""
    return RooflineTerms(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops=per_dev_flops * chips,
        hlo_bytes=per_dev_bytes * chips,
        collective_bytes=coll.total_bytes * chips,
        model_flops=model_flops(cfg, shape),
        compute_s=per_dev_flops / PEAK_FLOPS,
        memory_s=per_dev_bytes / HBM_BW,
        collective_s=coll.total_bytes / LINK_BW,
    )
