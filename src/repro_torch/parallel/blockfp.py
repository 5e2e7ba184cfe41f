"""Bounded-alignment block-FP compressed collectives (mirror of
``repro/parallel/blockfp.py``; beyond the paper).

The paper's insight that exponent differences within a group of FP
values are almost always small (Fig. 9), applied to the roofline's
collective term: gradients are quantized per block of 256 values to a
shared max exponent and w-bit aligned mantissas (the IPU's EHU and
local-shift arithmetic, on the port's ``core.fp16`` fields), exchanged
as int8 and dequantized. Cross-pod gradient traffic drops about 4x for
w = 8 against f32.

Semantics: the compressed sum adds *quantized* values, so the result is
sum(Q(g)); each value's truncation is under one ULP of its block scale
2^(max_e - w + 1), as in Theorem 1.

The codec is bit for bit the reference's (``mant`` and ``exp`` int8),
with one difference inside the reference: its scale is ``jnp.exp2`` of
an integer-valued f32, which XLA computes inexactly (off by up to 4e-6
relative for most exponents, and 0 at 2^-126 and below). The port's
scale is the exact power of two, built from its bit fields, so the
dequantized values are ``np.ldexp(mant, exp - (w - 2))`` on every
device (``ROADMAP.md`` §3).

``make_pod_exchange`` is the explicit cross-pod exchange of
hierarchical data parallelism over a ``DeviceMesh`` with a 'pod' axis:
the reference's fully manual ``shard_map`` becomes a body on each
DTensor's local shard (``to_local``), its collectives over the mesh's
'pod' process group (NCCL on a CUDA mesh, gloo on a CPU one), and its
results re-wrapped with ``DTensor.from_local``. Int8 goes on the wire.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import fp16 as fpmod

BLOCK = 256


def blockfp_quantize(x: torch.Tensor, w: int = 8, block: int = BLOCK):
    """-> (mant int8, exp int8, orig_len). Per-block shared max exponent
    (EHU stages 1-2), mantissas aligned to it and truncated to w bits
    (local shift and truncate): the IPU alignment datapath."""
    if not 2 <= w <= 8:
        raise ValueError(f"w must be in 2..8, not {w}")
    flat = x.to(torch.float32).reshape(-1)
    n = flat.numel()
    pad = -n % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    _, e, m = fpmod.decompose(blocks, fpmod.FP32)  # mag 24 bits
    sign = torch.where(blocks < 0, -1, 1).to(torch.int32)
    max_e = torch.where(m > 0, e, -(1 << 20)).amax(-1, keepdim=True)
    max_e = max_e.clamp_min(fpmod.FP32.min_exp)
    shift = max_e - e
    # keep the top (w-1) magnitude bits of the aligned value
    mant = m >> (shift + (24 - (w - 1))).clamp_max(31)
    mant = (sign * mant).to(torch.int8)
    return mant, max_e[:, 0].to(torch.int8), n


def pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e as float32, exact, for integer ``e`` in -149..127: the bit
    pattern itself (a normal's exponent field, or a subnormal's one
    mantissa bit), so every device gives the same bits."""
    e = e.to(torch.int32)
    normal = (e + 127).clamp_min(0) << 23
    sub = torch.ones_like(e) << (e + 149).clamp(0, 22)
    return torch.where(e >= fpmod.FP32.min_exp, normal, sub).view(
        torch.float32)


def blockfp_dequantize(mant: torch.Tensor, exp: torch.Tensor, n: int,
                       w: int, shape, block: int = BLOCK) -> torch.Tensor:
    scale = pow2(exp.to(torch.int32) - (w - 2))[:, None]
    vals = mant.to(torch.float32) * scale
    return vals.reshape(-1)[:n].reshape(shape)


def _all_max(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(group size, *t.shape): every participant's ``t``, in rank order
    (``dist.all_gather``, which torch 2.11 and 2.13 both keep)."""
    import torch.distributed as dist
    out = t.new_empty((dist.get_world_size(group),) + tuple(t.shape))
    dist.all_gather(list(out.unbind(0)), t.contiguous(), group=group)
    return out


def compressed_psum(x: torch.Tensor, group, w: int = 8) -> torch.Tensor:
    """Sum of blockfp-quantized values over the ranks of ``group``.

    Wire-honest: the exchange is an all-gather of INT8 mantissas (after
    an int32 all-reduce of each block's exponent max); an all-reduce
    would put int32 on the wire (int8 sums overflow). For an n-way
    ring, all-gather(int8) moves (n-1)/n * 1 B a value against
    all-reduce(f32)'s 2(n-1)/n * 4 B; the sum happens locally."""
    mant, exp, n = blockfp_quantize(x, w)
    # align block scales across participants (a small int32 collective)
    gmax = _all_max(exp.to(torch.int32), group)
    adj = (gmax[:, None] - exp.to(torch.int32)[:, None]).clamp_max(31)
    mant_al = (mant.to(torch.int32) >> adj).to(torch.int8)
    gathered = _all_gather(mant_al, group)   # int8 on the wire
    total = gathered.to(torch.int32).sum(0)
    return blockfp_dequantize(total, gmax.to(torch.int8), n, w, x.shape)


def int8_psum(x: torch.Tensor, group) -> torch.Tensor:
    """Per-tensor int8 compressed sum (absmax scale), with the same
    wire-honest gather and local reduce."""
    scale = torch.clamp_min(x.abs().max(), 1e-20) / 127.0
    scale = _all_max(scale, group)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    gathered = _all_gather(q, group)
    return gathered.to(torch.int32).sum(0).to(x.dtype) * scale


def compress_grads(grads, group, method: str):
    from repro_torch.optim.tree import tree_map
    if method == "blockfp8":
        fn = lambda g: compressed_psum(g.to(torch.float32), group, 8)  # noqa
    elif method == "int8":
        fn = lambda g: int8_psum(g.to(torch.float32), group)  # noqa
    else:
        raise ValueError(method)
    return tree_map(fn, grads)


def make_pod_exchange(mesh, grad_shapes, method: str = "blockfp8",
                      fsdp_spec_fn: Optional[Callable] = None):
    """Cross-pod gradient-exchange program (hierarchical DP).

    Each pod runs its own SPMD train program producing pod-local
    gradients; this program is the explicit exchange between pods, the
    only cross-pod collective. Gradients arrive stacked along a leading
    pod axis (shape (n_pods, ...) placed at ``('pod', *base)``, ``base``
    the leaf's ``param_pspec`` or ``fsdp_spec_fn(path, shape, mesh)``)
    and leave pod-averaged and pod-replicated, shape (1, ...) at
    ``(None, *base)``. The 256-value blocks (and ``int8_psum``'s absmax)
    are formed on each rank's local shard, flattened row-major, as the
    reference's ``shard_map`` forms them on each device's.

    ``method``: 'f32' (baseline all-gather exchange), 'int8',
    'blockfp8'. Returns ``(fn, in_shardings, out_shardings)``, the last
    two trees of ``NamedSharding``; ``fn(grads)`` takes DTensors at
    ``in_shardings`` (plain tensors, the same on every rank, are placed
    there first) and returns DTensors at ``out_shardings``. Every rank
    of the mesh calls it.
    """
    from repro_torch.parallel import sharding as shd

    if method not in ("f32", "int8", "blockfp8"):
        raise ValueError(method)
    n_pods = shd.axis_sizes(mesh)["pod"]
    group = mesh.get_group("pod")

    def base_of(path, leaf):
        shape = tuple(leaf.shape)[1:]
        return tuple(fsdp_spec_fn(path, shape, mesh) if fsdp_spec_fn
                     else shd.param_pspec(path, shape, mesh))

    in_sh = shd.tree_map_with_path(
        lambda p, l: shd.NamedSharding(mesh, ("pod",) + base_of(p, l)),
        grad_shapes)
    out_sh = shd.tree_map_with_path(
        lambda p, l: shd.NamedSharding(mesh, (None,) + base_of(p, l)),
        grad_shapes)

    def leaf_exchange(g):
        g = g / n_pods
        if method == "f32":
            return _all_gather(g.to(torch.float32), group).sum(0).to(g.dtype)
        if method == "int8":
            return int8_psum(g.to(torch.float32), group).to(g.dtype)
        return compressed_psum(g.to(torch.float32), group, 8).to(g.dtype)

    def one(g, sh_in, sh_out):
        from torch.distributed.tensor import DTensor
        g = shd.place(g, sh_in)
        local = leaf_exchange(g.to_local())
        shape = torch.Size((1,) + tuple(g.shape)[1:])
        return DTensor.from_local(
            local, mesh, sh_out.placements, run_check=False, shape=shape,
            stride=torch.empty(shape, device="meta").stride())

    def fn(grads):
        return shd.zip_map(lambda g, pair: one(g, *pair), grads,
                           shd.zip_map(lambda a, b: (a, b), in_sh, out_sh))

    return fn, in_sh, out_sh
