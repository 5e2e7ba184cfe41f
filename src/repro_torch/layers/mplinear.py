"""Mixed-precision linear layer (mirror of ``repro/layers/mplinear.py``).

Every model projection routes through :func:`mp_linear`; its
``PrecisionSpec`` picks the executor from a registry keyed on
``(mode, variant)``. The 'fused' variant (:func:`executor_variant`)
sends prepared int8/int4/fp8/fp4 storage straight into the fused
kernels; a mode without that variant, or a projection that is not
fusable (no prepared storage, no calibrated act scale), falls back to
the base executor by the reference's own rules. Those rules choose an
executor; they are not a device fallback: on CUDA every kernel call
launches the hand-written kernel.

``count_weight_quant`` / ``count_act_quant`` count dynamic weight and
activation quantizations on the Python calls made while open (the
weight count also takes each weight ``quant.prepare`` quantizes);
``collect_act_stats`` records each projection's input absmax eagerly
(calibration; one host sync per projection, only while open).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.policy import PrecisionSpec
from repro_torch.kernels import ops as kops
from repro_torch.layers.common import Generator, dense_init
from repro_torch.parallel.act_sharding import contiguous_strides, is_dtensor
from repro_torch.quant.prepare import PreparedWeight
from repro_torch.quant.quantize import (FP_FORMATS, fake_quant, fp_dequantize,
                                        fp_quantize, quantize_symmetric)

_EXECUTORS: Dict[Tuple[str, Optional[str]], Callable] = {}
_EXECUTOR_VARIANT: Optional[str] = None


def register_executor(*modes: str, variant: Optional[str] = None):
    """Register ``fn(w, x, spec, compute_dtype) -> y`` for policy modes
    (optionally as a named variant of them)."""
    def deco(fn):
        for m in modes:
            _EXECUTORS[(m, variant)] = fn
        return fn
    return deco


def executor_for(mode: str, variant: Optional[str] = None) -> Callable:
    if variant is not None:
        fn = _EXECUTORS.get((mode, variant))
        if fn is not None:
            return fn
    try:
        return _EXECUTORS[(mode, None)]
    except KeyError:
        known = sorted({m for m, v in _EXECUTORS if v is None})
        raise ValueError(f"no executor registered for precision mode "
                         f"{mode!r} (known: {known})") from None


@contextlib.contextmanager
def executor_variant(name: Optional[str]):
    """Route every ``mp_linear`` call made while open through the named
    executor variant (modes without it keep their base executor)."""
    global _EXECUTOR_VARIANT
    prev = _EXECUTOR_VARIANT
    _EXECUTOR_VARIANT = name
    try:
        yield
    finally:
        _EXECUTOR_VARIANT = prev


_WEIGHT_QUANT_COUNT: Optional[List[int]] = None
_ACT_QUANT_COUNT: Optional[List[int]] = None
_ACT_STATS: Optional[Dict[str, float]] = None


@contextlib.contextmanager
def count_weight_quant():
    """Count weight quantizations while open: the dynamic ones of a
    forward over raw weights and the ones ``quant.prepare`` makes
    (prepared weights hit neither)."""
    global _WEIGHT_QUANT_COUNT
    prev, _WEIGHT_QUANT_COUNT = _WEIGHT_QUANT_COUNT, [0]
    try:
        yield _WEIGHT_QUANT_COUNT
    finally:
        _WEIGHT_QUANT_COUNT = prev


def note_weight_quant(n: int = 1):
    if _WEIGHT_QUANT_COUNT is not None:
        _WEIGHT_QUANT_COUNT[0] += n


@contextlib.contextmanager
def count_act_quant():
    """Count dynamic activation-scale calibrations (per-call absmax
    reduces) while open (calibrated containers never hit it)."""
    global _ACT_QUANT_COUNT
    prev, _ACT_QUANT_COUNT = _ACT_QUANT_COUNT, [0]
    try:
        yield _ACT_QUANT_COUNT
    finally:
        _ACT_QUANT_COUNT = prev


def note_act_quant(n: int = 1):
    if _ACT_QUANT_COUNT is not None:
        _ACT_QUANT_COUNT[0] += n


@contextlib.contextmanager
def collect_act_stats():
    """Yield {policy path -> running input absmax} recorded by every
    ``mp_linear`` call while open."""
    global _ACT_STATS
    prev = _ACT_STATS
    stats: Dict[str, float] = {}
    _ACT_STATS = stats
    try:
        yield stats
    finally:
        _ACT_STATS = prev


def _note_act_absmax(path: Optional[str], x: torch.Tensor):
    if _ACT_STATS is None or path is None:
        return
    amax = float(torch.max(torch.abs(x.to(torch.float32))))
    _ACT_STATS[path] = max(_ACT_STATS.get(path, 0.0), amax)


def _dot_f32(x: torch.Tensor, w: torch.Tensor, dt) -> torch.Tensor:
    """``jnp.dot(x.astype(dt), w.astype(dt), preferred_element_type=f32)``:
    operands rounded to ``dt``, products and sums in f32, f32 out. A
    DTensor ``w`` (a head on a mesh) multiplies on local shards with K
    whole (:func:`on_local_shards`)."""
    if is_dtensor(w):
        return on_local_shards(w, x, lambda wl, xl: _dot_f32(xl, wl, dt))
    return torch.matmul(x.to(dt).to(torch.float32),
                        w.to(dt).to(torch.float32))


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x.f32 @ w.f32`` (a decay LoRA); a DTensor ``w`` multiplies on
    local shards with K whole (:func:`on_local_shards`)."""
    if is_dtensor(w):
        return on_local_shards(w, x, lambda wl, xl: matmul_f32(xl, wl))
    return x.to(torch.float32) @ w.to(torch.float32)


@register_executor("bf16", "fp32")
def _dense_executor(w, x, spec: PrecisionSpec, compute_dtype):
    dt = torch.bfloat16 if spec.mode == "bf16" else torch.float32
    wf = w.dequant() if isinstance(w, PreparedWeight) else w
    return _dot_f32(x, wf, dt)


@register_executor("int8", "int4")
def _int_executor(w, x, spec: PrecisionSpec, compute_dtype):
    bits = spec.weight_bits
    prepared = isinstance(w, PreparedWeight) and w.weight_bits == bits
    act_scale = w.act_scale if prepared else None
    if not spec.exact:
        if prepared and w.staged:
            wq = w.data
        elif prepared:
            wq = w.dequant()
        else:
            note_weight_quant()
            wraw = w.dequant() if isinstance(w, PreparedWeight) else w
            wq = fake_quant(wraw.to(torch.float32), bits, axis=0)
        if act_scale is None:
            note_act_quant()
        xq = fake_quant(x.to(torch.float32), 8, scale=act_scale)
        return _dot_f32(xq, wq, compute_dtype)
    if prepared and w.staged:
        raise ValueError("staged containers carry dequantized operands; "
                         "exact integer kernels need int storage")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if act_scale is None:
        note_act_quant()
        aq, sa = quantize_symmetric(x2, 8, axis=1)
        sa = sa[:, 0]
    else:
        aq, sa = quantize_symmetric(x2, 8, scale=act_scale)
    if prepared and w.scale_groups > 1:
        # per-group scales vary along K: the fused dequant kernel takes
        # the stored operand and the act scale rides outside
        y = kops.fused_dequant_matmul(aq.to(torch.float32), w.data, w.scale,
                                      None, kind=w.kind)
        y = y * (sa[:, None] if sa.dim() else sa)
    elif prepared and w.kind == "int4_packed":
        y = kops.quantized_matmul_packed(aq, w.data, sa, w.scale.reshape(-1))
    elif prepared:
        y = kops.quantized_matmul(aq, w.data, sa, w.scale.reshape(-1))
    else:
        note_weight_quant()
        wraw = w.dequant() if isinstance(w, PreparedWeight) else w
        wq, sw = quantize_symmetric(wraw, bits, axis=0)
        y = kops.quantized_matmul(aq, wq, sa, sw[0, :])
    return y.reshape(*lead, -1)


_FP_STORAGE_KINDS = ("fp8", "fp4", "fp4_packed", "staged_fp8", "staged_fp4")


@register_executor("fp8", "fp4")
def _fp_executor(w, x, spec: PrecisionSpec, compute_dtype):
    """Weight-only fp8/fp4 storage: codes dequantize to the compute
    dtype; activations ride through unquantized."""
    if isinstance(w, PreparedWeight) and w.kind in _FP_STORAGE_KINDS:
        wf = w.data if w.staged else w.dequant()
    else:
        note_weight_quant()
        wraw = w.dequant() if isinstance(w, PreparedWeight) else w
        fmt = FP_FORMATS[spec.mode]
        codes, s = fp_quantize(wraw.to(torch.float32), fmt, axis=0)
        wf = fp_dequantize(codes, s, fmt)
    return _dot_f32(x, wf, compute_dtype)


@register_executor("int8", "int4", variant="fused")
def _int_fused_executor(w, x, spec: PrecisionSpec, compute_dtype):
    """Fused int datapath: stored int8 rows / packed nibbles + scales
    enter the kernel, the calibrated static act scale quantizes
    in-register. Falls back to the base executor without prepared
    storage or without a calibrated scale."""
    bits = spec.weight_bits
    fusable = (isinstance(w, PreparedWeight) and w.weight_bits == bits
               and not w.staged and w.act_scale is not None
               and w.data.dim() == 2)
    if not fusable:
        return _int_executor(w, x, spec, compute_dtype)
    lead = x.shape[:-1]
    x2 = x.to(torch.float32).reshape(-1, x.shape[-1])
    sa = w.act_scale
    if spec.exact and w.scale_groups == 1:
        y = kops.fused_quantized_matmul(x2, w.data, w.scale, sa, kind=w.kind)
    elif spec.exact:
        y = kops.fused_dequant_matmul(x2, w.data, w.scale, sa, kind=w.kind,
                                      act="quant")
    else:
        y = kops.fused_dequant_matmul(x2, w.data, w.scale, sa, kind=w.kind,
                                      act="qdq")
    return y.reshape(*lead, -1)


@register_executor("fp8", "fp4", variant="fused")
def _fp_fused_executor(w, x, spec: PrecisionSpec, compute_dtype):
    """Fused fp8/fp4 datapath; raw/staged weights take the base one."""
    fusable = (isinstance(w, PreparedWeight)
               and w.kind in ("fp8", "fp4", "fp4_packed")
               and w.data.dim() == 2)
    if not fusable:
        return _fp_executor(w, x, spec, compute_dtype)
    lead = x.shape[:-1]
    x2 = x.to(torch.float32).reshape(-1, x.shape[-1])
    y = kops.fused_dequant_matmul(x2, w.data, w.scale, None, kind=w.kind,
                                  act="none")
    return y.reshape(*lead, -1)


@register_executor("fp16_ipu")
def _fp16_ipu_executor(w, x, spec: PrecisionSpec, compute_dtype):
    if isinstance(w, PreparedWeight) and w.kind == "fp16":
        w16 = w.data
    else:
        note_weight_quant()
        wraw = w.dequant() if isinstance(w, PreparedWeight) else w
        w16 = wraw.to(torch.float16)
    if not spec.exact:
        return _dot_f32(x, w16, torch.float16)
    lead = x.shape[:-1]
    x2 = x.to(torch.float16).reshape(-1, x.shape[-1])
    y = kops.mp_matmul(x2, w16, spec.ipu)
    return y.to(torch.float32).reshape(*lead, -1)


def linear_init(generator: Generator, d_in: int, d_out: int,
                bias: bool, device, dtype=torch.float32, lead=()):
    """``{"w": (*lead, d_in, d_out)[, "b": zeros (*lead, d_out)]}``."""
    p = {"w": dense_init(generator, d_in, d_out, device, dtype, lead)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


def on_local_shards(w, x: torch.Tensor, fn: Callable,
                    columns=()) -> torch.Tensor:
    """``fn(w_local, x_local, *columns_local)`` for a DTensor weight
    ``w`` (d_in, d_out) and activations ``x`` (..., d_in), as a DTensor;
    ``columns`` (a bias) lie along d_out and are cut as its columns.

    The hand-written kernels take plain tensors, and the paper's
    bounded-alignment product folds K in order, so K is never split:
    ``w`` is gathered whole along d_in and keeps d_out sharded over
    'model' where its rule shards it; ``x`` is gathered whole along
    d_in, and along 'model' where ``w`` keeps d_out there, and keeps
    its row dims sharded elsewhere. Each rank then computes a block of
    the product exactly as one device computes it, and the result
    carries x's row placements and w's d_out placement. Gradients flow:
    w's local gradient is partial over the mesh dims that split x's
    rows, x's over the dims that split d_out."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.parallel.act_sharding import local_at
    mesh = w.device_mesh
    nd = x.dim()
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    w_to, x_to, w_grad, x_grad, y_at = [], [], [], [], []
    for name, wp, xp in zip(mesh.mesh_dim_names, w.placements,
                            x.placements):
        keep_n = (name == "model" and isinstance(wp, Shard)
                  and wp.dim == w.dim() - 1)
        row = (not keep_n and isinstance(xp, Shard) and xp.dim < nd - 1)
        w_to.append(Shard(w.dim() - 1) if keep_n else Replicate())
        x_to.append(xp if row else Replicate())
        w_grad.append(Partial() if row else w_to[-1])
        x_grad.append(Partial() if keep_n else x_to[-1])
        y_at.append(Shard(nd - 1) if keep_n else x_to[-1])
    col_to = [Shard(0) if isinstance(p, Shard) else Replicate()
              for p in w_to]
    col_grad = [Partial() if isinstance(p, Partial) else c
                for p, c in zip(w_grad, col_to)]
    y = fn(local_at(w, w_to, w_grad), local_at(x, x_to, x_grad),
           *(local_at(c, col_to, col_grad) for c in columns))
    shape = (*x.shape[:-1], w.shape[-1])
    return DTensor.from_local(y, mesh, y_at, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def mp_linear(params, x: torch.Tensor, spec: PrecisionSpec,
              compute_dtype=torch.bfloat16,
              path: Optional[str] = None) -> torch.Tensor:
    """y = x @ w (+ b) under the precision spec. x: (..., d_in).
    ``path`` keys the calibration hook's statistics. A DTensor weight
    (a sharded model) runs the executor on local shards
    (:func:`on_local_shards`): the kernels see plain tensors with K
    whole, so every projection equals the same projection on one
    device."""
    _note_act_absmax(path, x)
    executor = executor_for(spec.mode, _EXECUTOR_VARIANT)
    b = params.get("b")

    def linear(w, x, *b):
        y = executor(w, x, spec, compute_dtype)
        if b:
            y = y + b[0].to(y.dtype)
        return y.to(compute_dtype)

    w = params["w"]
    if is_dtensor(w):
        return on_local_shards(w, x, linear, () if b is None else (b,))
    return linear(w, x, *(() if b is None else (b,)))
