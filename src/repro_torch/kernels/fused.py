"""Wrappers of the fused kernels over stored operands.

``fused_qmm`` (``csrc/qmm.cu``) replaces
``repro/kernels/fused.py::_fused_qmm_kernel``: exact int, bit-equal to
``ref.fused_qmm_ref``. ``fused_dequant_mm`` (``csrc/fused_dequant.cu``)
replaces ``::_fused_dequant_kernel``: any storage kind, per-channel or
per-group scales, f32 accumulation, equal to ``ref.fused_dequant_mm_ref``
up to the order of summation.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise. The static activation scale ``sa`` reaches
the kernels as a device pointer (a 0-d tensor), never through
``.item()``: the serving path would otherwise sync the host once per
projection. ``LAUNCHES`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.qmm import expect, on_cpu, stream_handle

LAUNCHES = {"fused_qmm": 0, "fused_dequant_mm": 0}

# storage kinds the kernels decode in-register, in the C enum's order
KINDS = ("int8", "int4", "int4_packed", "fp8", "fp4", "fp4_packed")
PACKED_KINDS = ("int4_packed", "fp4_packed")
ACTS = ("none", "qdq", "quant")
_STORAGE_DTYPE = {"int8": torch.int8, "int4": torch.int8,
                  "int4_packed": torch.int8, "fp8": torch.uint8,
                  "fp4": torch.uint8, "fp4_packed": torch.uint8}


def _stored_k(w: torch.Tensor, kind: str) -> int:
    return w.shape[0] * (2 if kind in PACKED_KINDS else 1)


def _scalar(sa, x: torch.Tensor) -> torch.Tensor:
    """The act scale as a 0-d f32 tensor on x's device (a Python number
    is copied over once; a tensor already there passes through)."""
    sa = torch.as_tensor(sa, dtype=torch.float32, device=x.device)
    if sa.numel() != 1:
        raise ValueError(f"sa must be a scalar, got shape {tuple(sa.shape)}")
    return sa.reshape(())


def _scales(sw: torch.Tensor) -> torch.Tensor:
    if sw.dtype != torch.float32:
        raise TypeError(f"sw: want torch.float32, got {sw.dtype}")
    return sw.reshape(1, -1) if sw.dim() == 1 else sw


def fused_qmm(x: torch.Tensor, w: torch.Tensor, sw: torch.Tensor, sa, *,
              kind: str = "int8") -> torch.Tensor:
    """Exact fused int matmul: (M, K) f32 acts x stored int8 rows
    (``int8``/``int4``) or (K//2, N) packed int4 bytes -> (M, N) f32.
    ``sw`` holds (N,) or (1, N) per-channel scales."""
    if kind not in ("int8", "int4", "int4_packed"):
        raise ValueError(f"fused_qmm takes int kinds, got {kind!r}")
    expect(x, "x", torch.float32)
    expect(w, "w", torch.int8)
    sw = _scales(sw)
    m, k = x.shape
    n = w.shape[1]
    if k != _stored_k(w, kind):
        raise ValueError(f"x {tuple(x.shape)} does not match stored "
                         f"{kind} weight {tuple(w.shape)}")
    if sw.shape != (1, n):
        raise ValueError(f"fused_qmm needs per-channel scales (1, {n}), "
                         f"got {tuple(sw.shape)}")
    sa = _scalar(sa, x)
    if on_cpu(x, w, sw, sa):
        return ref.fused_qmm_ref(x, w, sw, sa, kind=kind)
    from repro_torch.kernels import _build
    sw = sw.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out                    # an empty grid is not a launch
    lib = _build.library("qmm")
    with torch.cuda.device(x.device):
        err = lib.fused_qmm_launch(
            x.data_ptr(), w.data_ptr(), sw.data_ptr(), sa.data_ptr(),
            out.data_ptr(), m, n, k, int(kind == "int4_packed"),
            stream_handle(x))
    _build.check(err, "fused_qmm")
    LAUNCHES["fused_qmm"] += 1
    return out


def fused_dequant_mm(x: torch.Tensor, w: torch.Tensor, sw: torch.Tensor,
                     sa=None, *, kind: str = "int8",
                     act: str = "none") -> torch.Tensor:
    """General fused dequant matmul: (M, K) f32 acts x ANY stored kind ->
    (M, N) f32. ``sw``: (G, N) scales (G == 1 per-channel, G > 1 equal
    K-groups); ``sa``: scalar static act scale, used per ``act`` —
    'none' (ignored), 'qdq' (fake-quant grid) or 'quant' (int-valued
    acts, ``sa`` folded in at the end)."""
    if kind not in KINDS:
        raise ValueError(f"unknown storage kind {kind!r}")
    if act not in ACTS:
        raise ValueError(f"unknown act step {act!r}")
    expect(x, "x", torch.float32)
    expect(w, "w", _STORAGE_DTYPE[kind])
    sw = _scales(sw)
    m, k = x.shape
    n = w.shape[1]
    if k != _stored_k(w, kind):
        raise ValueError(f"x {tuple(x.shape)} does not match stored "
                         f"{kind} weight {tuple(w.shape)}")
    groups = sw.shape[0]
    if sw.dim() != 2 or sw.shape[1] != n or groups < 1 or k % groups:
        raise ValueError(f"scales {tuple(sw.shape)} do not split K={k} "
                         f"into equal groups over N={n}")
    if act != "none":
        if sa is None:
            raise ValueError(f"act={act!r} needs the static scale sa")
        sa = _scalar(sa, x)
    operands = (x, w, sw) if act == "none" else (x, w, sw, sa)
    if on_cpu(*operands):
        return ref.fused_dequant_mm_ref(x, w, sw, sa, kind=kind, act=act)
    from repro_torch.kernels import _build
    sw = sw.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out                    # an empty grid is not a launch
    lib = _build.library("fused_dequant")
    with torch.cuda.device(x.device):
        err = lib.fused_dequant_launch(
            x.data_ptr(), w.data_ptr(), sw.data_ptr(),
            sa.data_ptr() if act != "none" else None, out.data_ptr(),
            m, n, k, groups, KINDS.index(kind), ACTS.index(act),
            stream_handle(x))
    _build.check(err, "fused_dequant_mm")
    LAUNCHES["fused_dequant_mm"] += 1
    return out
