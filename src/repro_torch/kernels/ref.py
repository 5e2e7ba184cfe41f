"""Plain PyTorch versions of the four kernels (no CUDA kernel anywhere).

Each function repeats the arithmetic of ``repro/kernels/ref.py`` on
torch tensors, on any device. The wrappers in ``kernels.qmm`` and
``kernels.fused`` take these for CPU tensors (the CPU tests), and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
Integer paths compute in int64 so they are exact; ``torch.round``
rounds half to even like ``jnp.round``.
"""
from __future__ import annotations

import torch

from repro_torch.quant.quantize import FP4_E2M1, FP8_E4M3, fp_decode


def qmm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> int32 exact matmul (int64 accumulation: |sum| <
    K * 2^14, far inside int32 for every K the models use)."""
    if a.device.type == "cpu":
        acc = a.to(torch.int64) @ b.to(torch.int64)
    else:
        # CUDA has no int64 matmul: f64 products and sums of int8 values
        # are exact while |sum| < 2^53
        acc = (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64)
    return acc.to(torch.int32)


def pack_int4_ref(w: torch.Tensor) -> torch.Tensor:
    """(..., K, N) int8 in [-8, 7] -> (..., K//2, N) bytes
    ``(w[2k+1] << 4) | (w[2k] & 0xF)``."""
    lo = w[..., 0::2, :].to(torch.int32) & 0xF
    hi = w[..., 1::2, :].to(torch.int32) & 0xF
    return ((hi << 4) | lo).to(torch.uint8).view(torch.int8)


def unpack_int4_ref(packed: torch.Tensor) -> torch.Tensor:
    """Both nibbles sign-extended: low ``((p & 0xF) ^ 8) - 8``, high an
    arithmetic ``>> 4``."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = p >> 4
    k2, n = packed.shape[-2:]
    out = torch.stack([lo, hi], dim=-2)
    return out.reshape(*packed.shape[:-2], 2 * k2, n).to(torch.int8)


def pack_u4_ref(codes: torch.Tensor) -> torch.Tensor:
    """UNSIGNED 4-bit codes (fp4 e2m1 bit fields) -> bytes, same layout
    as :func:`pack_int4_ref`."""
    lo = codes[..., 0::2, :].to(torch.int32) & 0xF
    hi = codes[..., 1::2, :].to(torch.int32) & 0xF
    return ((hi << 4) | lo).to(torch.uint8)


def unpack_u4_ref(packed: torch.Tensor) -> torch.Tensor:
    """Both nibbles masked, never sign-extended."""
    p = packed.to(torch.int32)
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    k2, n = packed.shape[-2:]
    out = torch.stack([lo, hi], dim=-2)
    return out.reshape(*packed.shape[:-2], 2 * k2, n).to(torch.uint8)


def quantize_act_ref(x: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / sa), -128, 127)`` in f32."""
    return torch.clamp(torch.round(x.to(torch.float32) / sa), -128.0, 127.0)


def fused_qmm_ref(x: torch.Tensor, w: torch.Tensor, sw: torch.Tensor,
                  sa: torch.Tensor, *, kind: str = "int8") -> torch.Tensor:
    """Static-scale activation quantize, exact int32 matmul, epilogue
    ``acc * sa * sw`` in that order."""
    sa = torch.as_tensor(sa, dtype=torch.float32, device=x.device)
    aq = quantize_act_ref(x, sa)
    wq = unpack_int4_ref(w) if kind == "int4_packed" else w
    acc = qmm_ref(aq.to(torch.int8), wq)
    return (acc.to(torch.float32) * sa
            * sw.reshape(-1)[None, :].to(torch.float32))


def decode_weight_ref(w: torch.Tensor, kind: str) -> torch.Tensor:
    """Stored operand of any kind -> f32 values (packed kinds double K)."""
    if kind == "int4_packed":
        return unpack_int4_ref(w).to(torch.float32)
    if kind == "fp4_packed":
        return fp_decode(unpack_u4_ref(w), FP4_E2M1)
    if kind in ("fp8", "fp4"):
        return fp_decode(w, FP8_E4M3 if kind == "fp8" else FP4_E2M1)
    if kind in ("int8", "int4"):
        return w.to(torch.float32)
    raise ValueError(f"unknown storage kind {kind!r}")


def fused_dequant_mm_ref(x: torch.Tensor, w: torch.Tensor, sw: torch.Tensor,
                         sa=None, *, kind: str = "int8",
                         act: str = "none") -> torch.Tensor:
    """Decode storage to f32, broadcast (G, N) scales over their
    K-groups, optional activation step against ``sa``, f32 matmul."""
    wf = decode_weight_ref(w, kind)
    sw = sw.to(torch.float32)
    if sw.dim() == 1:
        sw = sw.reshape(1, -1)
    k, n = wf.shape
    groups = sw.shape[0]
    wf = (wf.reshape(groups, k // groups, n) * sw[:, None, :]).reshape(k, n)
    xf = x.to(torch.float32)
    if act != "none":
        sa = torch.as_tensor(sa, dtype=torch.float32, device=x.device)
        xf = quantize_act_ref(xf, sa)
        if act == "qdq":
            xf = xf * sa
    y = xf @ wf
    return y * sa if act == "quant" else y
