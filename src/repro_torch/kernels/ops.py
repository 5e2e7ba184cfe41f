"""Public wrappers around the kernels (mirror of ``repro/kernels/ops.py``).

``backend`` selection, per call:

  * ``'kernel'`` (default) — the hand-written CUDA kernel for CUDA
    tensors; the plain PyTorch version for CPU tensors (the kernels have
    no interpret mode). This is what the serving path calls.
  * ``'ref'`` — the plain PyTorch version (``kernels.ref``) on any
    device: the counterpart of the reference's ``backend='xla'``, used
    by the tests and by ``chip_smoke.py`` to hold each kernel against it.
    The serving path never selects it.

The quantized-matmul wrappers fold per-channel scales in an epilogue,
the way ``layers.mplinear`` consumes them.
"""
from __future__ import annotations

import torch

from repro_torch.core.ipu import IPUConfig
from repro_torch.kernels import fused as _fused
from repro_torch.kernels import mpmm as _mpmm
from repro_torch.kernels import qmm as _qmm
from repro_torch.kernels import ref as _ref

BACKENDS = ("kernel", "ref")


def _check_backend(backend: str):
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")


def pack_int4(w: torch.Tensor) -> torch.Tensor:
    """Pack (..., K, N) int4-valued int8 weights into (..., K//2, N)
    bytes (two nibbles per byte along the contraction dim)."""
    if w.shape[-2] % 2:
        raise ValueError("K must be even to pack nibbles")
    return _ref.pack_int4_ref(w)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    return _ref.unpack_int4_ref(packed)


def pack_u4(codes: torch.Tensor) -> torch.Tensor:
    """Pack (..., K, N) UNSIGNED 4-bit codes (fp4 e2m1 bit fields);
    unpacking never sign-extends."""
    if codes.shape[-2] % 2:
        raise ValueError("K must be even to pack nibbles")
    return _ref.pack_u4_ref(codes)


def unpack_u4(packed: torch.Tensor) -> torch.Tensor:
    return _ref.unpack_u4_ref(packed)


def int8_matmul(a: torch.Tensor, b: torch.Tensor, *,
                backend: str = "kernel") -> torch.Tensor:
    """(M,K) int8 x (K,N) int8 -> (M,N) int32."""
    _check_backend(backend)
    if backend == "ref":
        return _ref.qmm_ref(a, b)
    return _qmm.qmm(a.contiguous(), b.contiguous())


def int4_matmul_packed(a: torch.Tensor, b_packed: torch.Tensor, *,
                       backend: str = "kernel") -> torch.Tensor:
    """(M,K) int8 activations x (K//2,N) packed int4 weights -> int32."""
    _check_backend(backend)
    if backend == "ref":
        return _ref.qmm_ref(a, _ref.unpack_int4_ref(b_packed))
    return _qmm.qmm_packed(a.contiguous(), b_packed.contiguous())


def _scale_epilogue(acc: torch.Tensor, scale_a, scale_b: torch.Tensor
                    ) -> torch.Tensor:
    """Fold activation/weight scales into the int32 accumulator.
    ``scale_a`` is per-row (M,) or a 0-d static scale."""
    scale_a = torch.as_tensor(scale_a, dtype=torch.float32,
                              device=acc.device)
    if scale_a.dim():
        scale_a = scale_a[:, None]
    return (acc.to(torch.float32) * scale_a
            * scale_b[None, :].to(torch.float32))


def quantized_matmul(a_q, b_q, scale_a, scale_b, *,
                     backend: str = "kernel") -> torch.Tensor:
    """Dequantizing matmul: int8/int4-valued operands with per-row or
    scalar activation scales and per-column (N,) weight scales -> f32."""
    return _scale_epilogue(int8_matmul(a_q, b_q, backend=backend),
                           scale_a, scale_b)


def quantized_matmul_packed(a_q, b_packed, scale_a, scale_b, *,
                            backend: str = "kernel") -> torch.Tensor:
    """The same epilogue over prepared nibble-packed weights."""
    return _scale_epilogue(int4_matmul_packed(a_q, b_packed,
                                              backend=backend),
                           scale_a, scale_b)


def fused_quantized_matmul(x, w, sw, sa, *, kind: str = "int8",
                           backend: str = "kernel") -> torch.Tensor:
    """Fused exact-int matmul over STORED operands: f32 activations
    quantized in-register against the static scale ``sa``, int32
    accumulation on int8 rows or packed int4, fused per-channel scale
    epilogue. Bit-exact to ``quantize_symmetric(x, 8, scale=sa)`` +
    ``quantized_matmul[_packed]``."""
    _check_backend(backend)
    if backend == "ref":
        return _ref.fused_qmm_ref(x, w, sw, sa, kind=kind)
    return _fused.fused_qmm(x.contiguous(), w.contiguous(), sw, sa,
                            kind=kind)


def fused_dequant_matmul(x, w, sw, sa=None, *, kind: str = "int8",
                         act: str = "none",
                         backend: str = "kernel") -> torch.Tensor:
    """General fused dequant matmul: any storage kind with per-channel
    ((1, N)) or per-group ((G, N)) scales; the optional activation step
    (``act``: 'none' | 'qdq' | 'quant') fuses against ``sa``."""
    _check_backend(backend)
    if backend == "ref":
        return _ref.fused_dequant_mm_ref(x, w, sw, sa, kind=kind, act=act)
    return _fused.fused_dequant_mm(x.contiguous(), w.contiguous(), sw, sa,
                                   kind=kind, act=act)


def mp_matmul(a, b, cfg: IPUConfig = IPUConfig(), *, fused: bool = False,
              backend: str = "kernel") -> torch.Tensor:
    """Approximate FP-IP matmul (the fidelity path): operands cast to f16,
    (M, K) x (K, N) -> the accumulator format. ``fused=False`` is the
    paper-faithful nine-plane datapath, ``fused=True`` the single-plane
    mode. ``backend='ref'`` runs the plain blocked version, which (as the
    reference's ``backend='xla'``) takes any config; the kernel refuses
    MC-IPU and non-fp16 operands."""
    _check_backend(backend)
    a = a.to(torch.float16).contiguous()
    b = b.to(torch.float16).contiguous()
    if backend == "ref":
        return _ref.mp_matmul_blocked_ref(a, b, cfg, fused=fused)
    return _mpmm.mp_matmul(a, b, cfg, fused=fused)


_COUNTS = (_qmm.LAUNCHES, _fused.LAUNCHES, _mpmm.LAUNCHES)


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    return {k: v for counts in _COUNTS for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for k in counts:
            counts[k] = 0


def add_launch_counts(delta: dict, tables=_COUNTS) -> None:
    """Add ``delta`` (kernel name -> launches, negative to take some
    back) to the count tables that hold those names. The engine's
    program cache (``serving.graphs``) calls it: a CUDA graph's capture
    moves the counts but launches nothing, and each replay launches what
    the capture recorded."""
    for name, n in delta.items():
        table = next((t for t in tables if name in t), None)
        if table is None:
            raise KeyError(f"no launch count named {name!r}")
        table[name] += n
