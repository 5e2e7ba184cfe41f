"""Wrappers of the exact int kernels (``csrc/qmm.cu``).

``qmm`` replaces ``repro/kernels/qmm.py::_qmm_kernel`` and
``qmm_packed`` replaces ``::_qmm_packed_kernel``. On a CPU tensor each
wrapper runs its plain version (``kernels.ref``); on a CUDA tensor it
launches the kernel on the current stream or raises. ``LAUNCHES`` counts
kernel launches, and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

LAUNCHES = {"qmm": 0, "qmm_packed": 0}


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; raises on a mix of
    devices or a device the kernels do not take."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) > 1:
            raise ValueError("operands lie on different CUDA devices")
        return False
    raise ValueError(f"operands must all lie on the CPU or all on one CUDA "
                     f"device, got {sorted(kinds)}")


def expect(t: torch.Tensor, name: str, dtype, ndim: int = 2):
    if t.dtype != dtype:
        raise TypeError(f"{name}: want {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: want {ndim}-d, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes contiguous tensors")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_qmm(a, b, packed: bool):
    from repro_torch.kernels import _build
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if m == 0 or n == 0:
        return out                    # an empty grid is not a launch
    lib = _build.library("qmm")
    with torch.cuda.device(a.device):
        err = lib.qmm_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                             m, n, k, int(packed), stream_handle(a))
    _build.check(err, "qmm_packed" if packed else "qmm")
    LAUNCHES["qmm_packed" if packed else "qmm"] += 1
    return out


def qmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact."""
    expect(a, "a", torch.int8)
    expect(b, "b", torch.int8)
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if on_cpu(a, b):
        return ref.qmm_ref(a, b)
    return _launch_qmm(a, b, packed=False)


def qmm_packed(a: torch.Tensor, b_packed: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 activations x (K//2, N) packed int4 bytes -> int32."""
    expect(a, "a", torch.int8)
    expect(b_packed, "b_packed", torch.int8)
    if a.shape[1] != 2 * b_packed.shape[0]:
        raise ValueError(f"packed contraction mismatch {tuple(a.shape)} x "
                         f"{tuple(b_packed.shape)} (want K == 2 * K/2)")
    if on_cpu(a, b_packed):
        return ref.qmm_ref(a, ref.unpack_int4_ref(b_packed))
    return _launch_qmm(a, b_packed, packed=True)
