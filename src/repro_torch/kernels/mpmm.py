"""Wrapper of the FP-IP matmul kernel (``csrc/mpmm.cu``).

``mp_matmul`` replaces ``repro/kernels/mpmm.py::_mpmm_kernel`` together
with the ``round_to_fp`` epilogue the reference runs after it: the
paper's bounded-alignment approximate FP16 inner product (IPU(w)) at
matmul scale, bit-exact for every output element. On a CPU tensor it
runs its plain version (``ref.mp_matmul_blocked_ref``); on a CUDA tensor
it launches the kernel on the current stream or raises. ``LAUNCHES``
counts kernel launches, and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.core import fp16 as fpmod
from repro_torch.core.ipu import IPUConfig
from repro_torch.kernels import ref
from repro_torch.kernels.qmm import expect, on_cpu, stream_handle

LAUNCHES = {"mp_matmul": 0}


def check_config(cfg: IPUConfig) -> None:
    """The kernel is the plain FP16-operand IPU(w), as the reference's."""
    if cfg.multi_cycle:
        raise NotImplementedError(
            "kernel implements plain IPU(w); MC-IPU emulation is the "
            "core.ipu path (bit-different truncation points)")
    if cfg.operand != "fp16":
        raise NotImplementedError(
            "mpmm kernel is FP16-operand; BF16/TF32 run via core.ipu")


def mp_matmul(a: torch.Tensor, b: torch.Tensor,
              cfg: IPUConfig = IPUConfig(), *,
              fused: bool = False) -> torch.Tensor:
    """Approximate FP-IP matmul: (M, K) f16 x (K, N) f16 -> (M, N) in the
    accumulator format (f32, f16 or bf16). ``fused=False`` is the
    paper-faithful nine-plane datapath, ``fused=True`` the single-plane
    mode."""
    check_config(cfg)
    expect(a, "a", torch.float16)
    expect(b, "b", torch.float16)
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if on_cpu(a, b):
        return ref.mp_matmul_blocked_ref(a, b, cfg, fused=fused)
    from repro_torch.kernels import _build
    m, k = a.shape
    n = b.shape[1]
    fmt = cfg.accum_format
    out = torch.empty((m, n), dtype=fpmod.native_dtype(fmt), device=a.device)
    if m == 0 or n == 0:
        return out                    # an empty grid is not a launch
    lib = _build.library("mpmm")
    with torch.cuda.device(a.device):
        err = lib.mpmm_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, cfg.n,
            cfg.w, cfg.mask_threshold, int(fused),
            int(cfg.rounding == "floor"), fmt.exp_bits, fmt.mant_bits,
            stream_handle(a))
    _build.check(err, "mp_matmul")
    LAUNCHES["mp_matmul"] += 1
    return out
