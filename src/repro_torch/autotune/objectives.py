"""The planner's accuracy objective, the part the router shares (a copy
of ``analytic_proxy`` from ``repro/autotune/objectives.py``; the
planner's throughput and divergence objectives are not ported yet)."""
from __future__ import annotations

import math


def analytic_proxy(mode: str, w: int, sw_precision: int) -> float:
    """First-order relative-error scale of the datapath (dimensionless).
    Also the accuracy axis of the serving router's replica cost model
    (``repro_torch.serving.router.replica_cost``)."""
    if mode == "bf16":
        # bf16's own 8-bit mantissa rounding noise
        return 2.0 ** -8 / math.sqrt(12.0)
    if mode in ("int4", "int8"):
        bits = 4 if mode == "int4" else 8
        # symmetric absmax fake-quant: step ~ 2^(1-bits), RMS step/sqrt(12)
        return 2.0 ** (1 - bits) / math.sqrt(12.0)
    if mode in ("fp8", "fp4"):
        # fp storage codecs: the relative step of the mantissa grid is
        # 2^-(man_bits+1) at the bin midpoint; RMS step/sqrt(12)
        man = 3 if mode == "fp8" else 1
        return 2.0 ** -(man + 1) / math.sqrt(12.0)
    # fp16_ipu: Theorem-1 FP-IP bound at unit product scale, relative to
    # the n-product sum, plus fp16's own mantissa noise floor
    from repro_torch.core.error_bounds import fp_ip_bound
    n = 16
    bound = float(fp_ip_bound(min(w, sw_precision), max_exp=0, n=n)) / n
    return bound + 2.0 ** -11 / math.sqrt(12.0)
