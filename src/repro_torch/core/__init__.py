"""Core numerics of the mixed-precision IPU (the paper's contribution),
ported from ``repro/core`` as integer torch ops, and the precision policy.

Layers:
  fp16         - IEEE field codecs as int32 torch ops
  fixedpoint   - two-limb int32 accumulator arithmetic
  nibble       - 5-bit signed nibble temporal decomposition
  ehu          - exponent handling unit + MC-IPU schedule
  ipu          - bit-exact approximate FP-IP / MC-IPU / INT-mode emulation
  error_bounds - Theorem 1 bounds
  policy       - per-layer precision policies
  simulator    - cycle-accurate tile/cluster performance model (numpy)
  area_power   - calibrated 7nm area/power model (numpy)
  workloads    - ResNet/Inception/LM layer shape sets for the simulator

Importing this package does no CUDA work.
"""
from repro_torch.core.ipu import (  # noqa: F401
    IPUConfig,
    fp16_inner_product,
    fp16_inner_product_raw,
    int_inner_product,
)
from repro_torch.core.fp16 import FP16, FP32, BF16, TF32, FPFormat  # noqa: F401
