"""The three scoring axes of the planner, as cacheable eval points (the
port's copy of ``repro/autotune/objectives.py``).

Every function here is a module-level ``repro_torch.exp`` eval target
(referenced as ``"repro_torch.autotune.objectives:<fn>"``): primitives
in, JSON-serializable dict out, and an *explicit* ``seed`` parameter
that is part of the cache key — every sampled quantity (simulator
exponent draws, probe model init, probe tokens) derives from it, so
cached scores are bitwise identical between ``--jobs N`` and serial
runs.

Axes:
  * ``cycles_point``     — execution cycles of one projection group on
    the MC-IPU tile (``core.simulator``; numpy, no device).
  * ``efficiency_point`` — TOPS/mm^2 and TOPS/W of the candidate's
    hardware point on that workload (``core.area_power``; numpy).
  * ``accuracy_point``   — accuracy proxy: the Theorem-1 analytic bound
    (``core.error_bounds``) plus a fake-quant forward-divergence probe
    on the real (family-preserving reduced) model, run on the engine's
    ``device``. An fp16_ipu candidate below w = 28 probes through the
    bit-exact ``mp_matmul``.

The probe's weights and tokens: the reference draws both with
``jax.random``, which torch cannot repeat. Here both come from numpy
seeds: the weights from the model's init with ``draws="numpy"`` (the
reference's distributions), the tokens from
``models.registry.calibration_batch``. So every device and every torch
installation probes the same model, and they differ only by float
rounding, within ``PROBE_KL_RTOL`` and ``PROBE_KL_ATOL`` (the exp
engine's cache key names neither the device nor the installation).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from repro_torch.configs import get_config, reduced
from repro_torch.core import simulator as sim
from repro_torch.core.workloads import ConvLayer
from repro_torch.models.registry import ProjGroup, projection_groups

# the probe's KL on the same model, between two forwards that order
# their f32 sums differently (card and CPU, port and reference):
# |a - b| <= PROBE_KL_RTOL * b + PROBE_KL_ATOL. A KL of 1e-5 to 1e-2 is
# the small difference of two forwards, so a last-bit difference can
# flip a bf16 or an int8 rounding step (tests/test_torch_autotune.py)
PROBE_KL_RTOL = 0.1
PROBE_KL_ATOL = 2e-6

_TYPES = {"int4": sim.INT4, "int8": sim.INT8, "fp16_ipu": sim.FP16,
          "bf16": sim.FP16, "fp8": sim.FP8, "fp4": sim.FP4}


def _cfg(arch: str, shapes: str):
    if shapes == "reduced":
        return reduced(arch)
    if shapes == "full":
        return get_config(arch)
    raise ValueError(f"shapes must be 'full' or 'reduced', got {shapes!r}")


def _group(arch: str, group: str, shapes: str) -> ProjGroup:
    cfg = _cfg(arch, shapes)
    for g in projection_groups(cfg):
        if g.name == group:
            return g
    raise KeyError(f"{arch} has no projection group {group!r}")


def _layer(g: ProjGroup, seq: int) -> ConvLayer:
    # a matmul is the 1x1-conv special case: C=d_in, K=d_out, Ho=tokens
    return ConvLayer(g.name, c=g.d_in, k=g.d_out, ho=seq, wo=1, r=1, s=1,
                     count=g.count)


def _tile(mode: str, w: int, sw_precision: int,
          cluster: Optional[int]) -> sim.TileConfig:
    return dataclasses.replace(sim.BIG_TILE, adder_w=w,
                               cluster_size=cluster,
                               sw_precision=sw_precision)


def cycles_point(arch: str, group: str, mode: str, w: int,
                 sw_precision: int, cluster: int, seq: int = 1,
                 seed: int = 0, shapes: str = "full") -> Dict:
    """Cycles for one projection group under one candidate."""
    g = _group(arch, group, shapes)
    layer = _layer(g, seq)
    stats = sim.simulate_network(
        [layer], _tile(mode, w, sw_precision, cluster), _TYPES[mode],
        sim.FORWARD_SOURCE, seed=seed)
    return {"cycles": stats.cycles, "ideal_cycles": stats.ideal_cycles,
            "mc_factor": stats.slowdown, "macs": layer.macs}


def efficiency_point(arch: str, group: str, mode: str, w: int,
                     sw_precision: int, cluster: int, seq: int = 1,
                     seed: int = 0, shapes: str = "full") -> Dict:
    """TOPS/mm^2 and TOPS/W of the candidate's MC-IPU hardware point on
    this group's workload (area model needs the simulator-derived mean
    alignment cycles per iteration, so this point samples them too)."""
    from repro_torch.core import area_power as ap
    g = _group(arch, group, shapes)
    types = _TYPES[mode]
    tile = _tile(mode, w, sw_precision, cluster)
    mc = 1.0
    if types.is_fp and w < tile.sw_precision:
        stats = sim.simulate_network([_layer(g, seq)], tile, types,
                                     sim.FORWARD_SOURCE, seed=seed)
        mc = stats.slowdown
    design = ap.IPUDesign(
        f"plan_{mode}_w{w}", mult_a=4, mult_b=4, adder_w=w,
        fp_support=True, tile=tile,
        cluster_size=cluster if types.is_fp else None, fp_mc_factor=mc)
    tops = ap.throughput_tops(design, types)
    tops_mm2, tops_w = ap.efficiency(design, types)
    return {"tops": tops, "tops_per_mm2": tops_mm2, "tops_per_w": tops_w,
            "mc_factor": mc}


# --------------------------------------------------------------- accuracy

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


def _probe_policy_name(arch: str, group: str, mode: str, w: int,
                       sw_precision: int) -> str:
    return f"_probe/{arch}/{group}/{mode}/w{w}/p{sw_precision}"


def probe_inputs(cfg, seed: int = 0, probe_batch: int = 2,
                 probe_seq: int = 16, device=None):
    """The probe's (params, batch) for ``cfg`` on ``device``: the model's
    init drawn from numpy's seed ``seed`` and a numpy-seeded token batch
    (``registry.calibration_batch``), the same on every device and
    installation."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.models import registry

    device = resolve_device(device)
    params = registry.build(cfg).init(seed, device, draws="numpy")
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in registry.calibration_batch(
                 cfg, probe_batch, probe_seq, seed=seed).items()}
    return params, batch


def probe_policy(arch: str, group: str, mode: str, w: int,
                 sw_precision: int):
    """The transient policy of one probe: ``group`` of the reduced
    ``arch`` under the candidate (exact where ``exact_for`` says), every
    other path bf16."""
    from repro_torch.autotune.candidates import exact_for
    from repro_torch.autotune.plan import PlanRule
    from repro_torch.core.policy import PrecisionPolicy, PrecisionSpec

    g = _group(arch, group, "reduced")
    rule = PlanRule(group=g.name, pattern=g.pattern, mode=mode, w=w,
                    sw_precision=sw_precision, exact=exact_for(mode, w))
    return PrecisionPolicy(
        _probe_policy_name(arch, group, mode, w, sw_precision),
        rules=((g.pattern, rule.spec()),), default=PrecisionSpec("bf16"))


def probe_kl(cfg, params, batch, policy) -> float:
    """Mean token KL between the bf16 forward of ``batch`` on ``params``
    and the forward under ``policy`` (a ``PrecisionPolicy``; last-position
    logits of a prefill, f32), on the device the tensors live on. The
    policy is registered under its name for the forward only."""
    import torch

    from repro_torch.core.policy import POLICIES, register_policy
    from repro_torch.models import registry

    b, s = batch["tokens"].shape
    device = batch["tokens"].device

    def log_probs(policy_name: str):
        c = dataclasses.replace(cfg, precision_policy=policy_name)
        api = registry.build(c)
        logits, _ = api.prefill(params, batch, api.init_cache(b, s, device))
        return torch.log_softmax(logits.to(torch.float32), dim=-1)

    register_policy(policy)
    try:
        with torch.no_grad():
            base = log_probs("bf16")
            cand = log_probs(policy.name)
    finally:
        # probe policies are transient: never leave them resolvable (or
        # accumulating) in the global registry
        POLICIES.pop(policy.name, None)
    kl = torch.sum(torch.exp(base) * (base - cand), dim=-1)
    return float(torch.mean(kl))


def divergence_probe(arch: str, group: str, mode: str, w: int,
                     sw_precision: int, seed: int = 0,
                     probe_batch: int = 2, probe_seq: int = 16,
                     device=None) -> float:
    """Mean token KL between the bf16 reference forward and a forward
    with *only this group* flipped to the candidate, on the
    family-preserving reduced model — a measured, end-to-end sensitivity
    signal the analytic bound cannot provide. Runs on ``device`` (CUDA
    by default; raises without it unless ``device="cpu"``)."""
    cfg = reduced(arch)
    policy = probe_policy(arch, group, mode, w, sw_precision)
    params, batch = probe_inputs(cfg, seed, probe_batch, probe_seq, device)
    return probe_kl(cfg, params, batch, policy)


def accuracy_point(arch: str, group: str, mode: str, w: int,
                   sw_precision: int, seed: int = 0,
                   probe: bool = True, device: Optional[str] = None
                   ) -> Dict:
    """Accuracy proxy of one candidate on one group: analytic bound +
    (optionally) the measured forward-divergence probe. ``acc_proxy`` is
    what the search minimizes; additive across groups by construction.

    Deliberately takes no ``seq``/``shapes``: the probe always runs the
    reduced config at its own fixed shape, so those axes must not enter
    the cache key (they would orphan the expensive model probes). The
    engine passes ``device``, which is no part of the key either."""
    bound = analytic_proxy(mode, w, sw_precision)
    div = 0.0
    if probe and mode != "bf16":
        div = divergence_probe(arch, group, mode, w, sw_precision,
                               seed=seed, device=device)
    # measured divergence dominates; the analytic bound is a tiebreaker
    # between candidates the tiny probe cannot distinguish
    return {"bound_rel": bound, "divergence": div,
            "acc_proxy": div + 1e-3 * bound}
