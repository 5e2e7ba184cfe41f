"""Plain PyTorch versions of the five kernels (no CUDA kernel anywhere).

Each function repeats the arithmetic of ``repro/kernels/ref.py`` on
torch tensors, on any device. The wrappers in ``kernels.qmm``,
``kernels.fused`` and ``kernels.mpmm`` take these for CPU tensors (the
CPU tests), and ``chip_smoke.py`` holds each CUDA kernel against them on
the card. Integer paths compute in int64 (or, for the FP-IP emulation,
the reference's own int32 limbs) so they are exact; ``torch.round``
rounds half to even like ``jnp.round``.
"""
from __future__ import annotations

import torch

from repro_torch.core import fixedpoint as fx, fp16 as fpmod, nibble
from repro_torch.core.ipu import (IPUConfig, NEG_INF_EXP, _shr_i32,
                                  accumulate, fp16_inner_product)
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


def mp_matmul_ref(a: torch.Tensor, b: torch.Tensor,
                  cfg: IPUConfig = IPUConfig()) -> torch.Tensor:
    """Oracle for the faithful mpmm kernel: the ``core.ipu`` inner product
    broadcast over (M, N). O(M*N*K) memory — test sizes only."""
    a = a.to(torch.float16)
    b = b.to(torch.float16)
    return fp16_inner_product(a[:, None, :], b.T[None], cfg)


def mp_matmul_blocked_ref(a: torch.Tensor, b: torch.Tensor,
                          cfg: IPUConfig = IPUConfig(), *,
                          fused: bool = False) -> torch.Tensor:
    """Blocked FP-IP matmul (the counterpart of the reference's
    ``mp_matmul_xla``): a loop over K-groups with (M, g, N) temporaries,
    K zero-padded to a multiple of g (value-neutral: a padded product has
    exponent -28, the least there is, and magnitude 0).

    ``fused=False``: the paper-faithful nine-plane datapath (bit-exact to
    :func:`mp_matmul_ref` / ``core.ipu``).
    ``fused=True``: the single-plane mode: full 22-bit mantissa
    products, EHU alignment against the group max, truncation on a
    w_f = min(w, 26)-bit fused datapath, group sums entering the
    accumulator with pre_shift = 1 + w_f - w.

    The nine updates of a group are applied at once
    (:func:`_group_update`), which gives the reference's value.
    """
    m, n = a.shape[0], b.shape[1]
    zero = torch.zeros((m, n), dtype=torch.int32, device=a.device)
    acc = fx.FX(zero, zero)
    exp_acc = torch.full((m, n), NEG_INF_EXP, dtype=torch.int32,
                         device=a.device)
    for mx, s_tree in _group_sums(a, b, cfg, fused):
        if fused:
            w_f = min(cfg.w, 26)
            acc, exp_acc = accumulate(acc, exp_acc, s_tree[0], mx,
                                      1 + w_f - cfg.w, torch.zeros_like(mx),
                                      cfg)
        else:
            acc, exp_acc = _group_update(acc, exp_acc, s_tree, mx, cfg)
    return fx.round_to_fp(acc, exp_acc, cfg.accum_format)


def _group_sums(a: torch.Tensor, b: torch.Tensor, cfg: IPUConfig,
                fused: bool):
    """Per K-group, in K order: the EHU's group max ``mx`` (m, n) and the
    adder-tree sums (9, m, n), ``[3*i + j]`` for plane pair (i, j), or
    (1, m, n) for the fused plane. K is zero-padded to a multiple of g
    (value-neutral: a padded product has exponent -28, the least there
    is, and magnitude 0)."""
    a = a.to(torch.float16)
    b = b.to(torch.float16)
    m, k = a.shape
    n = b.shape[1]
    g = cfg.n
    pad = -k % g
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    groups = a.shape[1] // g
    sa, ea, ma = fpmod.decompose(a, fpmod.FP16)
    sb, eb, mb = fpmod.decompose(b, fpmod.FP16)
    ea = ea.reshape(m, groups, g)
    eb = eb.reshape(groups, g, n)
    if fused:
        da = (sa * ma).reshape(m, groups, g)
        db = (sb * mb).reshape(groups, g, n)
    else:
        pa = torch.stack(nibble.fp16_planes(sa, ma)).reshape(3, m, groups, g)
        pb = torch.stack(nibble.fp16_planes(sb, mb)).reshape(3, groups, g, n)
    w_f = min(cfg.w, 26)
    for gi in range(groups):
        c = ea[:, gi, :, None] + eb[gi][None]            # (m, g, n)
        mx = torch.amax(c, dim=1)
        shift = mx[:, None, :] - c
        active = shift <= cfg.mask_threshold
        if fused:
            d = da[:, gi, :, None] * db[gi][None]        # |d| < 2**22
            rs = shift + (22 - w_f)  # < 0 -> exact left shift
            al = _shr_i32(d, torch.clamp(rs, min=0), cfg.rounding)
            al = al << torch.clamp(-rs, 0, max(w_f - 22, 0))
            al = torch.where(active, al, torch.zeros_like(al))
            yield mx, torch.sum(al, dim=1, dtype=torch.int32)[None]
            continue
        # plane i of A against plane j of B, all nine at once: (3, 3, m,
        # g, n) -> nine adder-tree sums (9, m, n)
        d = pa[:, None, :, gi, :, None] * pb[None, :, gi, None]
        al = _shr_i32(d << (cfg.w - 9), shift, cfg.rounding)
        al = torch.where(active, al, torch.zeros_like(al))
        yield mx, torch.sum(al, dim=3, dtype=torch.int32).reshape(9, m, n)


def _group_update(acc: fx.FX, exp_acc: torch.Tensor, s_tree: torch.Tensor,
                  mx: torch.Tensor, cfg: IPUConfig):
    """The nine accumulator updates of one K-group, ``s_tree[3*i + j]``
    the adder-tree sum of plane pair (i, j).

    Equal to ``core.ipu.accumulate`` applied to them in turn, in any
    order: only a group's first update can swap (afterwards exp_acc >=
    mx), the others' aligned sums depend on exp_acc and mx alone, and
    two-limb adds are exact integer adds. So the first update runs on
    the accumulator and the other eight, batched, on zero.
    """
    pre = [cfg.pre_shift(i, j) for i in range(3) for j in range(3)]
    zero = torch.zeros_like(mx)
    acc, exp_acc = accumulate(acc, exp_acc, s_tree[0], mx, pre[0], zero, cfg)
    rest, _ = accumulate(
        fx.zero_like(s_tree[1:]), exp_acc, s_tree[1:], mx,
        torch.tensor(pre[1:], dtype=torch.int32,
                     device=mx.device)[:, None, None], zero, cfg)
    return fx.canon(acc.hi + torch.sum(rest.hi, dim=0, dtype=torch.int32),
                    acc.lo + torch.sum(rest.lo, dim=0, dtype=torch.int32)), \
        exp_acc


def mp_matmul_fused_ref(a: torch.Tensor, b: torch.Tensor,
                        cfg: IPUConfig = IPUConfig()) -> torch.Tensor:
    """Oracle alias for the fused mpmm mode."""
    return mp_matmul_blocked_ref(a, b, cfg, fused=True)


def _shr64(v: torch.Tensor, s: torch.Tensor, rounding: str) -> torch.Tensor:
    """The two limbs' right shift on int64 (s >= 0): trunc shifts |v| and
    reapplies the sign, floor shifts arithmetically; 48 or more clears."""
    big = s >= 48
    s = torch.clamp(s, max=47)
    if rounding == "floor":
        return torch.where(big, torch.where(v < 0, -1, 0), v >> s)
    r = v.abs() >> s
    return torch.where(big, 0, torch.where(v < 0, -r, r))


def _align64(s_tree: torch.Tensor, net: torch.Tensor,
             rounding: str) -> torch.Tensor:
    """``core.ipu.accumulate``'s aligned sum on int64: an exact left shift
    (clamped at 23) where the net shift is negative, else ``_shr64``."""
    v = s_tree.to(torch.int64)
    left = v * (1 << torch.clamp(-net, 0, 23)).to(torch.int64)
    right = _shr64(v, torch.clamp(net, 0, 1 << 20).to(torch.int64), rounding)
    return torch.where(net < 0, left, right)


def mp_matmul_rounds_ref(a: torch.Tensor, b: torch.Tensor,
                         cfg: IPUConfig = IPUConfig(), *,
                         fused: bool = False, plan) -> torch.Tensor:
    """The decomposition ``csrc/mpmm.cu`` computes, in plain torch (tests
    only; equal, bit for bit, to :func:`mp_matmul_blocked_ref`).

    1. Prefix max: E_g = max(E_{g-1}, mx_g) from ``NEG_INF_EXP``.
    2. Per-group contributions: c_g = sum over planes p of s_p aligned by
       pre_p + (E_g - mx_g) - (33 - w), in int64; each depends on its
       group and on E_g alone.
    3. Record segments: a group is a record where mx_g > E_{g-1}, the
       one place the accumulator truncates (by E_g - E_{g-1}).
    4. Per-range lists: over the plan's rounds (``plan.ranges``), each
       rank's range becomes a list of (shift, segment sum), a new entry
       at each record (shift 0 for the part before the range's first
       record); a segment's groups are summed last to first, to show
       the order inside a segment does not matter.
    5. The ordered fold: the ranges' lists in K order, one ``_shr64``
       per record and one add per entry, then ``round_to_fp``.
    """
    m, n = a.shape[0], b.shape[1]
    k = a.shape[1]
    g = cfg.n
    w_f = min(cfg.w, 26)
    if fused:
        pre = torch.tensor([1 + w_f - cfg.w])
    else:
        pre = torch.tensor([cfg.pre_shift(i, j)
                            for i in range(3) for j in range(3)])
    pre = pre.to(a.device)[:, None, None]
    mxs, cs = [], []
    e = torch.full((m, n), NEG_INF_EXP, dtype=torch.int32, device=a.device)
    for mx, s_tree in _group_sums(a, b, cfg, fused):
        e = torch.maximum(e, mx)                                   # 1
        net = pre + (e - mx)[None] - (33 - cfg.w)
        cs.append(torch.sum(_align64(s_tree, net, cfg.rounding), dim=0))
        mxs.append(mx)                                             # 2
    acc = torch.zeros((m, n), dtype=torch.int64, device=a.device)
    e = torch.full((m, n), NEG_INF_EXP, dtype=torch.int32, device=a.device)
    for ranks in plan.ranges(k, g):
        for g0, g1 in ranks:
            entries = []                                           # 4
            for gi in range(g0, g1):
                rec = mxs[gi] > e                                  # 3
                shift = torch.where(rec, torch.clamp(mxs[gi] - e, max=63), 0)
                e = torch.maximum(e, mxs[gi])
                entries.append((shift, gi))
            if not entries:
                continue
            # entry j: the shift of the record that opens it and the
            # groups up to the next record, per output
            seg = torch.stack([(s > 0).to(torch.int64) for s, _ in entries])
            seg = torch.cumsum(seg, dim=0)                         # (L, m, n)
            top = seg.shape[0] + 1
            sums = torch.zeros((top, m, n), dtype=torch.int64,
                               device=a.device)
            shifts = torch.zeros((top, m, n), dtype=torch.int64,
                                 device=a.device)
            for j in reversed(range(len(entries))):
                shift, gi = entries[j]
                sums.scatter_add_(0, seg[j][None], cs[gi][None])
                # one record opens each entry: its shift, 0 elsewhere
                shifts.scatter_add_(0, seg[j][None],
                                    shift.to(torch.int64)[None])
            for j in range(top):                                   # 5
                acc = torch.where(shifts[j] > 0,
                                  _shr64(acc, shifts[j], cfg.rounding), acc)
                acc = acc + sums[j]
    hi = (acc >> fx.LIMB_BITS).to(torch.int32)
    lo = (acc & fx.LIMB_MASK).to(torch.int32)
    return fx.round_to_fp(fx.FX(hi, lo), e, cfg.accum_format)
