"""Top-k Mixture-of-Experts with capacity-based GShard-style dispatch
(mirror of ``repro/layers/moe.py``).

Each sequence of a batch is its own routing group. The router runs in
f32 (the softmax is sensitive to it); the experts take the
mixed-precision policy at the path ``<path>/experts``: prepared storage
dequantizes, raw stacks under an int policy fake-quantize per expert
and out-channel on every call, and the expert products are bf16
einsums. Every expert stack is dequantized on every call, as in the
reference, not only the experts a token selected.

Two things the reference gets from JAX are spelled out here:

* ``jax.lax.top_k`` puts the lower index first among equal values;
  ``torch.topk`` promises no order, so the top k come from a stable
  descending sort.
* ``jax.nn.one_hot`` gives an all-zero row for an index past its width
  (a dropped queue position); ``torch.nn.functional.one_hot`` raises,
  so the one-hots here compare against an ``arange``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.layers.common import Generator, activation, dense_init
from repro_torch.parallel import act_sharding


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_expert: int
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    act: str = "silu"
    router_noise: float = 0.0
    # 'einsum': one-hot dispatch/combine products; 'gather': token ids
    # scattered into the (E, C) queues, activations gathered
    dispatch: str = "einsum"


def init(generator: Generator, cfg: MoEConfig, device,
         dtype=torch.float32, lead=()):
    """Router (d, E) in f32 whatever ``dtype``; experts stacked
    (E, d_in, d_out), each drawn as ``dense_init`` draws one weight."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_expert
    lead = tuple(lead)
    return {
        "router": {"w": dense_init(generator, d, e, device, torch.float32,
                                   lead)},
        "w_gate": {"w": dense_init(generator, d, f, device, dtype,
                                   lead + (e,))},
        "w_up": {"w": dense_init(generator, d, f, device, dtype,
                                 lead + (e,))},
        "w_down": {"w": dense_init(generator, f, d, device, dtype,
                                   lead + (e,))},
    }


def _capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    cap = int(cfg.capacity_factor * tokens_per_group * cfg.top_k
              / cfg.n_experts)
    return max(cap, cfg.top_k)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def route(params, cfg: MoEConfig, x):
    """The router's decisions for x (G, S, d): softmax probabilities
    (G, S, E) f32, expert ids (G, S, k), renormalized gates (G, S, k)
    f32 with dropped assignments zeroed, queue positions (G, S, k),
    ``fits`` (G, S, k) and the capacity."""
    b, s, _ = x.shape
    cap = _capacity(s, cfg)
    logits = torch.matmul(x.to(torch.float32),
                          params["router"]["w"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = vals[..., :cfg.top_k], ids[..., :cfg.top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    # position of each (token, k) in its expert's queue: a running count
    # over the s-major flattened (S * k) assignments of the group
    onehot = _one_hot(expert_ids, cfg.n_experts, torch.int32)
    flat = onehot.reshape(b, s * cfg.top_k, cfg.n_experts)
    pos_in_expert = (torch.cumsum(flat, dim=1, dtype=torch.int32)
                     - flat).reshape(b, s, cfg.top_k, cfg.n_experts)
    pos = (pos_in_expert * onehot).sum(-1, dtype=torch.int32)
    fits = pos < cap
    gate_vals = gate_vals * fits
    return probs, expert_ids, gate_vals, pos, fits, cap


def expert_weights(w, spec) -> torch.Tensor:
    """One expert stack as the products take it: prepared storage
    dequantized (bit-exact to the dynamic value), a raw stack under an
    int spec fake-quantized per expert and out-channel, else as is."""
    from repro_torch.layers.mplinear import note_weight_quant
    from repro_torch.quant.prepare import PreparedWeight
    from repro_torch.quant.quantize import fake_quant
    if isinstance(w, PreparedWeight):
        return w.dequant()
    if spec.weight_bits:
        note_weight_quant()
        return fake_quant(w.to(torch.float32), spec.weight_bits, axis=-2)
    return w


def forward(params, cfg: MoEConfig, x, policy, path: str):
    """x: (G, S, d) -> (y (G, S, d) in x's dtype, aux f32), aux being
    the Switch load-balancing loss.

    On a mesh (DTensor ``x``) routing with dispatch, and the combine,
    run per group on local tensors (``act_sharding.local_rows``: groups
    over the data axes); the dispatched (G, E, C, d) activations are
    pinned to groups over the data axes and experts over 'model', as the
    reference pins them, and each rank runs its own experts with their
    weights whole but for the expert axis (:func:`_on_expert_shards`).
    The aux loss takes its means over every group."""
    dt = x.dtype
    xe, probs, chosen, *how = act_sharding.local_rows(
        lambda xl, rl: _dispatch({"router": rl}, cfg, xl), (x,),
        (params["router"],))
    xe = act_sharding.constrain(xe, act_sharding.DP, act_sharding.MDL)
    spec = policy.spec_for(f"{path}/experts")
    ye = _on_expert_shards(
        lambda xe, *w: _experts(cfg, spec, xe, *w), xe,
        [params[n]["w"] for n in ("w_gate", "w_up", "w_down")])
    y = act_sharding.local_rows(lambda ye, *h: _combine(cfg, dt, ye, *h),
                                (ye, *how))
    # Switch load-balancing loss: E * sum(frac_tokens * frac_probs)
    frac_tokens = chosen.to(torch.float32).mean((0, 1))
    frac_probs = probs.mean((0, 1))
    aux = cfg.n_experts * torch.sum(frac_tokens * frac_probs)
    return y, aux


def _dispatch(params, cfg: MoEConfig, x):
    """Route x (G, S, d) and dispatch it to the experts' queues ->
    (xe (G, E, C, d), router probabilities (G, S, E), chosen experts
    (G, S, E) bool, and what the combine takes: the combine weights
    (G, S, E, C), or for ``"gather"`` the expert ids, queue slots,
    gates and ``fits``)."""
    b, s, d = x.shape
    k, e = cfg.top_k, cfg.n_experts
    probs, expert_ids, gate_vals, pos, fits, cap = route(params, cfg, x)
    g_idx = torch.arange(b, device=x.device)[:, None, None]
    chosen = _one_hot(expert_ids, e, torch.int32).sum(2) > 0

    if cfg.dispatch == "gather":
        s_ids = torch.arange(s, dtype=torch.int32, device=x.device)[
            None, :, None].expand(b, s, k)
        # dropped assignments all land on the overflow slot ``cap``,
        # which is sliced off: which of them wins there does not matter
        pos_safe = torch.where(fits, pos, torch.full_like(pos, cap))
        sidx = torch.full((b, e, cap + 1), -1, dtype=torch.int32,
                          device=x.device)
        sidx[g_idx.expand(b, s, k), expert_ids, pos_safe.long()] = s_ids
        sidx = sidx[:, :, :cap]                               # (G, E, C)
        valid = sidx >= 0
        xe = x[g_idx, torch.clamp(sidx, min=0).long()]        # (G, E, C, d)
        xe = torch.where(valid[..., None], xe, torch.zeros_like(xe))
        return xe, probs, chosen, expert_ids, pos_safe, gate_vals, fits
    disp = (_one_hot(expert_ids, e, x.dtype)[..., None]
            * _one_hot(pos, cap, x.dtype)[..., None, :]
            * fits[..., None, None].to(x.dtype))              # (G,S,k,E,C)
    combine = (disp * gate_vals[..., None, None].to(x.dtype)).sum(2)
    disp = disp.sum(2)                                        # (G, S, E, C)
    xe = torch.einsum("gsd,gsec->gecd", x, disp)              # (G, E, C, d)
    return xe, probs, chosen, combine


def _experts(cfg: MoEConfig, spec, xe, w_gate, w_up, w_down):
    """The gated experts on xe (G, E, C, d) -> ye (G, E, C, d) bf16."""
    fn = activation(cfg.act)
    wg, wu, wd = (expert_weights(w, spec) for w in (w_gate, w_up, w_down))
    bf16 = torch.bfloat16
    xb = xe.to(bf16)
    g = torch.einsum("gecd,edf->gecf", xb, wg.to(bf16))
    u = torch.einsum("gecd,edf->gecf", xb, wu.to(bf16))
    h = fn(g.to(torch.float32)).to(bf16) * u
    return torch.einsum("gecf,efd->gecd", h, wd.to(bf16))


def _combine(cfg: MoEConfig, dtype, ye, *how):
    """ye (G, E, C, d) back to the tokens' order -> y (G, S, d)."""
    if cfg.dispatch == "gather":
        expert_ids, pos_safe, gate_vals, fits = how
        b, s, k = expert_ids.shape
        e, cap, d = ye.shape[1:]
        flat = (expert_ids * cap + torch.clamp(pos_safe, 0, cap - 1)
                ).reshape(b, -1).long()                       # (G, S*k)
        yk = torch.take_along_dim(ye.reshape(b, e * cap, d), flat[..., None],
                                  dim=1).reshape(b, s, k, d)
        gatesz = (gate_vals * fits).to(ye.dtype)
        return torch.einsum("gskd,gsk->gsd", yk, gatesz).to(dtype)
    (combine,) = how
    return torch.einsum("gecd,gsec->gsd", ye.to(dtype), combine)


def _on_expert_shards(fn, xe, weights):
    """``fn(xe, *weights)``; on a DTensor ``xe`` (groups over the data
    axes, experts over 'model') on each rank's block, each weight (E,
    d_in, d_out) cut to that rank's experts and gathered whole along
    its other dims. The weights' gradients are partial over the mesh
    dims that split the groups."""
    if not act_sharding.is_dtensor(xe):
        return fn(xe, *weights)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    xe_to, w_to, w_grad = [], [], []
    for p in xe.placements:
        by_expert = isinstance(p, Shard) and p.dim == 1
        by_group = isinstance(p, Shard) and p.dim == 0
        xe_to.append(p if by_expert or by_group else Replicate())
        w_to.append(Shard(0) if by_expert else Replicate())
        w_grad.append(Partial() if by_group else w_to[-1])
    ye = fn(act_sharding.local_at(xe, xe_to),
            *(act_sharding.local_at(w, w_to, w_grad)
              if act_sharding.is_dtensor(w) else w for w in weights))
    shape = (*xe.shape[:-1], ye.shape[-1])
    return DTensor.from_local(ye, xe.device_mesh, xe_to, run_check=False,
                              shape=torch.Size(shape),
                              stride=act_sharding.contiguous_strides(shape))
