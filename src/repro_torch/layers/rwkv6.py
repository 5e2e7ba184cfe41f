"""RWKV-6 "Finch" time-mix and channel-mix layers (mirror of
``repro/layers/rwkv6.py``).

Time mix (per head, head size N):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (S: N x N state)
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with the data-dependent decay w_t = exp(-exp(ww_t)) from a LoRA on the
token-shifted input. Prefill runs the reference's chunked form (its
``lax.scan`` over chunks is a Python loop here, op for op in the same
order); decode is the O(1) recurrence. The projections take the
precision policy; the recurrence and the decay LoRA run in f32 on raw
weights (never TF32 on the card: ``chip_smoke.py`` asserts it).

The state is written IN PLACE (the reference returns new arrays):
``time_mix``, ``time_mix_step`` and ``channel_mix`` copy the new state
into the :class:`RWKVState` tensors they are given and return that same
state, so a captured CUDA graph that reads the state by address replays
on live state (``serving/graphs.py``). Training passes
``write_state=False``: the state it starts from is a fresh zero that
autograd keeps for backward (and a checkpointed region reads again when
it recomputes), so ``time_mix`` and ``channel_mix`` then leave it as it
is and return the new state in new tensors, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.layers.common import Generator, dense_init, randn
from repro_torch.layers.mplinear import linear_init, matmul_f32, mp_linear
from repro_torch.parallel import act_sharding


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    d_model: int
    n_heads: int
    d_ff: int
    lora_rank: int = 32
    chunk: int = 64

    @property
    def head_dim(self):
        return self.d_model // self.n_heads


class RWKVState(NamedTuple):
    s: torch.Tensor         # (B, H, N, N) f32 wkv state
    x_prev_t: torch.Tensor  # (B, d) last input of time mix (token shift)
    x_prev_c: torch.Tensor  # (B, d) last input of channel mix


def init(generator: Generator, cfg: RWKVConfig, device,
         dtype=torch.float32, lead=()):
    """Seeded random parameters with the reference's tree and
    distributions (not its bits); ``lead`` stacks layers."""
    d, h, n = cfg.d_model, cfg.n_heads, cfg.head_dim

    def lin(d_in, d_out):
        return linear_init(generator, d_in, d_out, False, device, dtype, lead)

    def full(value):
        return torch.full((*lead, d), value, dtype=dtype, device=device)

    p = {
        "w_r": lin(d, d), "w_k": lin(d, d), "w_v": lin(d, d),
        "w_g": lin(d, d), "w_o": lin(d, d),
        "mu": {k: full(0.5) for k in ("r", "k", "v", "g", "w")},
        "w_lora_a": dense_init(generator, d, cfg.lora_rank, device, dtype,
                               lead),
        "w_lora_b": dense_init(generator, cfg.lora_rank, d, device, dtype,
                               lead),
        "w_bias": full(-6.0),
        "u": (randn((*lead, h, n), generator, device) * 0.1).to(dtype),
        "c_key": lin(d, cfg.d_ff), "c_val": lin(cfg.d_ff, d),
        "c_rec": lin(d, d),
        "c_mu": {k: full(0.5) for k in ("k", "r")},
    }
    return p


def init_state(batch: int, cfg: RWKVConfig, device, dtype=torch.float32,
               lead=()) -> RWKVState:
    """Zero state (real tensors, one per stacked layer, never a
    broadcast view: the state is written in place)."""
    h, n = cfg.n_heads, cfg.head_dim
    return RWKVState(
        s=torch.zeros((*lead, batch, h, n, n), dtype=torch.float32,
                      device=device),
        x_prev_t=torch.zeros((*lead, batch, cfg.d_model), dtype=dtype,
                             device=device),
        x_prev_c=torch.zeros((*lead, batch, cfg.d_model), dtype=dtype,
                             device=device))


def _token_shift(x, x_prev):
    """x: (B, S, d); x_prev: (B, d) -> shifted (B, S, d), new x_prev."""
    return torch.cat([x_prev[:, None].to(x.dtype), x[:, :-1]], 1), x[:, -1]


def _mix(x, shifted, mu):
    return x + (shifted - x) * mu.to(x.dtype)


def _projections(params, cfg: RWKVConfig, x, shifted, policy, path):
    b, s, d = x.shape
    h, n = cfg.n_heads, cfg.head_dim
    mu = params["mu"]
    xr = _mix(x, shifted, mu["r"])
    xk = _mix(x, shifted, mu["k"])
    xv = _mix(x, shifted, mu["v"])
    xg = _mix(x, shifted, mu["g"])
    xw = _mix(x, shifted, mu["w"])
    sp = policy.spec_for
    r = mp_linear(params["w_r"], xr, sp(f"{path}/w_r"), path=f"{path}/w_r")
    k = mp_linear(params["w_k"], xk, sp(f"{path}/w_k"), path=f"{path}/w_k")
    v = mp_linear(params["w_v"], xv, sp(f"{path}/w_v"), path=f"{path}/w_v")
    g = mp_linear(params["w_g"], xg, sp(f"{path}/w_g"), path=f"{path}/w_g")
    f32 = torch.float32
    ww = (matmul_f32(torch.tanh(matmul_f32(xw, params["w_lora_a"])),
                     params["w_lora_b"]) + params["w_bias"].to(f32))
    w = torch.exp(-torch.exp(ww))                       # decay in (0, 1)
    return r, k, v, g, w                                # each (B, S, d)


def _gate_out(params, x, o, g, policy, path):
    """(B, S, d) f32 wkv output -> gated ``w_o`` projection."""
    out = o.to(x.dtype)
    out = out * F.silu(g.to(torch.float32)).to(x.dtype)
    return mp_linear(params["w_o"], out, policy.spec_for(f"{path}/w_o"),
                     path=f"{path}/w_o")


def time_mix(params, cfg: RWKVConfig, x, state: RWKVState, policy,
             path: str, write_state: bool = True
             ) -> Tuple[torch.Tensor, RWKVState]:
    """Chunked parallel form over (B, S, d): the output, and the new wkv
    state and time-mix shift (written into ``state`` unless
    ``write_state=False``)."""
    shifted, x_last = _token_shift(x, state.x_prev_t)
    r, k, v, g, w = _projections(params, cfg, x, shifted, policy, path)
    o, s0 = act_sharding.local_rows(
        lambda *a: _wkv_chunked(cfg, *a), (r, k, v, w, state.s),
        (params["u"],))
    out = _gate_out(params, x, o, g, policy, path)
    if not write_state:
        return out, RWKVState(s0, x_last, state.x_prev_c)
    act_sharding.assign(state.s, s0)
    act_sharding.assign(state.x_prev_t, x_last)
    return out, state


def _wkv_chunked(cfg: RWKVConfig, r, k, v, w, s0, u):
    """The WKV recurrence over (B, S, d) projections from state s0 (B,
    H, N, N) -> (output (B, S, d) f32, final state)."""
    b, s, d = r.shape
    h, n = cfg.n_heads, cfg.head_dim
    r, k, v, w = (a.reshape(b, s, h, n) for a in (r, k, v, w))
    f32 = torch.float32
    u = u.to(f32)

    c = cfg.chunk
    pad = -s % c
    if pad:
        z = lambda a: F.pad(a, (0, 0, 0, 0, 0, pad))     # noqa: E731
        r, k, v = z(r), z(k), z(v)
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)    # decay 1: no-op
    nc = (s + pad) // c

    rs = r.to(f32).reshape(b, nc, c, h, n)
    ks = k.to(f32).reshape(b, nc, c, h, n)
    vs = v.to(f32).reshape(b, nc, c, h, n)
    ws = w.to(f32).reshape(b, nc, c, h, n)
    # cumulative decay within a chunk: P[t] = prod_{i<=t} w_i
    logw = torch.log(torch.clamp(ws, min=1e-38))
    cum = torch.cumsum(logw, dim=2)
    p_all = torch.exp(cum[:, :, -1:])                     # full-chunk decay
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)

    outs = []
    for j in range(nc):
        rs_, ks_, vs_ = rs[:, j], ks[:, j], vs[:, j]
        cum_, logw_, pall_ = cum[:, j], logw[:, j], p_all[:, j]
        # inter-chunk: the carried state, decay applied on the r side
        r_dec = rs_ * torch.exp(cum_ - logw_)              # exclusive
        o_inter = torch.einsum("bchn,bhnm->bchm", r_dec, s0)
        # intra-chunk: k_i scaled by the inverse chunk-start decay, the
        # exponent clamped at 40 as in the reference
        k_sc = ks_ * torch.exp(torch.clamp(-cum_, max=40.0))
        att = torch.einsum("bchn,bihn->bhci", r_dec, k_sc)
        att = att * tri[None, None]
        o_intra = torch.einsum("bhci,bihm->bchm", att, vs_)
        # bonus current-token term: r_t . (u * k_t) v_t
        bonus = torch.einsum("bchn,bchn->bch", rs_, ks_ * u[None, None])
        o_cur = bonus[..., None] * vs_
        decay_to_end = torch.exp(cum_[:, -1:] - cum_)     # prod_{j>i} w
        s0 = s0 * pall_[:, 0][..., None] + torch.einsum(
            "bihn,bihm->bhnm", ks_ * decay_to_end, vs_)
        outs.append(o_inter + o_intra + o_cur)
    o = torch.stack(outs, 1).reshape(b, nc * c, h, n)[:, :s].reshape(b, s, d)
    return o, s0


def time_mix_step(params, cfg: RWKVConfig, x, state: RWKVState, policy,
                  path: str) -> Tuple[torch.Tensor, RWKVState]:
    """O(1) single-token decode. x: (B, 1, d)."""
    shifted = state.x_prev_t[:, None].to(x.dtype)
    r, k, v, g, w = _projections(params, cfg, x, shifted, policy, path)

    def wkv_step(r, k, v, w, s, u):
        b, _, d = r.shape
        h, n = cfg.n_heads, cfg.head_dim
        f32 = torch.float32
        u = u.to(f32)
        r1, k1, v1, w1 = (a[:, 0].reshape(b, h, n).to(f32)
                          for a in (r, k, v, w))
        kv = torch.einsum("bhn,bhm->bhnm", k1, v1)
        o = torch.einsum("bhn,bhnm->bhm", r1, s + u[None, :, :, None] * kv)
        return o.reshape(b, 1, d), s * w1[..., None] + kv

    o, s_new = act_sharding.local_rows(wkv_step, (r, k, v, w, state.s),
                                       (params["u"],))
    out = _gate_out(params, x, o, g, policy, path)
    act_sharding.assign(state.s, s_new)
    act_sharding.assign(state.x_prev_t, x[:, -1])
    return out, state


def channel_mix(params, cfg: RWKVConfig, x, state: RWKVState, policy,
                path: str, single_step: bool = False,
                write_state: bool = True
                ) -> Tuple[torch.Tensor, RWKVState]:
    if single_step:
        shifted, x_last = state.x_prev_c[:, None].to(x.dtype), x[:, -1]
    else:
        shifted, x_last = _token_shift(x, state.x_prev_c)
    xk = _mix(x, shifted, params["c_mu"]["k"])
    xr = _mix(x, shifted, params["c_mu"]["r"])
    sp = policy.spec_for
    kk = mp_linear(params["c_key"], xk, sp(f"{path}/c_key"),
                   path=f"{path}/c_key")
    kk = torch.square(F.relu(kk.to(torch.float32))).to(x.dtype)
    vv = mp_linear(params["c_val"], kk, sp(f"{path}/c_val"),
                   path=f"{path}/c_val")
    rr = torch.sigmoid(mp_linear(params["c_rec"], xr, sp(f"{path}/c_rec"),
                                 path=f"{path}/c_rec").to(torch.float32))
    out = (rr * vv.to(torch.float32)).to(x.dtype)
    if not write_state:
        return out, RWKVState(state.s, state.x_prev_t, x_last)
    act_sharding.assign(state.x_prev_c, x_last)
    return out, state
