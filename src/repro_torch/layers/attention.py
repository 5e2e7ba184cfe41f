"""Grouped-query attention with a position-tagged KV cache (mirror of
``repro/layers/attention.py``: GQA, RoPE, QKV bias, QK-norm, sliding
windows, softcap, and the encoder's bidirectional and the decoder's
cross-attention modes of the encdec family).

The cache ring is updated IN PLACE (the reference returns new arrays):
``prefill``, ``prefill_chunk`` and ``decode_step`` write into the
``KVCache`` tensors they are given and return that same cache, which
saves a full cache copy per layer and step. Writes use distinct ring
slots per row, as the reference's do, so no index is written twice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.layers.common import (Generator, apply_rope, norm_init,
                                       rms_norm, softcap)
from repro_torch.layers.mplinear import linear_init, mp_linear


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    window: Optional[int] = None
    attn_softcap: Optional[float] = None
    causal: bool = True
    cross: bool = False                # cross-attention (no RoPE, kv=ctx)
    scale: Optional[float] = None
    q_chunk: int = 512
    kv_chunk: int = 1024
    chunk_threshold: int = 2048

    @property
    def q_dim(self):
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self):
        return self.n_kv_heads * self.head_dim


class KVCache(NamedTuple):
    """Position-tagged cache: ring-indexed when capacity < sequence."""

    k: torch.Tensor    # (B, C, Hkv, D)
    v: torch.Tensor    # (B, C, Hkv, D)
    pos: torch.Tensor  # (B, C) int32 absolute positions, -1 = empty


def init(generator: Generator, cfg: AttnConfig, device,
         dtype=torch.float32, lead=()):
    p = {
        "wq": linear_init(generator, cfg.d_model, cfg.q_dim, cfg.qkv_bias,
                      device, dtype, lead),
        "wk": linear_init(generator, cfg.d_model, cfg.kv_dim, cfg.qkv_bias,
                      device, dtype, lead),
        "wv": linear_init(generator, cfg.d_model, cfg.kv_dim, cfg.qkv_bias,
                      device, dtype, lead),
        "wo": linear_init(generator, cfg.q_dim, cfg.d_model, False, device,
                      dtype, lead),
    }
    if cfg.qk_norm:
        p["q_norm"] = norm_init("rms", cfg.head_dim, device, dtype, lead)
        p["k_norm"] = norm_init("rms", cfg.head_dim, device, dtype, lead)
    return p


def init_cache(batch: int, capacity: int, cfg: AttnConfig, device,
               dtype=torch.bfloat16, lead=()) -> KVCache:
    shape = (*lead, batch, capacity, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((*lead, batch, capacity), -1, dtype=torch.int32,
                       device=device))


def _project_qkv(params, cfg: AttnConfig, x, positions, policy, path,
                 kv_input=None):
    """Queries from ``x``; keys and values from ``kv_input`` when given
    (cross-attention), else from ``x``."""
    spec = policy.spec_for
    b, s, _ = x.shape
    q = mp_linear(params["wq"], x, spec(f"{path}/wq"),
                  path=f"{path}/wq").reshape(b, s, cfg.n_heads, cfg.head_dim)
    kv_src = x if kv_input is None else kv_input
    bk, sk, _ = kv_src.shape
    k = mp_linear(params["wk"], kv_src, spec(f"{path}/wk"),
                  path=f"{path}/wk").reshape(bk, sk, cfg.n_kv_heads,
                                             cfg.head_dim)
    v = mp_linear(params["wv"], kv_src, spec(f"{path}/wv"),
                  path=f"{path}/wv").reshape(bk, sk, cfg.n_kv_heads,
                                             cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"]["w"])
        k = rms_norm(k, params["k_norm"]["w"])
    if not cfg.cross:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
    return q, k, v


def _mask(cfg: AttnConfig, q_pos, k_pos, k_valid):
    """(B, 1, 1, Sq, Sk) boolean mask from position tags."""
    m = k_valid[:, None, None, None, :]
    kp = k_pos[:, None, None, None, :]
    qp = q_pos[:, None, None, :, None]
    if cfg.causal:
        m = m & (kp <= qp)
    if cfg.window is not None:
        m = m & (kp > qp - cfg.window)
    return m


def _scale(cfg: AttnConfig, d: int) -> float:
    return cfg.scale if cfg.scale is not None else 1.0 / math.sqrt(d)


def _attend_dense(cfg: AttnConfig, q, k, v, q_pos, k_pos, k_valid):
    """Materialized-logits attention (short sequences / decode). The
    probabilities round to the cache dtype before the value product, as
    in the reference; that product sums in f32 and rounds once."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * _scale(cfg, d)
    logits = softcap(logits, cfg.attn_softcap)
    mask = _mask(cfg, q_pos, k_pos, k_valid)
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd",
                       probs.to(v.dtype).to(torch.float32),
                       v.to(torch.float32)).to(v.dtype)
    return out.reshape(b, sq, hq * d)


def _attend_chunked(cfg: AttnConfig, q, k, v, q_pos, k_pos, k_valid):
    """Online-softmax attention over KV chunks for each Q chunk: O(S)
    memory for long prefills. All accumulation in f32."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = _scale(cfg, d)
    qc, kc = cfg.q_chunk, cfg.kv_chunk
    outs = []
    for q0 in range(0, sq, qc):
        qi = q[:, q0:q0 + qc].reshape(b, -1, hkv, g, d).to(torch.float32)
        qpi = q_pos[:, q0:q0 + qc]
        n_q = qi.shape[1]
        m = torch.full((b, hkv, g, n_q), -math.inf, device=q.device)
        l = torch.zeros((b, hkv, g, n_q), device=q.device)
        acc = torch.zeros((b, hkv, g, n_q, d), device=q.device)
        for k0 in range(0, k.shape[1], kc):
            ki = k[:, k0:k0 + kc].to(torch.float32)
            vi = v[:, k0:k0 + kc].to(torch.float32)
            logits = torch.einsum("bqhgd,bkhd->bhgqk", qi, ki) * scale
            logits = softcap(logits, cfg.attn_softcap)
            msk = _mask(cfg, qpi, k_pos[:, k0:k0 + kc],
                        k_valid[:, k0:k0 + kc])
            logits = logits.masked_fill(~msk, -1e30)
            m_new = torch.maximum(m, logits.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vi)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, n_q, hq * d))
    return torch.cat(outs, dim=1).to(v.dtype)


def _attend(cfg: AttnConfig, q, k, v, q_pos, k_pos, k_valid):
    if q.shape[1] > 1 and k.shape[1] > cfg.chunk_threshold:
        return _attend_chunked(cfg, q, k, v, q_pos, k_pos, k_valid)
    return _attend_dense(cfg, q, k, v, q_pos, k_pos, k_valid)


def forward(params, cfg: AttnConfig, x, positions, policy, path,
            kv_input=None, kv_valid=None):
    """Attention over whole sequences, no cache: x (B, S, d), positions
    (B, S). With ``kv_input`` (B, T, d), cross-attention onto it at key
    positions ``0..T-1``; ``kv_valid`` (B, T_kv) masks keys (all valid
    by default). Returns (B, S, d)."""
    q, k, v = _project_qkv(params, cfg, x, positions, policy, path,
                           kv_input)
    k_pos = positions
    if kv_input is not None:
        k_pos = torch.arange(kv_input.shape[1], dtype=torch.int32,
                             device=x.device)[None, :].expand(
                                 kv_input.shape[:2])
    if kv_valid is None:
        kv_valid = torch.ones(k.shape[:2], dtype=torch.bool, device=x.device)
    out = _attend(cfg, q, k, v, positions, k_pos, kv_valid)
    return mp_linear(params["wo"], out, policy.spec_for(f"{path}/wo"),
                     path=f"{path}/wo")


def prefill(params, cfg: AttnConfig, x, positions, cache: KVCache, policy,
            path):
    """Prefill from position 0: full-sequence attention, then the
    trailing ``capacity`` positions written at their ring slots."""
    q, k, v = _project_qkv(params, cfg, x, positions, policy, path)
    out = _attend(cfg, q, k, v, positions, positions,
                  torch.ones(k.shape[:2], dtype=torch.bool, device=x.device))
    cap = cache.k.shape[1]
    s = k.shape[1]
    k_w, v_w, pos_w = k, v, positions
    if s > cap:
        k_w, v_w, pos_w = k[:, -cap:], v[:, -cap:], positions[:, -cap:]
    start = (s - cap) % cap if s > cap else 0
    for buf, upd in ((cache.k, k_w), (cache.v, v_w), (cache.pos, pos_w)):
        n_first = min(cap - start, upd.shape[1])
        buf[:, start:start + n_first] = upd[:, :n_first].to(buf.dtype)
        if start:
            buf[:, :upd.shape[1] - n_first] = upd[:, n_first:].to(buf.dtype)
    y = mp_linear(params["wo"], out, policy.spec_for(f"{path}/wo"),
                  path=f"{path}/wo")
    return y, cache


def prefill_chunk(params, cfg: AttnConfig, x, positions, valid,
                  cache: KVCache, policy, path):
    """Write one prompt chunk at absolute ``positions`` into a live
    cache (only where ``valid``), then attend the chunk's queries
    against the whole updated cache by position tags. Needs S <=
    capacity, so a row's slots are distinct."""
    q, k, v = _project_qkv(params, cfg, x, positions, policy, path)
    cap = cache.k.shape[1]
    slot = positions.remainder(cap)
    bidx = torch.arange(x.shape[0], device=x.device)[:, None]
    vk = valid[..., None, None]
    cache.k[bidx, slot] = torch.where(vk, k.to(cache.k.dtype),
                                      cache.k[bidx, slot])
    cache.v[bidx, slot] = torch.where(vk, v.to(cache.v.dtype),
                                      cache.v[bidx, slot])
    cache.pos[bidx, slot] = torch.where(valid, positions.to(torch.int32),
                                        cache.pos[bidx, slot])
    out = _attend(cfg, q, cache.k, cache.v, positions, cache.pos,
                  cache.pos >= 0)
    y = mp_linear(params["wo"], out, policy.spec_for(f"{path}/wo"),
                  path=f"{path}/wo")
    return y, cache


def decode_step(params, cfg: AttnConfig, x, pos, cache: KVCache, policy,
                path):
    """One-token decode. x: (B, 1, d); pos: (B,). Writes the new K/V at
    slot ``pos % capacity`` and masks by position tags."""
    positions = pos[:, None]
    q, k, v = _project_qkv(params, cfg, x, positions, policy, path)
    cap = cache.k.shape[1]
    slot = pos.remainder(cap)
    bidx = torch.arange(x.shape[0], device=x.device)
    cache.k[bidx, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[bidx, slot] = v[:, 0].to(cache.v.dtype)
    cache.pos[bidx, slot] = pos.to(torch.int32)
    out = _attend(cfg, q, cache.k, cache.v, positions, cache.pos,
                  cache.pos >= 0)
    y = mp_linear(params["wo"], out, policy.spec_for(f"{path}/wo"),
                  path=f"{path}/wo")
    return y, cache
