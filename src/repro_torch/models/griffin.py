"""RecurrentGemma / Griffin hybrid (mirror of ``repro/models/griffin.py``):
RG-LRU recurrent blocks and local MQA attention in a repeating (rec,
rec, attn) pattern.

recurrentgemma-9b's 38 layers are 12 stacked (rec, rec, attn) groups,
whose leaves keep the reference's leading group axis, plus 2 trailing
rec blocks in the list ``params["tail"]``. The cache mirrors that:
``{"groups": {"b0": RGLRUState, "b1": RGLRUState, "b2": KVCache},
"tail": [RGLRUState, ...]}``, every tensor real (never a broadcast
view) and updated in place. The embedding is not scaled by sqrt(d)
here (the reference's griffin does not), and the head is tied.
Training (:func:`hidden_states`) runs the blocks in "train" mode from fresh
zero recurrent states it never writes, each stacked group checkpointed
unless ``cfg.remat`` is "none" (the trailing blocks are not, as in the
reference).
"""
from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.policy import get_policy
from repro_torch.device import resolve_device
from repro_torch.layers import attention, mlp, rglru
from repro_torch.layers.attention import AttnConfig
from repro_torch.layers.common import (apply_norm, embed_init, norm_init,
                                       seeded_generator, softcap)
from repro_torch.layers.mplinear import _dot_f32
from repro_torch.models.lm import remat_wrap, unstack


def _rg_cfg(cfg: ModelConfig) -> rglru.RGLRUConfig:
    return rglru.RGLRUConfig(cfg.d_model, cfg.d_rnn or cfg.d_model,
                             cfg.conv_width)


def _attn_cfg(cfg: ModelConfig) -> AttnConfig:
    return AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta,
        rotary_pct=cfg.rotary_pct, window=cfg.window, causal=True,
        attn_softcap=cfg.attn_softcap)


def _pattern(cfg: ModelConfig):
    """(block kinds of one group, stacked groups, trailing rec blocks)."""
    pat = cfg.rec_pattern or ("rec", "rec", "attn")
    n_groups = cfg.n_layers // len(pat)
    return pat, n_groups, cfg.n_layers - n_groups * len(pat)


def _block_init(gen, cfg: ModelConfig, kind: str, device, dtype, lead=()):
    p = {"ln1": norm_init(cfg.norm, cfg.d_model, device, dtype, lead),
         "ln2": norm_init(cfg.norm, cfg.d_model, device, dtype, lead)}
    if kind == "rec":
        p["rec"] = rglru.init(gen, _rg_cfg(cfg), device, dtype, lead)
    else:
        p["attn"] = attention.init(gen, _attn_cfg(cfg), device, dtype, lead)
    p["mlp"] = mlp.init(gen, cfg.d_model, cfg.d_ff, device, dtype, lead)
    return p


def init(cfg: ModelConfig, seed: int = 0, device=None,
         draws: str = "torch"):
    """Seeded random parameters on ``device`` (CUDA by default)."""
    device = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    pat, n_groups, n_tail = _pattern(cfg)
    gen = seeded_generator(seed, device, draws)
    return {
        "embed": {"w": embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                  device, dtype)},
        "blocks": {f"b{i}": _block_init(gen, cfg, kind, device, dtype,
                                        (n_groups,))
                   for i, kind in enumerate(pat)},
        "final_norm": norm_init(cfg.norm, cfg.d_model, device, dtype),
        "tail": [_block_init(gen, cfg, "rec", device, dtype)
                 for _ in range(n_tail)],
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               dtype=torch.bfloat16):
    device = resolve_device(device)
    pat, n_groups, n_tail = _pattern(cfg)
    rg = _rg_cfg(cfg)
    cap = min(cfg.window or max_len, max_len)
    groups = {}
    for i, kind in enumerate(pat):
        if kind == "rec":
            groups[f"b{i}"] = rglru.init_state(batch, rg, device, dtype,
                                               lead=(n_groups,))
        else:
            groups[f"b{i}"] = attention.init_cache(
                batch, cap, _attn_cfg(cfg), device, dtype, lead=(n_groups,))
    return {"groups": groups,
            "tail": [rglru.init_state(batch, rg, device, dtype)
                     for _ in range(n_tail)]}


def _apply_block(bp, cfg: ModelConfig, kind: str, x, positions, policy,
                 mode: str, cache, pos):
    h = apply_norm(cfg.norm, x, bp["ln1"])
    if kind == "rec" and mode == "train":
        a, _ = rglru.forward(bp["rec"], _rg_cfg(cfg), h, cache, policy,
                             "block/rec", write_state=False)
    elif kind == "rec":
        fn = rglru.decode_step if mode == "decode" else rglru.forward
        a, cache = fn(bp["rec"], _rg_cfg(cfg), h, cache, policy, "block/rec")
    elif mode == "train":
        a = attention.forward(bp["attn"], _attn_cfg(cfg), h, positions,
                              policy, "block/attn")
    elif mode == "prefill":
        a, cache = attention.prefill(bp["attn"], _attn_cfg(cfg), h,
                                     positions, cache, policy, "block/attn")
    else:
        a, cache = attention.decode_step(bp["attn"], _attn_cfg(cfg), h, pos,
                                         cache, policy, "block/attn")
    x = x + a
    h = apply_norm(cfg.norm, x, bp["ln2"])
    return x + mlp.forward(bp["mlp"], h, policy, "block/mlp", cfg.act)


def _run(params, cfg: ModelConfig, x, positions, mode: str, caches, pos):
    policy = get_policy(cfg.precision_policy)
    pat, _, n_tail = _pattern(cfg)
    for g, gp in enumerate(unstack(params["blocks"])):
        for i, kind in enumerate(pat):
            c = caches["groups"][f"b{i}"]
            x = _apply_block(gp[f"b{i}"], cfg, kind, x, positions, policy,
                             mode, type(c)(*(t[g] for t in c)), pos)
    for i in range(n_tail):
        x = _apply_block(params["tail"][i], cfg, "rec", x, positions, policy,
                         mode, caches["tail"][i], pos)
    return x


def hidden_states(params, cfg: ModelConfig, tokens):
    """Train mode: (final normed hidden states (B, S, d), aux 0)."""
    policy = get_policy(cfg.precision_policy)
    pat, _, n_tail = _pattern(cfg)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None, :].expand(b, s)
    x = _embed(params, cfg, tokens)
    # one zero state serves every rec block: train mode never writes it
    st = rglru.init_state(b, _rg_cfg(cfg), x.device,
                          getattr(torch, cfg.compute_dtype))

    def group(gp, h):
        for i, kind in enumerate(pat):
            h = _apply_block(gp[f"b{i}"], cfg, kind, h, positions, policy,
                             "train", st, None)
        return h

    step = remat_wrap(group, "none" if cfg.remat == "none" else "full")
    for gp in unstack(params["blocks"]):
        x = step(gp, x)
    for i in range(n_tail):
        x = _apply_block(params["tail"][i], cfg, "rec", x, positions, policy,
                         "train", st, None)
    return (apply_norm(cfg.norm, x, params["final_norm"]),
            torch.zeros((), device=x.device))


def _embed(params, cfg: ModelConfig, tokens):
    return params["embed"]["w"][tokens].to(getattr(torch, cfg.compute_dtype))


def _logits(params, cfg: ModelConfig, x):
    """Tied head: the (padded_vocab, d) embedding cast to the compute
    dtype on every call, as the reference does, f32 accumulation."""
    logits = softcap(_dot_f32(x, params["embed"]["w"].T, x.dtype),
                     cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab:
        col = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = logits.masked_fill(col >= cfg.vocab, -1e30)
    return logits


head = _logits


def prefill(params, cfg: ModelConfig, tokens, caches):
    """tokens: (B, S) -> (last-position logits (B, V), caches)."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None, :].expand(b, s)
    x = _run(params, cfg, _embed(params, cfg, tokens), positions, "prefill",
             caches, None)
    x = apply_norm(cfg.norm, x[:, -1:], params["final_norm"])
    return _logits(params, cfg, x)[:, 0], caches


def decode_step(params, cfg: ModelConfig, token, pos, caches):
    """token: (B, 1); pos: (B,) -> (logits (B, V), caches)."""
    x = _run(params, cfg, _embed(params, cfg, token), pos[:, None],
             "decode", caches, pos)
    x = apply_norm(cfg.norm, x, params["final_norm"])
    return _logits(params, cfg, x)[:, 0], caches
