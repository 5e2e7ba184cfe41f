"""Encoder-decoder transformer, the seamless-m4t backbone (mirror of
``repro/models/encdec.py``).

The audio frontend is a stub, as in the reference: callers pass
precomputed frame embeddings (B, T_frames, frontend_dim) and a linear
projector with bias maps them into the encoder. Encoder blocks are
bidirectional self-attention with RoPE; decoder blocks are causal
self-attention over a position-tagged KV cache, then cross-attention
into the encoder output, whose keys and values are projected again at
every call (prefill and each decode step), as the reference does.

The decode state is ``(caches, enc_out)``: it exists only after
``prefill``, so the serving engine does not serve this family
(``ServingEngine`` refuses it at construction; the reference's engine
fails at its first decode). Block parameters are stacked on a leading
layer axis (``enc_blocks``, ``dec_blocks``), the reference's
``lax.scan`` a Python loop here; the KV caches are stacked the same way,
as real tensors (never broadcast views), and written in place.
Training (:func:`hidden_states`) runs the decoder in "train" mode (causal
self-attention over the whole sequence, no cache), each encoder and
decoder layer checkpointed unless ``cfg.remat`` is "none".
"""
from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.policy import get_policy
from repro_torch.device import resolve_device
from repro_torch.layers import attention, mlp
from repro_torch.layers.attention import AttnConfig, KVCache
from repro_torch.layers.common import (apply_norm, dense_init, embed_init,
                                       norm_init, seeded_generator)
from repro_torch.layers.mplinear import linear_init, mp_linear
from repro_torch.models.lm import _embed, _head, remat_wrap, unstack


def self_cfg(cfg: ModelConfig, causal: bool) -> AttnConfig:
    return AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta, causal=causal)


def cross_cfg(cfg: ModelConfig) -> AttnConfig:
    return AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, causal=False, cross=True)


def n_enc_layers(cfg: ModelConfig) -> int:
    return cfg.n_enc_layers or cfg.n_layers


def init(cfg: ModelConfig, seed: int = 0, device=None,
         draws: str = "torch"):
    """Random parameters from a seeded ``torch.Generator`` on the target
    device, in the reference's tree: ``embed``, ``frontend_proj`` (with
    bias), stacked ``enc_blocks`` and ``dec_blocks``, ``enc_norm``,
    ``final_norm`` and an untied ``lm_head``. The distribution is the
    reference's, not its bits. Defaults to the CUDA device."""
    device = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    gen = seeded_generator(seed, device, draws)
    d, ln = cfg.d_model, cfg.norm
    enc, dec = (n_enc_layers(cfg),), (cfg.n_layers,)
    return {
        "embed": {"w": embed_init(gen, cfg.padded_vocab, d, device, dtype)},
        "frontend_proj": linear_init(gen, cfg.frontend_dim or d, d, True,
                                     device, dtype),
        "enc_blocks": {
            "ln1": norm_init(ln, d, device, dtype, enc),
            "attn": attention.init(gen, self_cfg(cfg, False), device, dtype,
                                   enc),
            "ln2": norm_init(ln, d, device, dtype, enc),
            "mlp": mlp.init(gen, d, cfg.d_ff, device, dtype, enc),
        },
        "enc_norm": norm_init(ln, d, device, dtype),
        "dec_blocks": {
            "ln1": norm_init(ln, d, device, dtype, dec),
            "attn": attention.init(gen, self_cfg(cfg, True), device, dtype,
                                   dec),
            "ln_x": norm_init(ln, d, device, dtype, dec),
            "xattn": attention.init(gen, cross_cfg(cfg), device, dtype, dec),
            "ln2": norm_init(ln, d, device, dtype, dec),
            "mlp": mlp.init(gen, d, cfg.d_ff, device, dtype, dec),
        },
        "final_norm": norm_init(ln, d, device, dtype),
        "lm_head": {"w": dense_init(gen, d, cfg.padded_vocab, device,
                                    dtype)},
    }


def _positions(b: int, s: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32,
                        device=like.device)[None, :].expand(b, s)


def encode_block(bp, cfg: ModelConfig, x, positions, policy):
    """One bidirectional encoder block: x (B, T, d) -> (B, T, d)."""
    h = apply_norm(cfg.norm, x, bp["ln1"])
    x = x + attention.forward(bp["attn"], self_cfg(cfg, False), h,
                              positions, policy, "enc/attn")
    h = apply_norm(cfg.norm, x, bp["ln2"])
    return x + mlp.forward(bp["mlp"], h, policy, "enc/mlp", cfg.act)


def _remat(cfg: ModelConfig, train: bool) -> str:
    return "full" if train and cfg.remat != "none" else "none"


def encode(params, cfg: ModelConfig, frames, train: bool = False):
    """frames: (B, T, frontend_dim) stub embeddings -> (B, T, d);
    ``train`` checkpoints each layer as ``cfg.remat`` says."""
    policy = get_policy(cfg.precision_policy)
    x = mp_linear(params["frontend_proj"],
                  frames.to(getattr(torch, cfg.compute_dtype)),
                  policy.spec_for("frontend_proj"), path="frontend_proj")
    positions = _positions(x.shape[0], x.shape[1], x)
    step = remat_wrap(lambda bp, h: encode_block(bp, cfg, h, positions,
                                                 policy),
                      _remat(cfg, train))
    for bp in unstack(params["enc_blocks"]):
        x = step(bp, x)
    return apply_norm(cfg.norm, x, params["enc_norm"])


def decode_block(bp, cfg: ModelConfig, x, positions, enc_out, mode: str,
                 cache: KVCache, pos, policy):
    """One decoder block: causal self-attention into ``cache`` (written
    in place; ``mode`` "prefill" from position 0 or "decode" at ``pos``;
    "train" over the whole sequence with no cache), cross-attention onto
    ``enc_out``, then the MLP."""
    h = apply_norm(cfg.norm, x, bp["ln1"])
    if mode == "train":
        a = attention.forward(bp["attn"], self_cfg(cfg, True), h,
                              positions, policy, "dec/attn")
    elif mode == "prefill":
        a, _ = attention.prefill(bp["attn"], self_cfg(cfg, True), h,
                                 positions, cache, policy, "dec/attn")
    elif mode == "decode":
        a, _ = attention.decode_step(bp["attn"], self_cfg(cfg, True), h,
                                     pos, cache, policy, "dec/attn")
    else:
        raise ValueError(f"unknown decoder mode {mode!r}")
    x = x + a
    h = apply_norm(cfg.norm, x, bp["ln_x"])
    x = x + attention.forward(bp["xattn"], cross_cfg(cfg), h, positions,
                              policy, "dec/xattn", kv_input=enc_out)
    h = apply_norm(cfg.norm, x, bp["ln2"])
    return x + mlp.forward(bp["mlp"], h, policy, "dec/mlp", cfg.act)


def _dec_run(params, cfg: ModelConfig, tokens, positions, enc_out,
             mode: str, caches: KVCache, pos=None):
    policy = get_policy(cfg.precision_policy)
    x = _embed(params, cfg, tokens)
    for i, bp in enumerate(unstack(params["dec_blocks"])):
        x = decode_block(bp, cfg, x, positions, enc_out, mode,
                         KVCache(caches.k[i], caches.v[i], caches.pos[i]),
                         pos, policy)
    return x


def hidden_states(params, cfg: ModelConfig, tokens, frames):
    """Train mode: (the decoder's final normed hidden states (B, S, d)
    given ``frames``, aux 0)."""
    policy = get_policy(cfg.precision_policy)
    enc_out = encode(params, cfg, frames, train=True)
    positions = _positions(tokens.shape[0], tokens.shape[1], tokens)

    def layer(bp, h):
        return decode_block(bp, cfg, h, positions, enc_out, "train", None,
                            None, policy)

    step = remat_wrap(layer, _remat(cfg, True))
    x = _embed(params, cfg, tokens)
    for bp in unstack(params["dec_blocks"]):
        x = step(bp, x)
    return (apply_norm(cfg.norm, x, params["final_norm"]),
            torch.zeros((), device=x.device))


head = _head


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               dtype=torch.bfloat16) -> KVCache:
    """The decoder's self-attention caches, stacked (n_layers, ...)."""
    device = resolve_device(device)
    return attention.init_cache(batch, max_len, self_cfg(cfg, True), device,
                                dtype, lead=(cfg.n_layers,))


def prefill(params, cfg: ModelConfig, tokens, caches: KVCache, frames):
    """tokens (B, S), frames (B, T, frontend_dim) -> (last-position
    logits (B, V), (caches, enc_out)): the encoder output is part of the
    decode state, for cross-attention."""
    enc_out = encode(params, cfg, frames)
    b, s = tokens.shape
    positions = _positions(b, s, tokens)
    x = _dec_run(params, cfg, tokens, positions, enc_out, "prefill", caches)
    x = apply_norm(cfg.norm, x[:, -1:], params["final_norm"])
    return _head(params, cfg, x)[:, 0], (caches, enc_out)


def decode_step(params, cfg: ModelConfig, token, pos, state):
    """token (B, 1), pos (B,), state ``(caches, enc_out)`` -> (logits
    (B, V), state); the caches are written in place."""
    caches, enc_out = state
    x = _dec_run(params, cfg, token, pos[:, None], enc_out, "decode",
                 caches, pos)
    x = apply_norm(cfg.norm, x, params["final_norm"])
    return _head(params, cfg, x)[:, 0], (caches, enc_out)
