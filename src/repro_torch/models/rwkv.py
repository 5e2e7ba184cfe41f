"""RWKV-6 language model, attention-free (mirror of
``repro/models/rwkv.py``).

The stacked ``blocks`` keep the reference's leading layer axis; its
``lax.scan`` over them is a Python loop. The decode state is one
:class:`~repro_torch.layers.rwkv6.RWKVState` of stacked (n_layers, ...)
tensors, O(1) in sequence length, updated in place. ``decode_step``
ignores ``pos``. Training (:func:`hidden_states`) starts every layer from a
fresh zero state it never writes, each layer checkpointed unless
``cfg.remat`` is "none".
"""
from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.policy import get_policy
from repro_torch.device import resolve_device
from repro_torch.layers import rwkv6
from repro_torch.layers.common import (apply_norm, embed_init, embed_lookup,
                                       norm_init, seeded_generator, softcap)
from repro_torch.layers.mplinear import _dot_f32, linear_init
from repro_torch.models.lm import remat_wrap, unstack
from repro_torch.parallel import act_sharding as act


def _rwkv_cfg(cfg: ModelConfig) -> rwkv6.RWKVConfig:
    return rwkv6.RWKVConfig(cfg.d_model, cfg.n_heads, cfg.d_ff)


def init(cfg: ModelConfig, seed: int = 0, device=None,
         draws: str = "torch"):
    """Seeded random parameters on ``device`` (CUDA by default)."""
    device = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    gen = seeded_generator(seed, device, draws)
    lead = (cfg.n_layers,)
    d = cfg.d_model
    return {
        "embed": {"w": embed_init(gen, cfg.padded_vocab, d, device, dtype)},
        "ln_in": norm_init("ln", d, device, dtype),
        "blocks": {
            "ln1": norm_init("ln", d, device, dtype, lead),
            "ln2": norm_init("ln", d, device, dtype, lead),
            "mix": rwkv6.init(gen, _rwkv_cfg(cfg), device, dtype, lead),
        },
        "final_norm": norm_init("ln", d, device, dtype),
        "lm_head": linear_init(gen, d, cfg.padded_vocab, False, device,
                               dtype),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0, device=None,
               dtype=torch.bfloat16) -> rwkv6.RWKVState:
    """Stacked zero state (``max_len`` unused; the shift vectors take the
    compute dtype, as in the reference)."""
    return rwkv6.init_state(batch, _rwkv_cfg(cfg), resolve_device(device),
                            getattr(torch, cfg.compute_dtype),
                            lead=(cfg.n_layers,))


def _block(bp, cfg: ModelConfig, x, st: rwkv6.RWKVState, policy,
           single_step: bool, write_state: bool = True):
    """One layer (``bp``: its slice of ``blocks``): time mix, then
    channel mix, each behind a LayerNorm; ``st`` is updated in place
    unless ``write_state=False``."""
    rc = _rwkv_cfg(cfg)
    hn = apply_norm("ln", x, bp["ln1"])
    if single_step:
        a, st = rwkv6.time_mix_step(bp["mix"], rc, hn, st, policy,
                                    "block/mix")
    else:
        a, st = rwkv6.time_mix(bp["mix"], rc, hn, st, policy, "block/mix",
                               write_state=write_state)
    x = x + a
    hn = apply_norm("ln", x, bp["ln2"])
    c, st = rwkv6.channel_mix(bp["mix"], rc, hn, st, policy, "block/mix",
                              single_step=single_step,
                              write_state=write_state)
    return x + c


def _run(params, cfg: ModelConfig, x, states: rwkv6.RWKVState,
         single_step: bool):
    policy = get_policy(cfg.precision_policy)
    for i, bp in enumerate(unstack(params["blocks"])):
        x = _block(bp, cfg, act.batch_seq(x), rwkv6.RWKVState(*(t[i] for t in states)),
                   policy, single_step)
    return x


def _embed(params, cfg: ModelConfig, tokens):
    x = embed_lookup(params["embed"]["w"], tokens).to(
        getattr(torch, cfg.compute_dtype))
    # on a mesh the lookup of a vocabulary-sharded table is a partial sum;
    # settle it before the LayerNorm (DTensor would carry the partial
    # through the mean and round otherwise), as lm's _embed pins it
    return apply_norm("ln", act.batch_seq(x), params["ln_in"])


def _head(params, cfg: ModelConfig, x):
    """Untied head: a dot in the compute dtype with f32 accumulation."""
    logits = softcap(_dot_f32(x, params["lm_head"]["w"], x.dtype),
                     cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab:
        col = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = logits.masked_fill(col >= cfg.vocab, -1e30)
    return act.logits(logits)


head = _head


def hidden_states(params, cfg: ModelConfig, tokens):
    """Train mode: (final normed hidden states (B, S, d), aux 0), every
    layer from a zero state."""
    policy = get_policy(cfg.precision_policy)
    x = _embed(params, cfg, tokens)
    st = rwkv6.init_state(tokens.shape[0], _rwkv_cfg(cfg), x.device,
                          getattr(torch, cfg.compute_dtype))

    def layer(bp, h):
        return _block(bp, cfg, act.batch_seq(h), st, policy, False, write_state=False)

    step = remat_wrap(layer, "none" if cfg.remat == "none" else "full")
    for bp in unstack(params["blocks"]):
        x = step(bp, x)
    return (apply_norm("ln", x, params["final_norm"]),
            torch.zeros((), device=x.device))


def prefill(params, cfg: ModelConfig, tokens, states):
    """tokens: (B, S) -> (last-position logits (B, V), states)."""
    x = _run(params, cfg, _embed(params, cfg, tokens), states, False)
    x = apply_norm("ln", x[:, -1:], params["final_norm"])
    return _head(params, cfg, x)[:, 0], states


def decode_step(params, cfg: ModelConfig, token, pos, states):
    """token: (B, 1) -> (logits (B, V), states); ``pos`` is unused."""
    x = _run(params, cfg, _embed(params, cfg, token), states, True)
    x = apply_norm("ln", x, params["final_norm"])
    return _head(params, cfg, x)[:, 0], states
