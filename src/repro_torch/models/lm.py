"""Decoder-only transformer LM (mirror of ``repro/models/lm.py``): the
dense and MoE configurations of the ``lm`` family (qwen2, gemma2,
glm4, stablelm, mixtral, qwen3-moe).

The parameter tree keeps the reference's paths and layout, including
the stacked leading group axis of every ``params["blocks"]["b<i>"]``
leaf, so weights convert leaf by leaf. The reference's ``lax.scan`` over
that axis is a Python loop here; its activation-sharding pins mean
nothing on one GPU and are gone. KV caches are stacked the same way and
updated in place (``layers.attention``). An MoE block holds a ``"moe"``
subtree where a dense one holds ``"mlp"``; serving drops the MoE
layer's load-balancing loss, as the reference's serving entry points do,
and training adds 0.01 of it to the loss (``registry``'s ``loss_fn``).

Training runs the blocks in ``"train"`` mode (``attention.forward``, no
cache), each layer group checkpointed as ``cfg.remat`` says
(:func:`remat_wrap`).
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs import ModelConfig
from repro_torch.core.policy import get_policy
from repro_torch.device import resolve_device
from repro_torch.layers import attention, mlp, moe
from repro_torch.layers.attention import AttnConfig, KVCache
from repro_torch.layers.common import (apply_norm, dense_init, embed_init,
                                       norm_init, seeded_generator, softcap)
from repro_torch.layers.mplinear import _dot_f32
from repro_torch.quant.prepare import PreparedWeight


def group_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    if cfg.attn_pattern == "full":
        return ("full",)
    if cfg.attn_pattern == "swa":
        return ("swa",)
    if cfg.attn_pattern == "alt_local_global":
        return ("swa", "full")
    raise ValueError(cfg.attn_pattern)


def attn_cfg(cfg: ModelConfig, kind: str) -> AttnConfig:
    return AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
        rope_theta=cfg.rope_theta, rotary_pct=cfg.rotary_pct,
        window=cfg.window if kind == "swa" else None,
        attn_softcap=cfg.attn_softcap, causal=True, scale=cfg.attn_scale)


def moe_cfg(cfg: ModelConfig) -> moe.MoEConfig:
    return moe.MoEConfig(cfg.d_model, cfg.moe.d_expert, cfg.moe.n_experts,
                         cfg.moe.top_k, cfg.moe.capacity_factor, cfg.act,
                         dispatch=cfg.moe.dispatch)


def _block_init(gen, cfg: ModelConfig, kind: str, device, dtype, lead):
    p = {
        "ln1": norm_init(cfg.norm, cfg.d_model, device, dtype, lead),
        "attn": attention.init(gen, attn_cfg(cfg, kind), device, dtype, lead),
        "ln2": norm_init(cfg.norm, cfg.d_model, device, dtype, lead),
    }
    if cfg.moe:
        p["moe"] = moe.init(gen, moe_cfg(cfg), device, dtype, lead)
    else:
        p["mlp"] = mlp.init(gen, cfg.d_model, cfg.d_ff, device, dtype, lead)
    if cfg.post_norms:
        p["post_ln1"] = norm_init(cfg.norm, cfg.d_model, device, dtype, lead)
        p["post_ln2"] = norm_init(cfg.norm, cfg.d_model, device, dtype, lead)
    return p


def init(cfg: ModelConfig, seed: int = 0, device=None,
         draws: str = "torch"):
    """Random parameters from a seeded ``torch.Generator`` on the target
    device (or, ``draws="numpy"``, numpy's: the same bits on every
    device and installation; ``layers.common.seeded_generator``):
    truncated normal at +-3 sigma times 1/sqrt(d_in), and d**-0.5 for
    the embedding (the reference's distribution, not its bits). Defaults
    to the CUDA device; pass ``device="cpu"`` for CPU."""
    device = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    kinds = group_kinds(cfg)
    if cfg.n_layers % len(kinds):
        raise ValueError(f"{cfg.arch_id}: {cfg.n_layers} layers do not "
                         f"split into groups of {kinds}")
    n_groups = cfg.n_layers // len(kinds)
    gen = seeded_generator(seed, device, draws)
    params = {
        "embed": {"w": embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                  device, dtype)},
        "blocks": {f"b{i}": _block_init(gen, cfg, kind, device, dtype,
                                        (n_groups,))
                   for i, kind in enumerate(kinds)},
        "final_norm": norm_init(cfg.norm, cfg.d_model, device, dtype),
    }
    if not cfg.tied_embeddings:
        params["lm_head"] = {"w": dense_init(gen, cfg.d_model,
                                             cfg.padded_vocab, device,
                                             dtype)}
    return params


def unstack(tree):
    """The layers of a stacked block subtree: one tree per entry of the
    leading layer axis, every leaf a view (no copy), from one
    ``torch.unbind`` per leaf. In training autograd then stacks the
    layers' gradients once, where indexing layer by layer would scatter
    each layer's gradient into a zero tensor the size of the whole stack
    (work quadratic in depth)."""
    if isinstance(tree, dict):
        subs = {k: unstack(v) for k, v in tree.items()}
        n = len(next(iter(subs.values()))) if subs else 0
        return [{k: subs[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, PreparedWeight):
        return [tree.index(i) for i in range(tree.data.shape[0])]
    return list(torch.unbind(tree, 0))


def _embed(params, cfg: ModelConfig, tokens):
    x = params["embed"]["w"][tokens]
    x = x.to(getattr(torch, cfg.compute_dtype))
    if cfg.norm == "rms_zc":
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _head(params, cfg: ModelConfig, x):
    """Logits in f32. The tied head casts the (padded_vocab, d) embedding
    to the compute dtype on every call, as the reference does
    (``w.T.astype(x.dtype)``)."""
    if cfg.tied_embeddings:
        w = params["embed"]["w"].T
    else:
        w = params["lm_head"]["w"]
    logits = _dot_f32(x, w, x.dtype)
    logits = softcap(logits, cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab:
        col = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = logits.masked_fill(col >= cfg.vocab, -1e30)
    return logits


def _apply_block(params, cfg: ModelConfig, kind: str, x, positions, policy,
                 mode: str, cache: Optional[KVCache], pos, valid=None):
    """One block; returns (x, the MoE aux loss: a () f32 tensor, or 0.0
    for a dense block). ``mode`` "train" attends over the whole sequence
    with no cache."""
    path = f"block/{kind}/attn"
    acfg = attn_cfg(cfg, kind)
    h = apply_norm(cfg.norm, x, params["ln1"])
    if mode == "train":
        a = attention.forward(params["attn"], acfg, h, positions, policy,
                              path)
    elif mode == "prefill":
        a, cache = attention.prefill(params["attn"], acfg, h, positions,
                                     cache, policy, path)
    elif mode == "chunk":
        a, cache = attention.prefill_chunk(params["attn"], acfg, h,
                                           positions, valid, cache, policy,
                                           path)
    elif mode == "decode":
        a, cache = attention.decode_step(params["attn"], acfg, h, pos, cache,
                                         policy, path)
    else:
        raise ValueError(f"unknown block mode {mode!r}")
    if cfg.post_norms:
        a = apply_norm(cfg.norm, a, params["post_ln1"])
    x = x + a
    h = apply_norm(cfg.norm, x, params["ln2"])
    aux = 0.0
    if cfg.moe:
        f, aux = moe.forward(params["moe"], moe_cfg(cfg), h, policy,
                             "block/moe")
    else:
        f = mlp.forward(params["mlp"], h, policy, "block/mlp", cfg.act)
    if cfg.post_norms:
        f = apply_norm(cfg.norm, f, params["post_ln2"])
    return x + f, aux


def _run_blocks(params, cfg: ModelConfig, x, positions, mode: str, caches,
                pos=None, valid=None):
    """The serving modes: every block over the live ``caches``."""
    policy = get_policy(cfg.precision_policy)
    kinds = group_kinds(cfg)
    for gi, gp in enumerate(unstack(params["blocks"])):
        for i, kind in enumerate(kinds):
            c = caches[f"b{i}"]
            x, _ = _apply_block(gp[f"b{i}"], cfg, kind, x, positions,
                                policy, mode,
                                KVCache(c.k[gi], c.v[gi], c.pos[gi]), pos,
                                valid=valid)
    return x


# the products ``remat="dots"`` keeps for backward: the 2-D matmuls a
# projection lowers to, not the batched attention einsums (the
# reference's ``checkpoint_dots_with_no_batch_dims``)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(fn: Callable, remat: str) -> Callable:
    """``fn`` under ``cfg.remat``: "none" as is; "full" checkpointed
    (only its inputs kept, everything recomputed in backward); "dots"
    checkpointed keeping the matmul outputs. All three give the same
    values."""
    if remat == "none":
        return fn
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    elif remat != "full":
        raise ValueError(f"unknown remat {remat!r}")

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


def train_blocks(params, cfg: ModelConfig, x, positions):
    """Every block in "train" mode -> (x, the summed MoE aux loss), each
    layer group checkpointed as ``cfg.remat`` says."""
    policy = get_policy(cfg.precision_policy)
    kinds = group_kinds(cfg)

    def group(gp, h, aux):
        for i, kind in enumerate(kinds):
            h, a = _apply_block(gp[f"b{i}"], cfg, kind, h, positions,
                                policy, "train", None, None)
            aux = aux + a
        return h, aux

    step = remat_wrap(group, cfg.remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for gp in unstack(params["blocks"]):
        x, aux = step(gp, x, aux)
    return x, aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               dtype=torch.bfloat16) -> Dict[str, KVCache]:
    """Stacked (n_groups, ...) caches; SWA groups get window-sized rings."""
    device = resolve_device(device)
    kinds = group_kinds(cfg)
    n_groups = cfg.n_layers // len(kinds)
    out = {}
    for i, kind in enumerate(kinds):
        cap = max_len
        if kind == "swa" and cfg.window is not None:
            cap = min(cfg.window, max_len)
        out[f"b{i}"] = attention.init_cache(batch, cap, attn_cfg(cfg, kind),
                                            device, dtype, lead=(n_groups,))
    return out


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=like.device)


def _train_positions(tokens):
    b, s = tokens.shape[:2]
    return _arange(s, tokens)[None, :].expand(b, s)


def hidden_states(params, cfg: ModelConfig, tokens):
    """tokens: (B, S) -> (final normed hidden states (B, S, d), aux)."""
    x = _embed(params, cfg, tokens)
    x, aux = train_blocks(params, cfg, x, _train_positions(tokens))
    return apply_norm(cfg.norm, x, params["final_norm"]), aux


def train_logits(params, cfg: ModelConfig, tokens):
    """tokens: (B, S) -> (logits (B, S, V) f32, aux)."""
    x, aux = hidden_states(params, cfg, tokens)
    return _head(params, cfg, x), aux


# the training head (``registry``'s loss runs it over chunks)
head = _head


def prefill(params, cfg: ModelConfig, tokens, caches):
    """tokens: (B, S) -> (last-position logits (B, V), caches)."""
    b, s = tokens.shape
    positions = _arange(s, tokens)[None, :].expand(b, s)
    x = _embed(params, cfg, tokens)
    x = _run_blocks(params, cfg, x, positions, "prefill", caches)
    x = apply_norm(cfg.norm, x[:, -1:], params["final_norm"])
    return _head(params, cfg, x)[:, 0], caches


def prefill_chunk(params, cfg: ModelConfig, tokens, offsets, lengths,
                  caches):
    """Position-offset prefill continuation: ``tokens`` (B, S) is one
    chunk of each row's prompt starting at absolute ``offsets`` (B,),
    with ``lengths`` (B,) valid tokens per row (0 = row untouched).
    Writes the chunk's K/V into the live caches; no logits."""
    b, s = tokens.shape
    ar = _arange(s, tokens)
    positions = offsets.to(torch.int32)[:, None] + ar[None, :]
    valid = ar[None, :] < lengths[:, None]
    x = _embed(params, cfg, torch.where(valid, tokens,
                                        torch.zeros_like(tokens)))
    _run_blocks(params, cfg, x, positions, "chunk", caches, valid=valid)
    return caches


def decode_step(params, cfg: ModelConfig, token, pos, caches):
    """token: (B, 1); pos: (B,) -> (logits (B, V), caches)."""
    x = _embed(params, cfg, token)
    x = _run_blocks(params, cfg, x, pos[:, None], "decode", caches, pos=pos)
    x = apply_norm(cfg.norm, x, params["final_norm"])
    return _head(params, cfg, x)[:, 0], caches
