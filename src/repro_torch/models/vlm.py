"""InternVL2-style VLM: stub vision frontend + the decoder LM (mirror of
``repro/models/vlm.py``).

The frontend is a stub: callers pass precomputed patch embeddings
(B, n_patches, vit_dim). A two-layer MLP projector maps them into the
LM's embedding space and the sequence is [patch embeddings ; token
embeddings]; logits come from the token positions. Decode is the lm's;
training runs the prefixed sequence through the lm's train-mode blocks
and takes the loss over the token positions.
The engine serves vlm text-only, as the reference's does: it never
installs patches (``ServingEngine`` admits vlm prompts by teacher
forcing).
"""
from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.policy import get_policy
from repro_torch.device import resolve_device
from repro_torch.layers.common import (activation, apply_norm,
                                       seeded_generator)
from repro_torch.layers.mplinear import linear_init, mp_linear
from repro_torch.models import lm


def init(cfg: ModelConfig, seed: int = 0, device=None,
         draws: str = "torch"):
    """``lm.init`` plus ``projector/fc1`` (vit_dim -> d) and ``fc2``
    (d -> d), both with bias, from a generator seeded ``seed + 1``."""
    device = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    params = lm.init(cfg, seed, device, draws)
    gen = seeded_generator(seed + 1, device, draws)
    params["projector"] = {
        "fc1": linear_init(gen, cfg.vit_dim, cfg.d_model, True, device,
                           dtype),
        "fc2": linear_init(gen, cfg.d_model, cfg.d_model, True, device,
                           dtype),
    }
    return params


def _project(params, cfg: ModelConfig, patches):
    policy = get_policy(cfg.precision_policy)
    x = patches.to(getattr(torch, cfg.compute_dtype))
    x = mp_linear(params["projector"]["fc1"], x,
                  policy.spec_for("projector/fc1"), path="projector/fc1")
    x = activation("gelu")(x.to(torch.float32)).to(x.dtype)
    return mp_linear(params["projector"]["fc2"], x,
                     policy.spec_for("projector/fc2"), path="projector/fc2")


def _prefix_seq(params, cfg: ModelConfig, tokens, patches):
    """[projected patches ; token embeddings]: (B, P + S, d)."""
    return torch.cat([_project(params, cfg, patches),
                      lm._embed(params, cfg, tokens)], 1)


def hidden_states(params, cfg: ModelConfig, tokens, patches):
    """Train-mode blocks over the prefixed sequence -> (final normed
    hidden states of the token positions (B, S, d), aux)."""
    x = _prefix_seq(params, cfg, tokens, patches)
    x, aux = lm.train_blocks(params, cfg, x, lm._train_positions(x))
    x = apply_norm(cfg.norm, x, params["final_norm"])
    return x[:, patches.shape[1]:], aux


head = lm._head


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               dtype=torch.bfloat16):
    return lm.init_cache(cfg, batch, max_len, device, dtype)


def prefill(params, cfg: ModelConfig, tokens, caches, patches):
    """tokens: (B, S); patches: (B, P, vit_dim) -> (logits of the last
    token (B, V), caches holding P + S positions)."""
    x = _prefix_seq(params, cfg, tokens, patches)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None, :].expand(b, s)
    x = lm._run_blocks(params, cfg, x, positions, "prefill", caches)
    x = apply_norm(cfg.norm, x[:, -1:], params["final_norm"])
    return lm._head(params, cfg, x)[:, 0], caches


def decode_step(params, cfg: ModelConfig, token, pos, caches):
    return lm.decode_step(params, cfg, token, pos, caches)
