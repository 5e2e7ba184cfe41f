"""On-device batched token selection: temperature / top-k / top-p
(mirror of ``repro/models/sampling.py``).

``jax.random`` streams cannot be reproduced in torch, so each row keeps
its own counter-based random state instead: ``keys`` is (B, 2) int64,
``[seed, counter]`` with both in uint32 range. One call draws one
uniform per row from a 32-bit integer hash of (seed, counter) and
advances every row's counter by one, consumed or not, so a row's
stream depends only on its own seed and call count — the property that
keeps sampled streams invariant to ``decode_block``. Everything stays on
the device; nothing syncs the host.

Rows with ``temperature <= 0`` take the argmax of the raw logits. Other
rows sample from the temperature-scaled distribution, truncated by the
nucleus convention: a token survives while its rank is below ``top_k``
and the cumulative probability before it is below ``top_p`` (rank 0
always survives).
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def hash32(x: torch.Tensor) -> torch.Tensor:
    """An avalanching 32-bit integer hash on int64 tensors holding uint32
    values (products may wrap in int64; their low 32 bits are exact)."""
    x = x & _M32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def make_key(seed: int, stream: int = 0) -> list:
    """[seed32, counter] for a request: an explicit ``seed``, or the
    engine seed mixed with the request id as ``stream``."""
    s = torch.tensor([seed & _M32], dtype=torch.int64)
    s = hash32(hash32(s) ^ (stream & _M32))
    return [int(s[0]), 0]


def uniform(keys: torch.Tensor) -> torch.Tensor:
    """(B,) f32 uniforms in [0, 1) from (B, 2) keys (no advance)."""
    h = hash32(hash32(keys[:, 0]) ^ keys[:, 1])
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def sample_tokens(keys, logits, temperature, top_k, top_p):
    """-> (advanced keys (B, 2), tokens (B,) int32)."""
    v = logits.shape[-1]
    logits = logits.to(torch.float32)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)

    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    order = torch.argsort(-scaled, dim=-1, stable=True)
    ranked = torch.gather(scaled, -1, order)
    probs = torch.softmax(ranked, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    rank = torch.arange(v, device=logits.device)[None, :]
    limit = torch.where(top_k > 0, top_k, torch.full_like(top_k, v))
    keep = rank < limit[:, None]
    keep &= (cum - probs) < top_p[:, None]
    keep |= rank == 0
    kept = torch.softmax(ranked.masked_fill(~keep, float("-inf")), dim=-1)
    cdf = torch.cumsum(kept, dim=-1)
    u = uniform(keys)
    idx = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None], right=True)
    n_kept = keep.sum(dim=-1, keepdim=True)
    idx = torch.minimum(idx, n_kept - 1)
    sampled = torch.gather(order, -1, idx)[:, 0]
    tokens = torch.where(temperature > 0.0, sampled.to(torch.int32), greedy)
    advanced = keys.clone()
    advanced[:, 1] = (keys[:, 1] + 1) & _M32
    return advanced, tokens
