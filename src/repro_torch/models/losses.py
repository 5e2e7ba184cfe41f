"""Next-token cross entropy (mirror of ``repro/models/losses.py``).

The reference writes the target logit as a one-hot dot so that its
vocab-sharded logits never gather; on one card a gather along the vocab
axis gives the same value exactly (the padded vocab columns hold -1e30,
never -inf, so the one-hot products there are zeros) and the same
gradient (a one at the target column).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(B, S, V) f32 logits, (B, S) targets -> (B, S) nats."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return lse - tgt


def next_token_xent(logits: torch.Tensor, targets: torch.Tensor,
                    mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """logits: (B, S, V) f32; targets: (B, S) int. Mean nats/token over
    the positions ``mask`` keeps (all by default)."""
    nll = _nll(logits, targets)
    if mask is None:
        loss = nll.mean()
    else:
        m = mask.to(torch.float32)
        loss = (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return loss, {"nll": loss}


def fused_chunked_xent(x: torch.Tensor, head_fn: Callable,
                       targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       chunk: int = 512
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Fused LM head and cross entropy over chunks of ``chunk`` positions.

    ``x``: (B, S, d) final hidden states; ``head_fn(x_chunk) -> logits``
    (f32). A chunk's (B, chunk, V) logits live only inside its
    checkpointed region and are recomputed in backward, so the full
    (B, S, V) logits never exist. The masked nll sums and the kept
    counts add chunk by chunk in order, as the reference's scan does.

    The reference pads S to a multiple of ``chunk`` and masks the pad;
    here the last chunk is just shorter. The padded positions contribute
    exact zeros there, so the sums are the same.
    """
    b, s, _ = x.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.bool, device=x.device)

    def chunk_sums(xc, tc, mc):
        m = mc.to(torch.float32)
        return (_nll(head_fn(xc), tc) * m).sum(), m.sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        nll, kept = checkpoint(chunk_sums, x[:, sl], targets[:, sl],
                               mask[:, sl], use_reentrant=False)
        total = total + nll
        count = count + kept
    loss = total / torch.clamp(count, min=1.0)
    return loss, {"nll": loss}
