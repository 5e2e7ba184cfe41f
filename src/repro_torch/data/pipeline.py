"""Deterministic, host-shardable synthetic data (mirror of
``repro/data/pipeline.py``).

Every batch is a pure function of (seed, step, host_index): a restart
at any step replays the stream bit for bit, and hosts slice the global
batch without coordinating. The token stream is a fixed random Markov
chain over the vocabulary (the reference's transition table, drawn by
numpy from the same seed, so both packages walk the same chain), which
a model can learn: the loss falls toward the chain's conditional
entropy, log(branching). The reference draws the walk and the modality
stubs with ``jax.random``; here they come from
``np.random.default_rng`` seeded by ``(seed, step, host_index)``
(stubs: ``(seed + 7, step)``), so the streams are not the reference's
bits, only its distributions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs import InputShape, ModelConfig
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 16   # Markov out-degree; entropy ~ log(branching)


def _transition_table(cfg: DataConfig) -> np.ndarray:
    """(vocab, branching) successor table, deterministic from seed."""
    rng = np.random.default_rng(cfg.seed ^ 0x5EED)
    return rng.integers(0, cfg.vocab, (cfg.vocab, cfg.branching),
                        dtype=np.int32)


def _walk(table: np.ndarray, rng: np.random.Generator, batch: int,
          seq: int) -> np.ndarray:
    """(batch, seq + 1) int32: a random start, then ``seq`` successors
    each picked uniformly among the current token's ``branching``."""
    start = rng.integers(0, table.shape[0], batch, dtype=np.int32)
    choices = rng.integers(0, table.shape[1], (batch, seq), dtype=np.int32)
    out = np.empty((batch, seq + 1), np.int32)
    out[:, 0] = start
    for t in range(seq):
        out[:, t + 1] = table[out[:, t], choices[:, t]]
    return out


class SyntheticLMDataset:
    """Markov-chain LM batches on ``device`` (CUDA by default; without
    CUDA that default raises). ``host_index``/``host_count`` slice the
    global batch: each host draws only its own rows."""

    def __init__(self, cfg: DataConfig, host_index: int = 0,
                 host_count: int = 1, device=None):
        if cfg.global_batch % host_count:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {host_count} hosts")
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = cfg.global_batch // host_count
        self.device = resolve_device(device)
        self._table = _transition_table(cfg)

    def tokens(self, step: int) -> np.ndarray:
        """This host's (local_batch, seq_len + 1) int32 walk of ``step``."""
        rng = np.random.default_rng((self.cfg.seed, step, self.host_index))
        return _walk(self._table, rng, self.local_batch, self.cfg.seq_len)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        return {"tokens": torch.from_numpy(self.tokens(step)).to(self.device)}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1

    def conditional_entropy(self) -> float:
        """Nats/token a perfect model converges to (uniform branching)."""
        return float(np.log(self.cfg.branching))


def batch_for(cfg: ModelConfig, shape: InputShape, step: int,
              seed: int = 0, host_index: int = 0, host_count: int = 1,
              device=None) -> Dict[str, torch.Tensor]:
    """Full batch (tokens and the family's modality stub) for an (arch,
    shape) cell: encdec ``frames`` (B, seq_len // 4, frontend_dim), vlm
    ``patches`` (B, n_patches, vit_dim), both f32 standard normal."""
    ds = SyntheticLMDataset(
        DataConfig(vocab=cfg.vocab, seq_len=shape.seq_len,
                   global_batch=shape.global_batch, seed=seed),
        host_index, host_count, device)
    out = dict(ds.batch(step))
    rng = np.random.default_rng((seed + 7, step))
    lb = ds.local_batch
    stub = None
    if cfg.family == "encdec":
        stub = "frames", (lb, shape.seq_len // 4, cfg.frontend_dim)
    if cfg.family == "vlm":
        stub = "patches", (lb, cfg.n_patches, cfg.vit_dim)
    if stub is not None:
        name, dims = stub
        out[name] = torch.from_numpy(
            rng.standard_normal(dims, dtype=np.float32)).to(ds.device)
    return out
