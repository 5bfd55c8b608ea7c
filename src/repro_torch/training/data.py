"""Deterministic synthetic-LM data (a copy of the JAX package's
``training/data.py``, which is numpy).

Stateless indexing: ``batch_at(step)`` is a pure function of (seed, step,
host slice), so training is resumable from any checkpoint step.  The token
stream is a seeded first-order Markov chain over the vocabulary, giving
~2.5 bits/token of learnable structure, so a training run shows real loss
decrease.  The batches are the JAX package's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .. import default_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 256
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    branching: int = 4  # successors per token (lower = easier to learn)


class MarkovLM:
    """Seeded synthetic language with learnable bigram structure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V, B = cfg.vocab, cfg.branching
        self.successors = rng.integers(0, V, size=(V, B))
        self.probs = rng.dirichlet(np.ones(B) * 0.5, size=V)

    def _sample_rows(self, rng: np.random.Generator, n: int) -> np.ndarray:
        V, B = self.cfg.vocab, self.cfg.branching
        S = self.cfg.seq_len
        out = np.empty((n, S), np.int32)
        tok = rng.integers(0, V, size=n)
        for t in range(S):
            out[:, t] = tok
            u = rng.random((n, 1))
            cum = np.cumsum(self.probs[tok], axis=1)
            choice = (u > cum).sum(axis=1).clip(0, B - 1)
            tok = self.successors[tok, choice]
        return out

    def batch_at(self, step: int, host_id: int = 0, n_hosts: int = 1) -> Dict[str, np.ndarray]:
        """Deterministic host slice of the global batch for ``step``."""
        gb = self.cfg.global_batch
        assert gb % n_hosts == 0, (gb, n_hosts)
        per = gb // n_hosts
        rng = np.random.default_rng((self.cfg.seed, step, host_id))
        return {"tokens": self._sample_rows(rng, per)}

    def global_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        return {"tokens": np.concatenate(
            [self.batch_at(step, h, 1)["tokens"] for h in range(1)], axis=0
        )}

    def entropy_floor_nats(self) -> float:
        """Per-token conditional entropy of the chain (loss floor)."""
        p = self.probs
        h_rows = -(p * np.log(np.maximum(p, 1e-12))).sum(axis=1)
        return float(h_rows.mean())


def device_put_batch(batch: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on ``device`` (the card unless
    ``device="cpu"``)."""
    device = default_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
