"""KV-cache slot management for batched serving (counterpart of the JAX
package's ``serving/kv_cache.py``).

A ``CacheManager`` owns one model-level cache of shape (L, B_slots, ...) and
hands out *slots* to requests: allocation takes the first free slot in FIFO
order, release returns it to the back of the free list.  Per-slot lengths
drive the decode masks, so requests of different ages share one batched
``decode_step`` call — the substrate of continuous batching
(``batching.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from .captured import tree_leaves


@dataclasses.dataclass
class Slot:
    idx: int
    request_id: str
    length: int = 0  # tokens currently in the cache


class CacheManager:
    def __init__(self, model, n_slots: int, max_len: int, dtype=torch.bfloat16):
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.cache = model.init_cache(n_slots, max_len, dtype=dtype)
        self._free: List[int] = list(range(n_slots))
        self.slots: Dict[str, Slot] = {}

    # ------------------------------------------------------------- slots
    def allocate(self, request_id: str) -> Optional[Slot]:
        if not self._free:
            return None
        slot = Slot(self._free.pop(0), request_id)
        self.slots[request_id] = slot
        return slot

    def release(self, request_id: str) -> None:
        slot = self.slots.pop(request_id, None)
        if slot is not None:
            self._free.append(slot.idx)

    @property
    def active(self) -> List[Slot]:
        return sorted(self.slots.values(), key=lambda s: s.idx)

    def utilization(self) -> float:
        return 1.0 - len(self._free) / self.n_slots

    # ------------------------------------------------------------ lengths
    def lengths(self) -> np.ndarray:
        out = np.zeros(self.n_slots, np.int32)
        for s in self.slots.values():
            out[s.idx] = s.length
        return out

    def bytes(self) -> int:
        """Bytes of the cache's tensors (on the ``meta`` device too, where
        nothing is allocated)."""
        return sum(t.numel() * t.element_size() for t in tree_leaves(self.cache))
