"""Continuous batching: iteration-level scheduling of concurrent requests
(counterpart of the JAX package's ``serving/batching.py``).

Requests join/leave the running batch between decode steps (vLLM-style)
instead of static request batches: a request that finishes frees its cache
slot for the next queued request at the next iteration.  Combined with Hiku
this is the worker-side execution model — the scheduler places requests on
workers, the batcher packs them into the worker's decode loop.

Every iteration makes ONE batched ``decode_step`` over all slots with a
per-slot ``cache_index`` vector (each row written at its own age and masked
by its own length).  Prompt prefill rides the same loop: a slot in prefill
phase consumes its next prompt token instead of its last generated one, so
the shapes never change.  Free slots decode a dummy token that lands at
position 0 and is overwritten on reuse.  On the card the step is captured
once in a CUDA graph (``captured.py``): each iteration copies the (B, 1)
tokens and (B,) lengths into its static buffers, replays it, and reads back
the (B,) argmax, the one sync of a step (the JAX batcher reads it too).  On
the CPU the step runs eagerly.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List

import torch

from .captured import CapturedStep, copy_into, tree_leaves
from .kv_cache import CacheManager


@dataclasses.dataclass
class GenRequest:
    request_id: str
    prompt: List[int]
    max_new_tokens: int = 8
    generated: List[int] = dataclasses.field(default_factory=list)
    _consumed: int = 0  # prompt tokens fed so far

    @property
    def in_prefill(self) -> bool:
        return self._consumed < len(self.prompt)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


class ContinuousBatcher:
    def __init__(self, model, params, n_slots: int = 4, max_len: int = 64,
                 dtype=torch.float32):
        self.model = model
        self.params = params
        self.mgr = CacheManager(model, n_slots, max_len, dtype=dtype)
        self.queue: Deque[GenRequest] = deque()
        self.running: Dict[str, GenRequest] = {}
        self.completed: Dict[str, GenRequest] = {}
        self.steps = 0
        dev = model.device
        on_card = dev.type == "cuda"
        # the last step's (B, vocab) logits and its inputs on the device: (B, 1)
        # tokens and (B,) per-slot lengths, staged on the host (pinned on the card)
        self.logits = None
        self.step_tokens = torch.zeros((n_slots, 1), dtype=torch.int32, device=dev)
        self.step_lengths = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self._host_tokens = torch.zeros((n_slots, 1), dtype=torch.int32, pin_memory=on_card)
        self._host_lengths = torch.zeros((n_slots,), dtype=torch.int32, pin_memory=on_card)
        self.captured = None  # on the card, the step captured in a CUDA graph
        if on_card:
            self.captured = CapturedStep(self._decode, dev)
            for t in tree_leaves(self.mgr.cache):  # undo the eager call's writes
                t.zero_()

    @torch.no_grad()
    def _decode(self):
        logits, new = self.model.decode_step(self.params, self.step_tokens, self.mgr.cache,
                                             self.step_lengths)
        copy_into(self.mgr.cache, new)  # an SSM state comes back as new tensors
        return logits, logits.argmax(-1)

    def submit(self, req: GenRequest) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        while self.queue and self.mgr.allocate(self.queue[0].request_id):
            req = self.queue.popleft()
            self.running[req.request_id] = req

    def step(self) -> int:
        """One continuous-batching iteration; returns #running requests."""
        self._admit()
        if not self.running:
            return 0
        toks = self._host_tokens.numpy()
        lengths = self._host_lengths.numpy()
        toks[:] = 0
        lengths[:] = 0
        for rid, req in self.running.items():
            slot = self.mgr.slots[rid]
            if req.in_prefill:
                toks[slot.idx, 0] = req.prompt[req._consumed]
            else:
                toks[slot.idx, 0] = (req.generated[-1] if req.generated
                                     else (req.prompt[-1] if req.prompt else 1))
            lengths[slot.idx] = slot.length
        self.step_tokens.copy_(self._host_tokens, non_blocking=True)
        self.step_lengths.copy_(self._host_lengths, non_blocking=True)
        if self.captured is not None:
            self.captured.replay()
            self.logits, best = self.captured.out
        else:
            self.logits, best = self._decode()
        best = best.cpu().numpy()
        for rid, req in list(self.running.items()):
            slot = self.mgr.slots[rid]
            slot.length = min(slot.length + 1, self.mgr.max_len - 1)
            if req.in_prefill:
                req._consumed += 1
                if not req.in_prefill:
                    # the logits after the final prompt token ARE the first
                    # generation — capture them, don't re-feed the prompt end
                    req.generated.append(int(best[slot.idx]))
            else:
                req.generated.append(int(best[slot.idx]))
            if req.done:
                del self.running[rid]
                self.mgr.release(rid)
                self.completed[rid] = req
        self.steps += 1
        return len(self.running)

    def run_to_completion(self, max_steps: int = 1000) -> Dict[str, List[int]]:
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                break
        return {rid: req.generated for rid, req in self.completed.items()}
