"""Batched serving engine: continuous-batching-lite decode loop over
``Model.decode_step``, with per-slot request lifecycle (admit → decode →
finish).

Torch counterpart of ``repro/serve/engine.py``, with the same lifecycle,
greedy sampling and step schedule.  Two behaviours of the reference are
kept as they are (ROADMAP.md §3): one ``pos`` serves every slot (the
largest over active slots), and admission feeds the prompt one token per
step at positions 0, 1, … with token 0 in every other slot, so every slot's
cache rows at those positions are overwritten.  For a recurrent ("rglru")
layer that token 0 also advances every other slot's state (``h`` and
``conv``), including slots that are already decoding.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..models.lm import Model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int = 16
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    """Fixed-slot batched decoding.  Admission fills empty slots; every step
    decodes one token for all active slots (padding token for idle ones).
    The engine runs on its model's device."""

    def __init__(self, model: Model, batch_slots: int = 4, max_seq: int = 256):
        self.device = model.device
        self.model = model
        self.slots = batch_slots
        self.max_seq = max_seq
        self._requests: List[Optional[Request]] = [None] * batch_slots
        self._pos = np.zeros(batch_slots, np.int32)
        self.cache = model.init_cache(batch_slots, max_seq)
        self.steps = 0

    def _decode(self, toks: np.ndarray, pos: int) -> torch.Tensor:
        token = torch.as_tensor(toks, dtype=torch.int64).to(self.device)
        logits, self.cache = self.model.decode_step(self.cache, token, pos)
        return logits

    # Greedy sampling (temperature 0) keeps the engine deterministic for tests.
    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        return logits[:, -1].argmax(dim=-1).to(torch.int32).cpu().numpy()

    def admit(self, req: Request) -> bool:
        for i, slot in enumerate(self._requests):
            if slot is None:
                self._requests[i] = req
                # Prefill the slot by feeding prompt tokens one at a time
                # (one decode path for everything, as the reference does).
                for j, tok in enumerate(req.prompt):
                    t = np.zeros((self.slots, 1), np.int32)
                    t[i, 0] = int(tok)
                    self._decode(t, j)
                self._pos[i] = len(req.prompt)
                return True
        return False

    def step(self) -> None:
        active = [i for i, r in enumerate(self._requests) if r is not None]
        if not active:
            return
        toks = np.zeros((self.slots, 1), np.int32)
        for i in active:
            r = self._requests[i]
            toks[i, 0] = r.output[-1] if r.output else (r.prompt[-1] if len(r.prompt) else 1)
        pos = int(max(self._pos[i] for i in active))
        nxt = self._sample(self._decode(toks, pos))
        for i in active:
            r = self._requests[i]
            r.output.append(int(nxt[i]))
            self._pos[i] += 1
            if len(r.output) >= r.max_new_tokens or self._pos[i] >= self.max_seq - 1:
                r.done = True
                self._requests[i] = None
        self.steps += 1

    def run(self, requests: List[Request], max_steps: int = 512) -> List[Request]:
        pending = list(requests)
        while (pending or any(r is not None for r in self._requests)) and self.steps < max_steps:
            while pending and self.admit(pending[0]):
                pending.pop(0)
            self.step()
            if all(r.done for r in requests):
                break
        return requests
