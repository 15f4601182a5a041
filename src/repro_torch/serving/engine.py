"""Continuous-batching serving engine.

Mirrors the reference's ``serving/engine.py``.  A fixed pool of
``max_batch`` decode slots shares one decode step.  Requests join free
slots as they open; every engine step advances ALL active slots by one
token with **per-slot positions** (the vector-``pos`` decode path) — a
new request prefilling its prompt rides in the same batched step as a
request 500 tokens into generation.  Finished slots are recycled without
disturbing neighbours.

The KV caches live on the device and are updated in place: the decode
step writes each slot's new key and value with ``index_copy_``, and a
recycled slot's rows are zeroed with ``zero_`` (the reference rebuilds
the cache pytree for both).  Tokens are chosen on the host with
``np.argmax``, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.pytree import tree_leaves
from repro_torch.models.model import decode_step, init_caches
from repro_torch.serving.admission import AdmissionQueue

__all__ = ["Request", "ServingEngine"]


@dataclass
class Request:
    uid: int
    prompt: list            # token ids
    max_new: int = 16
    eos: int | None = None
    out: list = field(default_factory=list)

    @property
    def done(self) -> bool:
        if self.eos is not None and self.eos in self.out:
            return True
        return len(self.out) >= self.max_new


class ServingEngine:
    def __init__(self, cfg, params, *, max_batch: int = 8, cache_len: int = 256,
                 ring: bool = False, device=None):
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.ring = ring
        self.device = resolve_device(device)
        self.caches = init_caches(cfg, max_batch, cache_len, device=self.device)
        self._adm = AdmissionQueue(max_batch, on_admit=self._reset_slot)
        self.pos = np.zeros(max_batch, np.int32)        # next position per slot
        self.cursor = np.zeros(max_batch, np.int32)     # prompt cursor per slot

    @property
    def queue(self):
        return self._adm.pending

    @property
    def slots(self) -> list[Request | None]:
        return self._adm.slots

    def submit(self, req: Request) -> None:
        self._adm.submit(req)

    def _reset_slot(self, i: int, req: Request) -> None:
        self.pos[i] = 0
        self.cursor[i] = 0
        # reset the slot's cache rows (axis 1 of every stacked leaf):
        # attention rows are position-masked anyway, but recurrent state
        # carries no positions and must be zeroed on recycle
        for c in tree_leaves(self.caches):
            c[:, i].zero_()

    def _admit(self) -> None:
        self._adm.admit()

    def _next_tokens(self, last_logits) -> torch.Tensor:
        """Choose each slot's next input token: prompt feed or greedy."""
        toks = np.zeros((self.max_batch, 1), np.int32)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if self.cursor[i] < len(req.prompt):
                toks[i, 0] = req.prompt[self.cursor[i]]
            elif last_logits is not None:
                toks[i, 0] = int(np.argmax(last_logits[i, -1]))
        return torch.from_numpy(toks).to(self.device)

    @torch.no_grad()
    def step(self, last_logits=None):
        """One engine tick: admit, build the token batch, decode, collect."""
        self._admit()
        if all(r is None for r in self.slots) and not self.queue:
            return None
        toks = self._next_tokens(last_logits)
        logits, self.caches = decode_step(
            self.params, self.cfg, toks, self.caches,
            torch.from_numpy(self.pos).to(self.device), ring=self.ring)
        np_logits = logits.float().cpu().numpy()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            in_prefill = self.cursor[i] < len(req.prompt)
            if in_prefill:
                self.cursor[i] += 1
                if self.cursor[i] == len(req.prompt):
                    # last prompt token's logits produce the first new token
                    req.out.append(int(np.argmax(np_logits[i, -1])))
            else:
                req.out.append(int(np.argmax(np_logits[i, -1])))
            self.pos[i] += 1
            if req.done or self.pos[i] >= self.cache_len:
                self._adm.release(i)   # recycle the slot; cache row reused
        return np_logits

    def run(self, requests: list[Request], max_ticks: int = 10_000):
        for r in requests:
            self.submit(r)
        logits = None
        ticks = 0
        while (any(s is not None for s in self.slots) or self.queue) and \
                ticks < max_ticks:
            logits = self.step(logits)
            ticks += 1
            if logits is None:
                break
        return requests
