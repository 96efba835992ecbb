"""Continuous-batching LM decode engine (`repro.serving.lm_engine`).

A fixed pool of `slots` decodes in lock-step (one `decode_step` per
tick); finished sequences free their slot, queued requests claim freed
slots mid-flight. Prompts are consumed one token per tick, like the
reference (decode-only, no prefill). Adaptive-depth decoding waits for
ROADMAP A10.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import decoder_lm as M


@dataclasses.dataclass
class LMRequest:
    rid: int
    prompt: List[int]
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    submitted_s: float = 0.0
    done_s: float = -1.0


@dataclasses.dataclass
class _Slot:
    req: Optional[LMRequest] = None
    pending: List[int] = dataclasses.field(default_factory=list)


class LMServingEngine:
    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 256,
                 eos_id: int = -1, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.slots = [_Slot() for _ in range(slots)]
        self.max_len = max_len
        self.eos_id = eos_id
        self.queue: Deque[LMRequest] = deque()
        self.cache = M.init_cache(cfg, slots, max_len, self.device)
        self.ticks = 0
        self.completed: List[LMRequest] = []

    # -------------------------------------------------------------- control
    def submit(self, prompt: List[int], max_new: int = 16) -> LMRequest:
        req = LMRequest(rid=len(self.completed) + len(self.queue),
                        prompt=list(prompt), max_new=max_new,
                        submitted_s=time.perf_counter())
        self.queue.append(req)
        return req

    def _fill_slots(self):
        for s in self.slots:
            if s.req is None and self.queue:
                s.req = self.queue.popleft()
                s.pending = list(s.req.prompt)

    @property
    def active(self) -> int:
        return sum(s.req is not None for s in self.slots)

    # ----------------------------------------------------------------- tick
    def tick(self) -> int:
        """One decode step for every live lane; returns how many requests
        finished. Lock-step position, as in the reference: every lane
        writes the engine clock's position (ticks % max_len), so lanes
        that joined late waste leading cache slots and attend to the
        zeroed entries there (per-lane validity masks are the noted
        follow-up)."""
        self._fill_slots()
        if self.active == 0:
            return 0
        toks = np.zeros((len(self.slots), 1), np.int64)
        for i, s in enumerate(self.slots):
            if s.req is None:
                continue
            toks[i, 0] = (s.pending.pop(0) if s.pending
                          else (s.req.out[-1] if s.req.out else 0))
        pos = self.ticks % self.max_len
        logits, self.cache = M.decode_step(
            self.cfg, self.params, self.cache,
            torch.from_numpy(toks).to(self.device), pos)
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        done = 0
        for i, s in enumerate(self.slots):
            if s.req is None:
                continue
            if s.pending:                 # still consuming the prompt
                continue
            s.req.out.append(int(nxt[i]))
            finished = (len(s.req.out) >= s.req.max_new
                        or int(nxt[i]) == self.eos_id
                        or self.ticks >= self.max_len - 2)
            if finished:
                s.req.done_s = time.perf_counter()
                self.completed.append(s.req)
                s.req = None
                done += 1
        self.ticks += 1
        return done

    def run_until_drained(self, max_ticks: int = 10_000) -> Dict[str, float]:
        while (self.queue or self.active) and self.ticks < max_ticks:
            self.tick()
        lat = [r.done_s - r.submitted_s for r in self.completed
               if r.done_s > 0]
        return {
            "completed": len(self.completed),
            "ticks": self.ticks,
            "mean_latency_s": float(np.mean(lat)) if lat else 0.0,
            # no adaptive depth in the port yet: nothing is saved
            "mean_depth_flops_saved": 0.0,
        }
