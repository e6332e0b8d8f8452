"""Host-side serving policy: request lifecycle and admission planning
(port of `repro.runtime.scheduler`, colocated engine, without the prefix
cache and disaggregation, which come with later slices).

Every HOST decision lives here, every DEVICE computation in
`runtime.workers`: the Scheduler owns the FIFO queue, the per-slot request
registry, the `pages.HostPool` mirror and the finished-result list.
`plan_round` is the admission policy — FIFO with backpressure and the
mirror's admit-round replay that pins every granted page id host-side —
and returns an `AdmissionRound` the PrefillWorker executes.
"""
from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np

from repro_torch.runtime import pages as pg
from repro_torch.runtime.options import RequestResult


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int           # effective budget (clamped to max_seq room)
    seed: int = 0
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_first: float = 0.0          # wall time the first token landed (TTFT)
    stop_tokens: tuple = ()       # per-request stop set
    requested: int = 0            # max_new_tokens as asked (pre-clamp)
    clamped: bool = False         # budget clamped by max_seq at submit
    aborted: bool = False
    prefill_tokens: int = 0       # prompt tokens whose prefill compute ran
    result: RequestResult | None = None   # set when the request completes


@dataclasses.dataclass
class AdmissionRound:
    """One admission round, fully decided on the host: which requests land
    in which slots, the fresh pages each needs (already granted in the
    HostPool mirror) and the chunk count of each prompt."""
    admitted: list            # [(slot, Request)] ascending slot order
    new_pages: dict           # slot -> fresh pages granted
    n_chunks: dict            # slot -> prefill chunk count


class Scheduler:
    """Request lifecycle + admission policy; no device state."""

    def __init__(self, *, num_slots: int, max_seq: int, page_size: int,
                 prefill_chunk: int, num_pages: int, stop_cap: int,
                 stop_tokens: tuple):
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.prefill_chunk = prefill_chunk
        self.num_pages = num_pages
        self.stop_cap = stop_cap
        self.stop_tokens = stop_tokens
        self.pool = pg.HostPool(num_pages, num_slots)
        self.slot_req: list[Request | None] = [None] * num_slots
        self.queue: list[Request] = []
        self.finished: list[RequestResult] = []
        self._next_uid = itertools.count()

    def _need_pages(self, prompt_len: int, max_new: int) -> int:
        """Pages a request occupies for its whole lifetime: prompt rows plus
        one KV row per decode step (the first token comes from the prefill
        logits), clipped to the max_seq-1 generation ceiling."""
        rows = min(prompt_len + max_new - 1, self.max_seq - 1)
        return -(-rows // self.page_size)

    def submit(self, prompt, max_new_tokens: int = 16,
               seed: int | None = None,
               stop_tokens: tuple | None = None) -> Request:
        """Queue a prompt; validation and deterministic budget clamping."""
        prompt = np.asarray(prompt, np.int32)
        if not 1 <= len(prompt) <= self.max_seq - 1:
            raise ValueError(f"prompt length {len(prompt)} must be in "
                             f"[1, max_seq-1={self.max_seq - 1}]")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        stop = self.stop_tokens if stop_tokens is None \
            else tuple(int(t) for t in stop_tokens)
        if len(stop) > self.stop_cap:
            raise ValueError(
                f"stop_tokens holds {len(stop)} ids but this engine was "
                f"built with capacity {self.stop_cap} (max(4, "
                f"len(default stop set)))")
        requested = max_new_tokens
        clamped = len(prompt) + max_new_tokens > self.max_seq
        if clamped:
            # the decode loop stops at the max_seq - 1 ceiling anyway;
            # clamping here keeps pages and the finish reason honest
            max_new_tokens = self.max_seq - len(prompt)
        need = self._need_pages(len(prompt), max_new_tokens)
        if need > self.num_pages:
            raise ValueError(
                f"request needs {need} pages ({len(prompt)} prompt + "
                f"{max_new_tokens} new tokens at page_size="
                f"{self.page_size}) but the pool only has {self.num_pages}")
        uid = next(self._next_uid)
        req = Request(uid=uid, prompt=prompt, max_new_tokens=max_new_tokens,
                      seed=uid if seed is None else int(seed),
                      t_submit=time.perf_counter(), stop_tokens=stop,
                      requested=requested, clamped=clamped)
        self.queue.append(req)
        return req

    def plan_round(self) -> AdmissionRound | None:
        """Decide one admission round: FIFO over the queue into free slots;
        a head that needs more pages than are free holds the WHOLE queue
        (skipping it would make admission order depend on pool state).
        Returns None when nothing is admitted."""
        admitted: list[tuple[int, Request]] = []
        fresh: dict[int, int] = {}
        free_cnt = self.pool.free_pages
        for slot in range(self.num_slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue[0]
            need = self._need_pages(len(req.prompt), req.max_new_tokens)
            if need > free_cnt:
                break
            free_cnt -= need
            fresh[slot] = need
            self.queue.pop(0)
            self.slot_req[slot] = req
            admitted.append((slot, req))
        if not admitted:
            return None
        self.pool.admit_round([(s, [], fresh[s]) for s, _ in admitted], {})
        C = self.prefill_chunk
        n_chunks = {s: max(1, -(-len(r.prompt) // C)) for s, r in admitted}
        for _, req in admitted:
            req.prefill_tokens = len(req.prompt)
        return AdmissionRound(admitted, fresh, n_chunks)

    def release_slot(self, slot: int) -> None:
        """Retire the request in `slot`: free the slot, replay the device
        release in the mirror, seal the request."""
        req = self.slot_req[slot]
        self.slot_req[slot] = None
        self.pool.release_slot(slot)
        self.finish(req)

    def finish(self, req: Request) -> None:
        """Seal a completed request: classify the finish reason (highest
        precedence first) and build its RequestResult."""
        req.done = True
        out = req.out_tokens
        if req.aborted:
            reason = "aborted"
        elif out and out[-1] in req.stop_tokens:
            reason = "eos"
        elif req.clamped and len(out) >= req.max_new_tokens:
            reason = "max_seq"
        elif len(out) >= req.max_new_tokens:
            reason = "budget"
        else:
            reason = "max_seq"
        req.result = RequestResult(
            uid=req.uid, tokens=tuple(out), finish_reason=reason,
            prefill_tokens=req.prefill_tokens,
            ttft=(req.t_first - req.t_submit) if req.t_first else None)
        self.finished.append(req.result)
