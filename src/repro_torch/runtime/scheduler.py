"""Host-side serving policy: request lifecycle, admission planning and
the prefill→decode transfer of disaggregated serving (port of
`repro.runtime.scheduler`).

Every HOST decision lives here, every DEVICE computation in
`runtime.workers`: the Scheduler owns the FIFO queue, the per-slot request
registries, the `pages.HostPool` mirror(s), the prefix registry and the
finished-result list, and the speculation totals that `finish` folds
each request's drafted/accepted counters into.  `plan_round` is the
admission policy — FIFO with backpressure, prefix matching, LRU eviction
of idle cached chains, and the mirror's admit-round replay that pins every
granted page id host-side — and returns an `AdmissionRound` the
PrefillWorker executes.  `plan_transfers` is the disaggregated analogue
for the handoff: it moves a prefilled request's bookkeeping between the
two mirrors (the destination ids by the same lowest-free-id grant rule —
I7) and backpressures FIFO when no decode slot is free or the decode pool
is dry.

A colocated engine aliases the two sides (`decode_pool is pool`,
`decode_slot_req is slot_req`), so the single-pool engine runs one code
path; a disaggregated engine calls `attach_decode` to give the decode side
its own mirror and slot registry.
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
    # prefix-cache keys, hashed once at submit: prefix_keys[i] identifies
    # the (i+1)*prefix_chunk-token prefix of `prompt`
    prefix_keys: tuple = ()
    stop_tokens: tuple = ()       # per-request stop set
    requested: int = 0            # max_new_tokens as asked (pre-clamp)
    clamped: bool = False         # budget clamped by max_seq at submit
    aborted: bool = False
    prefill_tokens: int = 0       # prompt tokens whose prefill compute ran
    drafted_tokens: int = 0       # speculative drafts proposed for it
    accepted_tokens: int = 0      # of those, emitted
    pages_shared: int = 0         # prefix pages mapped read-only at admit
    result: RequestResult | None = None   # set when the request completes


@dataclasses.dataclass
class AdmissionRound:
    """One admission round, fully decided on the host: which requests land
    in which slots, the page-pool transaction (already replayed in the
    HostPool mirror) and the chunk schedule.  An empty `admitted` with a
    non-empty `evict_delta` is an eviction-only round whose refcount
    decrements still must land on the device pool."""
    admitted: list            # [(slot, Request)] ascending slot order
    plan: dict                # slot -> (m_len, full_ids, cow_src, n_fresh)
    starts: dict              # slot -> first prefill chunk offset
    n_chunks: dict            # slot -> prefill chunk count
    evict_delta: dict         # page -> refcount decrement (registry evict)
    reg_delta: dict           # page -> refcount increment (registration)
    chunks_skipped: int = 0   # warm-prefix chunks admission never ran


@dataclasses.dataclass
class Transfer:
    """One prefill→decode handoff, decided on the host: the destination
    ids come from the decode mirror's own lowest-free-id grant pass (I7),
    so the device export/import needs no sync."""
    req: Request
    src_slot: int             # prefill-side slot being vacated
    dst_slot: int             # decode-side slot receiving the request
    src_ids: list             # prefill-pool pages, block-table order
    dst_ids: list             # decode-pool pages granted for them
    n: int                    # live pages transferred


class Scheduler:
    """Request lifecycle + admission/transfer policy; no device state."""

    def __init__(self, *, num_slots: int, max_seq: int, page_size: int,
                 prefill_chunk: int, paged: bool, num_pages: int,
                 stop_cap: int, stop_tokens: tuple,
                 prefix: pg.PrefixCache | None):
        self.num_slots = num_slots          # admission-side slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.prefill_chunk = prefill_chunk
        self.paged = paged
        self.num_pages = num_pages          # admission-side pool size
        self.stop_cap = stop_cap
        self.stop_tokens = stop_tokens
        self.prefix = prefix
        self.pool: pg.HostPool | None = \
            pg.HostPool(num_pages, num_slots) if paged else None
        self.slot_req: list[Request | None] = [None] * num_slots
        self.queue: list[Request] = []
        self.finished: list[RequestResult] = []
        # colocated: the decode side IS the admission side;
        # attach_decode breaks the alias for disaggregation
        self.decode_pool = self.pool
        self.decode_slot_req = self.slot_req
        self.decode_pages = num_pages
        self.disagg = False
        # disagg: prefilled requests awaiting their page transfer, FIFO
        self.ready: list[Request] = []
        self._ready_slot: dict[int, int] = {}     # uid -> prefill slot
        self._next_uid = itertools.count()
        # speculation totals over finished requests (finish folds them in)
        self.tokens_drafted = 0
        self.tokens_accepted = 0
        self.transfers_backpressured = 0

    def attach_decode(self, num_slots: int, num_pages: int) -> None:
        """Give the decode side its own mirror and slot registry
        (disaggregation); admission keeps the prefill-side pool."""
        self.decode_pool = pg.HostPool(num_pages, num_slots)
        self.decode_slot_req = [None] * num_slots
        self.decode_pages = num_pages
        self.disagg = True

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
        if self.paged:
            need = self._need_pages(len(prompt), max_new_tokens)
            cap = min(self.num_pages, self.decode_pages)
            if need > cap:
                raise ValueError(
                    f"request needs {need} pages ({len(prompt)} prompt + "
                    f"{max_new_tokens} new tokens at page_size="
                    f"{self.page_size}) but the pool only has {cap}")
        uid = next(self._next_uid)
        req = Request(uid=uid, prompt=prompt, max_new_tokens=max_new_tokens,
                      seed=uid if seed is None else int(seed),
                      t_submit=time.perf_counter(), stop_tokens=stop,
                      requested=requested, clamped=clamped)
        if self.prefix is not None:
            # hashed once, here: admission only compares precomputed keys
            req.prefix_keys = self.prefix.keys_for(prompt)
        self.queue.append(req)
        return req

    def plan_round(self) -> AdmissionRound | None:
        """Decide one admission round: FIFO over the queue into free slots,
        with the paged bookkeeping (prefix matching, LRU eviction,
        backpressure, mirror grant replay).  A head that cannot get its
        pages holds the WHOLE queue (skipping it would make admission order
        depend on pool state).  Returns None when nothing happened; an
        empty `admitted` is an eviction-only round."""
        ns, C = self.num_slots, self.prefill_chunk
        paged = self.paged
        admitted: list[tuple[int, Request]] = []
        # slot -> (matched_len, shared ids, cow page, fresh pages)
        plan: dict[int, tuple[int, list, int, int]] = {}
        evict_delta: dict[int, int] = {}
        reg_delta: dict[int, int] = {}
        if paged:
            # decisions on COUNTS only: `eff` accumulates this round's
            # pending share bumps and eviction decrements; page ids are
            # assigned once, at the end, like the device's grant pass
            eff = self.pool.refs.copy()
            free_cnt = int((eff == 0).sum())
        for slot in range(ns):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue[0]
            if paged:
                if self.prefix is not None:
                    # pure planning: telemetry and the LRU tick land in
                    # `commit`, once the request admits
                    m_len, full, cow, mkey = self.prefix.match(
                        req.prefix_keys, len(req.prompt))
                else:
                    m_len, full, cow, mkey = 0, [], -1, None
                need = self._need_pages(len(req.prompt), req.max_new_tokens)
                n_fresh = need - len(full)
                # shares first: they may resurrect a cached page whose
                # refcount would otherwise read as free
                for p in full:
                    if eff[p] == 0:
                        free_cnt -= 1
                    eff[p] += 1
                if n_fresh > free_cnt and self.prefix is not None:
                    # pool dry: evict idle cached prefixes (LRU) first
                    free_cnt += self.prefix.evict(n_fresh - free_cnt, eff,
                                                  evict_delta)
                if n_fresh > free_cnt:
                    # still dry: roll the shares back and hold the queue
                    for p in full:
                        eff[p] -= 1
                        if eff[p] == 0:
                            free_cnt += 1
                    break
                free_cnt -= n_fresh
                plan[slot] = (m_len, full, cow, n_fresh)
                if self.prefix is not None:
                    self.prefix.commit(mkey, m_len)
            self.queue.pop(0)
            self.slot_req[slot] = req
            admitted.append((slot, req))
        if not admitted:
            if paged and evict_delta:
                # the registry already dropped its chains: the decrements
                # must land although nothing admits, or the pages leak
                self.pool.apply_delta(evict_delta)
                return AdmissionRound([], {}, {}, {}, evict_delta, {})
            return None
        if paged:
            # assign page ids (lowest free first, slots ascending) and
            # register the admitted prompts' chains for later rounds; a
            # chain is matchable only after its producer's prefill ran
            granted = self.pool.admit_round(
                [(s, plan[s][1], plan[s][3]) for s, _ in admitted],
                evict_delta)
            if self.prefix is not None:
                for slot, req in admitted:
                    self.prefix.register(req.prefix_keys,
                                         plan[slot][1] + granted[slot],
                                         reg_delta)
                self.pool.apply_register(reg_delta)
        starts = {s: plan[s][0] if paged else 0 for s, _ in admitted}
        n_chunks = {s: max(1, -(-(len(r.prompt) - starts[s]) // C))
                    for s, r in admitted}
        skipped = 0
        for slot, req in admitted:
            req.prefill_tokens = len(req.prompt) - starts[slot]
            req.pages_shared = len(plan[slot][1]) if paged else 0
            if paged:
                skipped += max(1, -(-len(req.prompt) // C)) - n_chunks[slot]
        return AdmissionRound(admitted, plan, starts, n_chunks,
                              evict_delta, reg_delta, skipped)

    # ------------------------------------------------------------------
    # disagg transfer policy
    # ------------------------------------------------------------------

    def mark_ready(self, slot: int) -> None:
        """Disagg: the prefill worker finished `slot`'s prompt; queue it
        (FIFO) for the page transfer into the decode pool."""
        req = self.slot_req[slot]
        self.ready.append(req)
        self._ready_slot[req.uid] = slot

    def drop_ready(self, req: Request) -> int:
        """Remove an aborted request from the transfer queue; returns the
        prefill slot it still occupies (the caller releases it)."""
        self.ready.remove(req)
        return self._ready_slot.pop(req.uid)

    def plan_transfers(self) -> list[Transfer]:
        """This round's prefill→decode handoffs, FIFO over the ready list.
        A transfer needs a free decode slot and enough free decode pages
        for the request's whole table; when either is missing the WHOLE
        list waits (no overtaking, as in admission) and the wait is
        counted — the decode tick reclaims pages as requests end.  Both
        mirrors are updated here (destination grant, source release), so
        the device export/import that follows needs no sync."""
        out: list[Transfer] = []
        while self.ready:
            req = self.ready[0]
            src = self._ready_slot[req.uid]
            n = len(self.pool.slot_tables[src])
            dst = next((s for s, r in enumerate(self.decode_slot_req)
                        if r is None), None)
            if dst is None or n > self.decode_pool.free_pages:
                self.transfers_backpressured += 1
                break
            self.ready.pop(0)
            del self._ready_slot[req.uid]
            src_ids = list(self.pool.slot_tables[src])
            granted = self.decode_pool.admit_round([(dst, [], n)], {})
            self.decode_slot_req[dst] = req
            # the export releases the source refs in the same worker call
            # that gathers the tiles; replay it here
            self.pool.release_slot(src)
            self.slot_req[src] = None
            out.append(Transfer(req, src, dst, src_ids, granted[dst], n))
        return out

    # ------------------------------------------------------------------
    # retirement
    # ------------------------------------------------------------------

    def release_admit_slot(self, slot: int) -> None:
        """Retire a request from its admission-side slot (a first-token
        termination, or a disagg abort before transfer): free the slot,
        replay the device release in the admission mirror, seal it."""
        req = self.slot_req[slot]
        self.slot_req[slot] = None
        if self.pool is not None:
            self.pool.release_slot(slot)
        self.finish(req)

    def release_decode_slot(self, slot: int) -> None:
        """Retire a request from its decode-side slot (the tick's normal
        completion path; the same as `release_admit_slot` on a colocated
        engine, whose two sides alias)."""
        req = self.decode_slot_req[slot]
        self.decode_slot_req[slot] = None
        if self.decode_pool is not None:
            self.decode_pool.release_slot(slot)
        self.finish(req)

    def finish(self, req: Request) -> None:
        """Seal a completed request: classify the finish reason (highest
        precedence first), build its RequestResult and fold its speculation
        counters into the totals."""
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
        self.tokens_drafted += req.drafted_tokens
        self.tokens_accepted += req.accepted_tokens
        req.result = RequestResult(
            uid=req.uid, tokens=tuple(out), finish_reason=reason,
            prefill_tokens=req.prefill_tokens,
            drafted_tokens=req.drafted_tokens,
            accepted_tokens=req.accepted_tokens,
            pages_shared=req.pages_shared,
            ttft=(req.t_first - req.t_submit) if req.t_first else None)
        self.finished.append(req.result)
