"""Device-facing worker roles: chunked prefill admission, the decode tick
and the two halves of a page transfer (port of `repro.runtime.workers`:
paged or dense, plain or speculative, colocated or disaggregated).

  PrefillWorker — executes a Scheduler `AdmissionRound`: fixed
                  `prefill_chunk`-token chunks, all admitting slots per
                  call; under the paged layout the first chunk carries the
                  round's whole pool transaction (evict → share → grant →
                  register) and the copy-on-write split, and a warm slot's
                  chunks start at its matched prefix length; the final
                  chunk of each prompt samples its first token on the
                  device and commits the slot state.  Under speculation it
                  also seeds the drafter: reset on a slot's first chunk,
                  observe the chunk's real tokens, and observe the sampled
                  first token on the final chunk.  `export_request`
                  (disaggregation) gathers a prefilled request's page tiles
                  and slot scalars, takes its sampling generator out of the
                  slot, and releases the source references in the same
                  call (I7).
  DecodeWorker  — the tick: `decode_steps` decode → sample → terminate
                  steps over every slot, or the speculative variant (draft
                  → verify the window in one forward → accept/replace →
                  clamp → roll back the rejected rows → observe); under the
                  paged layout, slots that terminate release their pages
                  before the host looks.  `import_request`
                  (disaggregation) writes exported tiles into this pool's
                  granted pages, adopts them into the slot's block table
                  and installs the slot scalars and generator.

Both run eagerly on device tensors and never read a device value back: the
Engine syncs once per tick and once per admission round.  The host arrays
of a whole admission round are uploaded in one copy.

Under the mesh Engine's data split (`SlotBlock`) a worker holds every
slot's scalars, stop rows and block tables, and the whole page pool, but
runs each forward on its block of slots only, against per-slot caches
and drafter state of that block.  One all-gather over `data` after each
forward (decode step, verify window, admission chunk) brings the tokens
the other blocks sampled and the pool rows they wrote, which land
through the same targets; every rank then updates the slot state and the
allocator over all slots alike, so the replicated Scheduler decides the
same thing everywhere and the pools stay bit-equal (in an arch with a
MoE layer the pool rows travel in each paged layer instead, before it
reads: `SlotBlock.per_layer`).  A slot's sampling generator draws on the
rank that owns the slot only.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.parallel import comm
from repro_torch.tree import tree_leaves
from repro_torch.runtime import pages as pg
from repro_torch.runtime import sampling as smp
from repro_torch.runtime import speculate as spc


class SlotState(NamedTuple):
    """Per-slot decode state; device tensors for all slots, plus each
    slot's sampling stream (the request's `torch.Generator`, None when the
    slot holds no request or the sampling is greedy).  `draft` is the
    drafter's state (zero-width when speculation is off): the n-gram tables
    (`speculate.DraftState`) or the model drafter's private draft KV cache
    (`speculate.QuantDraftState`)."""
    last_tok: torch.Tensor   # (S,) i32  last sampled token (next input)
    pos: torch.Tensor        # (S,) i32  next cache index to write
    budget: torch.Tensor     # (S,) i32  tokens still to emit after this one
    active: torch.Tensor     # (S,) bool slot is mid-generation
    stop: torch.Tensor       # (S, K) i32 per-request stop set, -1 padded
    pages: pg.PagePool       # refcounted page allocator (paged layout)
    gens: tuple              # (S,) torch.Generator | None
    draft: Any               # drafter state (n-gram tables / draft KV)
    n_drafted: torch.Tensor  # (S,) i32 drafted tokens, current occupant
    n_accepted: torch.Tensor  # (S,) i32 drafted tokens emitted


def init_slot_state(num_slots: int, stop_cap: int, table_len: int,
                    num_pages: int, device, draft) -> SlotState:
    z = torch.zeros((num_slots,), dtype=torch.int32, device=device)
    return SlotState(
        last_tok=z, pos=z.clone(), budget=z.clone(),
        active=torch.zeros((num_slots,), dtype=torch.bool, device=device),
        stop=torch.full((num_slots, stop_cap), -1, dtype=torch.int32,
                        device=device),
        pages=pg.init_pool(num_slots, table_len, num_pages, device),
        gens=(None,) * num_slots, draft=draft, n_drafted=z.clone(),
        n_accepted=z.clone())


@dataclasses.dataclass(frozen=True)
class SlotBlock:
    """The slots [lo, hi) this rank's forwards run and the `data` group
    (None: no split, every slot here) that exchanges their results; see
    the module docstring.  `per_layer` (an arch with a MoE layer): the
    pool rows are exchanged in each paged layer, after its writes and
    before its reads, not once after the forward.  A free slot's stale
    block table may name a page that another rank's slot writes in the
    same forward; the meshless Engine's padding row for it reads that
    write, and MoE routes padding rows with the real ones, so capacity
    drops would differ unless the write has landed."""
    lo: int
    hi: int
    group: Any = None
    per_layer: bool = False

    def take(self, t):
        """This block's rows of a per-slot tensor (or tuple)."""
        return t[self.lo:self.hi] if self.group is not None else t

    def _share(self, leaves, pv, positions, tensors) -> list:
        """ONE all-gather over `data` of `tensors` (the block's rows) and
        of the rows the block wrote into the pool `leaves` (each with a
        leading period axis) through `pv` at `positions` (S, L); every
        slot's rows then land in `leaves` through `pv`'s targets.
        Returns `tensors` over every slot."""
        rows = []
        if leaves:
            page, row, ok = attn.paged_targets(positions, pv)
            L = positions.shape[1]
            mine = slice(self.lo * L, self.hi * L)
            rows = pg.rows_of(leaves, page[mine], row[mine])
        got = comm.all_gather_many(rows + list(tensors), self.group)
        if rows:
            pg.put_rows(leaves, page, row, ok, got[:len(rows)])
        return got[len(rows):]

    def kv(self, pv, positions):
        """The block's rows of a PagedKV / DenseKV bundle over every slot
        that writes at `positions` (S, L); under `per_layer` the PagedKV
        carries the layer exchange (`attention.PagedKV.sync`)."""
        if self.group is None or pv is None:
            return pv
        if isinstance(pv, attn.DenseKV):
            return dataclasses.replace(
                pv, write_mask=self.take(pv.write_mask),
                bound=None if pv.bound is None else self.take(pv.bound))
        sync = None
        if self.per_layer:
            def sync(cache):
                self._share([cache[k][None] for k in sorted(cache)], pv,
                            positions, ())
        return dataclasses.replace(
            pv, tables=self.take(pv.tables), n_pages=self.take(pv.n_pages),
            write_mask=self.take(pv.write_mask),
            owned=None if pv.owned is None else self.take(pv.owned),
            bound=None if pv.bound is None else self.take(pv.bound),
            sync=sync)

    def exchange(self, caches, pool_flags, pv, positions, *tensors):
        """After a forward on the block, in ONE all-gather over `data`:
        `tensors` (the block's rows) come back over every slot, and,
        when `pv` is a PagedKV bundle over every slot (and the layers did
        not exchange them), the pool rows each block wrote at `positions`
        (S, L) land in this rank's pool through `pv`'s targets."""
        if self.group is None:
            return list(tensors)
        leaves = [leaf for leaf, is_pool in zip(tree_leaves(caches),
                                                tree_leaves(pool_flags))
                  if is_pool] \
            if isinstance(pv, attn.PagedKV) and not self.per_layer else []
        return self._share(leaves, pv, positions, tensors)


def _bundle(pool: pg.PagePool, max_seq: int, page_size: int, write_mask,
            kernel: bool = False, bound=None) -> attn.PagedKV:
    """The PagedKV bundle for one call: `owned` drops writes aimed at
    pages a slot does not own (shared prefix pages); `kernel` routes Sq=1
    reads through the paged-decode kernels; `bound` (speculation) also
    drops rows at or past the per-slot accepted-length bound."""
    return attn.PagedKV(tables=pool.tables, n_pages=pool.n_pages,
                        write_mask=write_mask, max_seq=max_seq,
                        page_size=page_size, owned=pool.owned, bound=bound,
                        decode_kernel=kernel)


@functools.lru_cache(maxsize=None)
def _state_fills(cfg) -> tuple:
    """The init value of each per-slot cache leaf (recurrent state), in
    `tree_leaves` order.  Each such leaf is constant at init (zeros; -1e30
    for the mLSTM/sLSTM stabilizer m), so it is read once from a one-period
    batch-1 init cache on the CPU."""
    one = cfg.replace(num_layers=len(cfg.layer_pattern))
    ini = tree_leaves(M.init_cache(one, 1, 1, num_pages=1, device="cpu"))
    pool = tree_leaves(M.cache_pool_flags(cfg))
    return tuple(leaf.reshape(-1)[0].item()
                 for leaf, is_pool in zip(ini, pool) if not is_pool)


def _by_slot(mask, leaf):
    """(S,) mask broadcast over a stacked (n_periods, S, ...) cache leaf."""
    return mask.reshape((1, -1) + (1,) * (leaf.ndim - 2))


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """One host→device copy; pinned and asynchronous on CUDA."""
    t = torch.from_numpy(a)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class DecodeWorker:
    """Runs the decode tick against one pool's state."""

    def __init__(self, *, cfg, max_seq: int, decode_steps: int, sampling,
                 paged: bool, decode_kernel: bool, draft_len: int = 0,
                 block: SlotBlock, drafter=None, kv_flags=None):
        self.cfg = cfg
        self.block = block
        self.max_seq = max_seq
        self.page_size = cfg.page_size
        self.decode_steps = decode_steps
        self.sampling = sampling
        self.paged = paged
        self.decode_kernel = decode_kernel
        self.draft_len = draft_len
        self.drafter = drafter
        # pool leaves (paged) or KV leaves (dense) that rollback zeroes
        self.kv_flags = kv_flags
        # pool leaves a transfer (or a data rank's exchange) writes
        self.pool_flags = M.cache_pool_flags(cfg) if paged else None

    def tick(self, params, state: SlotState, caches):
        """`decode_steps` decode → sample → terminate steps (the speculative
        window steps when draft_len > 0).  Returns (state, caches, toks,
        emitted): (steps, S) i32 and bool, or (steps, S, draft_len + 1)
        under speculation."""
        if self.draft_len:
            return self._spec_tick(params, state, caches)
        max_seq, blk = self.max_seq, self.block
        pre_active = state.active
        toks, emits = [], []
        for _ in range(self.decode_steps):
            # paged: inactive slots must not write, since their stale
            # block-table entries may point at pages re-granted since.
            # Dense slots own their rows, so their writes need no mask
            pv = _bundle(state.pages, max_seq, self.page_size, state.active,
                         self.decode_kernel) if self.paged else None
            logits, caches = M.decode_step(
                params, blk.take(state.last_tok)[:, None], self.cfg, caches,
                blk.take(state.pos), paged=blk.kv(pv, state.pos[:, None]))
            # a slot whose request ended earlier in this tick still draws
            # from that request's generator; its stream is over, so the
            # extra draw changes nothing any request emits
            sampled = smp.sample(logits, self.sampling, blk.take(state.gens))
            sampled, = blk.exchange(caches, self.pool_flags, pv,
                                    state.pos[:, None], sampled)
            emit = state.active
            tok = torch.where(emit, sampled, state.last_tok)
            pos = torch.where(emit, state.pos + 1, state.pos)
            budget = torch.where(emit, state.budget - 1, state.budget)
            # -1-padded stop rows match no real token id
            hit_stop = emit & (tok[:, None] == state.stop).any(dim=1)
            active = emit & (budget > 0) & ~hit_stop & (pos < max_seq - 1)
            state = state._replace(last_tok=tok, pos=pos, budget=budget,
                                   active=active)
            toks.append(tok)
            emits.append(emit)
        if self.paged:
            dead = pre_active & ~state.active
            state = state._replace(pages=pg.release(state.pages, dead))
        return state, caches, torch.stack(toks), torch.stack(emits)

    def _spec_tick(self, params, state: SlotState, caches):
        """Each of the `decode_steps` steps drafts `draft_len` tokens, scores
        the window [last_tok, g_1..g_d] in ONE forward (logits[:, i]
        conditions on the first i drafts), accepts/replaces on the device
        (`sampling.spec_verify`) and clamps the emission count by stop
        tokens / budget / max_seq as the sequential loop would (A3).
        Rejected draft rows are rolled back before the step ends (A4), and
        the drafter observes only the emitted tokens."""
        max_seq, d, blk = self.max_seq, self.draft_len, self.block
        L = d + 1
        dev = state.pos.device
        idx = torch.arange(L, dtype=torch.int32, device=dev)[None]
        pre_active = state.active
        toks, emits = [], []
        for _ in range(self.decode_steps):
            active = state.active
            # the block's drafts from the block's drafter state: (S/n, d)
            drafts = self.drafter.propose(state.draft, d)
            chunk = torch.cat([blk.take(state.last_tok)[:, None], drafts],
                              dim=1)
            win = state.pos[:, None] + idx
            # rows a non-speculative run could never reach drop at write
            # time (the per-slot accepted-length bound)
            bound = state.pos + state.budget
            pv = _bundle(state.pages, max_seq, self.page_size, active,
                         bound=bound) if self.paged \
                else attn.DenseKV(write_mask=active, max_seq=max_seq,
                                  bound=bound)
            logits, _, caches = M.forward(params, {"tokens": chunk}, self.cfg,
                                          caches=caches,
                                          cache_pos=blk.take(state.pos),
                                          paged=blk.kv(pv, win))
            out, n_acc = smp.spec_verify(logits, drafts, self.sampling,
                                         blk.take(state.gens))
            out, n_acc = blk.exchange(caches, self.pool_flags, pv, win, out,
                                      n_acc)
            is_stop = (out[..., None] == state.stop[:, None, :]).any(dim=-1)
            stop_at = torch.where(is_stop, idx, L).amin(dim=1)
            # accepted drafts + the correction/bonus, clamped per token as
            # the sequential loop clamps; >= 1 for every active slot
            n_emit = torch.minimum(
                torch.minimum(n_acc + 1, stop_at + 1),
                torch.minimum(state.budget, max_seq - 1 - state.pos))
            n_emit = torch.where(active, n_emit, 0).to(torch.int32)
            emit = idx < n_emit[:, None]                          # (S, L)
            # roll back the rejected rows (window indices >= n_emit)
            rej = torch.where(emit | ~active[:, None], max_seq, win)
            if self.paged:
                pg.rollback(caches, self.kv_flags, pv, rej)
            else:
                spc.rollback_dense(caches, self.kv_flags, blk.take(rej),
                                   blk.take(active), max_seq)
            last = torch.gather(out, 1, (n_emit - 1).clamp(0, L - 1)
                                .long()[:, None])[:, 0]
            pos = state.pos + n_emit
            budget = state.budget - n_emit
            stopped = (is_stop & emit).any(dim=1)
            # the drafter learns only VERIFIED emissions, in order
            ds = self.drafter.observe(state.draft, blk.take(out),
                                      blk.take(emit))
            state = state._replace(
                last_tok=torch.where(active, last, state.last_tok),
                pos=pos, budget=budget,
                active=active & ~stopped & (budget > 0) & (pos < max_seq - 1),
                draft=ds,
                n_drafted=state.n_drafted + active.to(torch.int32) * d,
                n_accepted=state.n_accepted + (n_emit - 1).clamp(min=0))
            toks.append(out)
            emits.append(emit)
        if self.paged:
            dead = pre_active & ~state.active
            state = state._replace(pages=pg.release(state.pages, dead))
        return state, caches, torch.stack(toks), torch.stack(emits)


    def import_request(self, state: SlotState, caches, tiles, scalars,
                       dst_ids, n: int, slot: int):
        """The import half of a page transfer (I7): write the exported
        tiles into this pool's pages `dst_ids[:n]` ((mp,) int32 on the
        device, granted by the decode mirror), adopt them into `slot`'s
        block table (refcount 1, owned) and install the slot's scalars,
        stop row and sampling generator.  Caches are written in place."""
        pg.import_pages(caches, self.pool_flags, tiles, dst_ids, n)
        pool = pg.adopt(state.pages, slot, dst_ids, n)
        last_tok, pos, budget, stop_row, gen = scalars
        onehot = torch.arange(state.pos.shape[0],
                              device=state.pos.device) == slot
        gens = list(state.gens)
        gens[slot] = gen
        state = state._replace(
            last_tok=torch.where(onehot, last_tok, state.last_tok),
            pos=torch.where(onehot, pos, state.pos),
            budget=torch.where(onehot, budget, state.budget),
            active=onehot | state.active,
            stop=torch.where(onehot[:, None], stop_row[None, :], state.stop),
            pages=pool, gens=tuple(gens))
        return state, caches


class PrefillWorker:
    """Runs the chunked admission path against one pool's state."""

    def __init__(self, *, cfg, num_slots: int, max_seq: int,
                 prefill_chunk: int, stop_cap: int, sampling, paged: bool,
                 base_seed: int, block: SlotBlock, draft_len: int = 0,
                 drafter=None):
        self.cfg = cfg
        self.block = block
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.page_size = cfg.page_size
        self.pages_per_slot = -(-max_seq // cfg.page_size)
        self.prefill_chunk = prefill_chunk
        self.stop_cap = stop_cap
        self.sampling = sampling
        self.paged = paged
        self.base_seed = base_seed
        self.pool_flags = M.cache_pool_flags(cfg) if paged else None
        self.draft_len = draft_len
        self.drafter = drafter
        # per-slot cache leaves (recurrent state), in both layouts: the
        # leaves the flags mark False, and their init values
        self.per_slot = [not f for f in tree_leaves(M.cache_pool_flags(cfg))]
        self.fills = _state_fills(cfg) if any(self.per_slot) else ()

    def admit_chunk(self, params, state: SlotState, caches, tokens, valid,
                    offsets, true_lens, budgets0, stops, gens, txn=None,
                    first=None):
        """One prefill chunk for every admitting slot.  `gens` holds the
        generator of each slot whose prompt ends in this chunk (None
        elsewhere).  `txn` (paged only, a round's first chunk) is the pool
        transaction (admitting, shared, n_shared, new_pages, cow_src,
        evict_delta, register_delta): `admit_update`, then the
        copy-on-write split into table entry n_shared, both before any
        write of the forward.  `first` (S,) bool marks the slots whose
        first chunk this is: their per-slot cache leaves (recurrent state)
        restart from the init values — the previous occupant's state must
        not carry over, and warm-prefix slots do not start at offset 0, so
        the mask is explicit — and speculation resets their drafter state.
        The forward writes KV rows and recurrent state only for the `valid`
        slots (the bundle's write_mask); the others, mid-decode or done
        with their prompt, keep theirs."""
        ns, C = tokens.shape
        max_seq, blk = self.max_seq, self.block
        if txn is not None:
            admitting, shared, n_shared, new_pages, cow_src, ev, rg = txn
            pool = pg.admit_update(state.pages, admitting, shared, n_shared,
                                   new_pages, ev, rg)
            state = state._replace(pages=pool)
            # a cached prefix that ends mid-page lands as a private copy in
            # the slot's first FRESH page (one always exists: the match is
            # capped at prompt_len - 1).  The copy reads the source before
            # the forward writes, so a source page whose chain was evicted
            # and granted again this round still gives its old rows
            mp = pool.tables.shape[1]
            dst = torch.gather(pool.tables, 1,
                               n_shared.clamp(0, mp - 1).long()[:, None])[:, 0]
            pg.cow_copy(caches, self.pool_flags, cow_src, dst)
        states = [leaf for leaf, own in zip(tree_leaves(caches),
                                            self.per_slot) if own]
        for leaf, fill in zip(states, self.fills):
            leaf.masked_fill_(_by_slot(blk.take(first), leaf), fill)
        # unembed only each slot's true last prompt row
        idx = (true_lens - 1 - offsets).clamp(0, C - 1)
        pv = _bundle(state.pages, max_seq, self.page_size, valid) \
            if self.paged else attn.DenseKV(write_mask=valid, max_seq=max_seq)
        positions = offsets[:, None] + torch.arange(
            C, dtype=offsets.dtype, device=offsets.device)[None]
        logits, _, caches = M.forward(params, {"tokens": blk.take(tokens)},
                                      self.cfg, caches=caches,
                                      cache_pos=blk.take(offsets),
                                      gather_pos=blk.take(idx),
                                      paged=blk.kv(pv, positions))
        final = valid & (offsets + C >= true_lens)
        toks = smp.sample(logits[:, 0], self.sampling, blk.take(gens))
        toks, = blk.exchange(caches, self.pool_flags, pv, positions, toks)
        hit_stop = final & (toks[:, None] == stops).any(dim=1)
        act = final & (budgets0 > 0) & ~hit_stop & (true_lens < max_seq - 1)
        state = state._replace(
            last_tok=torch.where(final, toks, state.last_tok),
            pos=torch.where(final, true_lens, state.pos),
            budget=torch.where(final, budgets0, state.budget),
            active=torch.where(final, act, state.active),
            stop=torch.where(final[:, None], stops, state.stop),
            gens=tuple(g if g is not None else old
                       for g, old in zip(gens, state.gens)))
        if self.draft_len:
            # seed the drafter from the prompt: clear the slot on its first
            # chunk, observe this chunk's real tokens in order, then the
            # sampled first token on the final chunk, so tick-time
            # proposals draft from the prompt (prompt-lookup decoding)
            ds = self.drafter.reset(state.draft, blk.take(first))
            cmask = valid[:, None] & (positions < true_lens[:, None])
            ds = self.drafter.observe(ds, blk.take(tokens), blk.take(cmask))
            ds = self.drafter.observe(ds, blk.take(toks)[:, None],
                                      blk.take(final)[:, None])
            state = state._replace(
                draft=ds, n_drafted=torch.where(first, 0, state.n_drafted),
                n_accepted=torch.where(first, 0, state.n_accepted))
        if self.paged:
            # a request that terminates AT admission (first token a stop
            # token, or no decode room) drops its references right here
            state = state._replace(pages=pg.release(state.pages,
                                                    final & ~act))
        return state, caches, toks

    def export_request(self, state: SlotState, caches, src_ids, n: int,
                       slot: int):
        """The export half of a page transfer (I7): gather the departing
        slot's first `n` page tiles (`src_ids`, int32 on the device), read
        its scalars and stop row, take its sampling generator out of the
        slot, then deactivate it and release its references — all in this
        one call, so the source pool is never seen holding references for
        rows already copied out.  The caches are not written: the released
        pages' rows are overwritten by the next grant's prefill.  Returns
        (state, tiles, scalars)."""
        tiles = pg.export_pages(caches, self.pool_flags, src_ids[:n])
        scalars = (state.last_tok[slot].clone(), state.pos[slot].clone(),
                   state.budget[slot].clone(), state.stop[slot].clone(),
                   state.gens[slot])
        onehot = torch.arange(state.pos.shape[0],
                              device=state.pos.device) == slot
        gens = list(state.gens)
        gens[slot] = None
        state = state._replace(active=state.active & ~onehot,
                               pages=pg.release(state.pages, onehot),
                               gens=tuple(gens))
        return state, tiles, scalars

    def run_round(self, params, state, caches, rnd):
        """Execute an AdmissionRound.  Returns (state, caches, toks
        (n_chunks, S) device tensor of each chunk's sampled tokens); the
        caller reads a slot's first token at its final chunk."""
        ns, C, K = self.num_slots, self.prefill_chunk, self.stop_cap
        mp, P = self.pages_per_slot, state.pages.refs.shape[0]
        n_calls = max(rnd.n_chunks.values())
        dev = state.last_tok.device
        # one host block for the whole round: per chunk, the columns
        # [tokens (ns*C) | valid | offsets | true_lens | budgets0 (ns each)
        #  | stops (ns*K)], then the pool transaction (paged)
        # [admitting | n_shared | new_pages | cow_src (ns each) |
        #  shared (ns*mp) | evict (P) | register (P)]
        width = ns * C + 4 * ns + ns * K
        n_txn = 4 * ns + ns * mp + 2 * P if self.paged else 0
        host = np.zeros((n_calls * width + n_txn,), np.int32)
        block = host[:n_calls * width].reshape(n_calls, width)
        gens = [[None] * ns for _ in range(n_calls)]
        for ci in range(n_calls):
            tok = block[ci, :ns * C].reshape(ns, C)
            cols = block[ci, ns * C:ns * C + 4 * ns].reshape(4, ns)
            stops = block[ci, ns * C + 4 * ns:].reshape(ns, K)
            cols[2] = 1                                  # true_lens padding
            stops[:] = -1
            for slot, req in rnd.admitted:
                if ci >= rnd.n_chunks[slot]:
                    continue
                off = rnd.starts[slot] + ci * C
                piece = req.prompt[off:off + C]
                tok[slot, :len(piece)] = piece
                cols[0, slot] = 1
                cols[1, slot] = off
                cols[2, slot] = len(req.prompt)
                cols[3, slot] = req.max_new_tokens - 1
                stops[slot, :len(req.stop_tokens)] = req.stop_tokens
                if ci == rnd.n_chunks[slot] - 1 and \
                        self.sampling.method != "greedy":
                    gens[ci][slot] = smp.request_generator(
                        self.base_seed, req.seed, dev)
        if self.paged:
            txn = host[n_calls * width:]
            cols = txn[:4 * ns].reshape(4, ns)
            shared = txn[4 * ns:4 * ns + ns * mp].reshape(ns, mp)
            ev = txn[4 * ns + ns * mp:4 * ns + ns * mp + P]
            rg = txn[4 * ns + ns * mp + P:]
            cols[3] = -1
            for slot, _ in rnd.admitted:
                _, full, cow, n_fresh = rnd.plan[slot]
                cols[:, slot] = (1, len(full), n_fresh, cow)
                shared[slot, :len(full)] = full
            for p, d in rnd.evict_delta.items():
                ev[p] = d
            for p, d in rnd.reg_delta.items():
                rg[p] = d
        dev_host = _upload(host, dev)
        dev_block = dev_host[:n_calls * width].reshape(n_calls, width)
        txn = None
        if self.paged:
            t = dev_host[n_calls * width:]
            cols = t[:4 * ns].reshape(4, ns)
            txn = (cols[0].bool(), t[4 * ns:4 * ns + ns * mp].reshape(ns, mp),
                   cols[1], cols[2], cols[3],
                   t[4 * ns + ns * mp:4 * ns + ns * mp + P],
                   t[4 * ns + ns * mp + P:])
        out = []
        for ci in range(n_calls):
            row = dev_block[ci]
            cols = row[ns * C:ns * C + 4 * ns].reshape(4, ns)
            state, caches, toks = self.admit_chunk(
                params, state, caches, row[:ns * C].reshape(ns, C),
                cols[0].bool(), cols[1], cols[2], cols[3],
                row[ns * C + 4 * ns:].reshape(ns, K), tuple(gens[ci]),
                txn if ci == 0 else None,
                cols[0].bool() if ci == 0 else torch.zeros_like(
                    cols[0], dtype=torch.bool))
            out.append(toks)
        return state, caches, torch.stack(out)
