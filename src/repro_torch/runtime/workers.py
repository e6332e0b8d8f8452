"""Device-facing worker roles: chunked prefill admission and the decode tick
(port of `repro.runtime.workers` for the colocated, non-speculative paged
engine).

  PrefillWorker — executes a Scheduler `AdmissionRound`: fixed
                  `prefill_chunk`-token chunks, all admitting slots per
                  call; the first chunk carries the round's pool grant, the
                  final chunk of each prompt samples its first token on the
                  device and commits the slot state.
  DecodeWorker  — the tick: `decode_steps` decode → sample → terminate
                  steps over every slot; slots that terminate release
                  their pages before the host looks.

Both run eagerly on device tensors and never read a device value back: the
Engine syncs once per tick and once per admission round.  The host arrays
of a whole admission round are uploaded in one copy.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.runtime import pages as pg
from repro_torch.runtime import sampling as smp


class SlotState(NamedTuple):
    """Per-slot decode state; device tensors for all slots."""
    last_tok: torch.Tensor   # (S,) i32  last sampled token (next input)
    pos: torch.Tensor        # (S,) i32  next cache index to write
    budget: torch.Tensor     # (S,) i32  tokens still to emit after this one
    active: torch.Tensor     # (S,) bool slot is mid-generation
    stop: torch.Tensor       # (S, K) i32 per-request stop set, -1 padded
    pages: pg.PagePool       # refcounted page allocator


def init_slot_state(num_slots: int, stop_cap: int, table_len: int,
                    num_pages: int, device) -> SlotState:
    z = torch.zeros((num_slots,), dtype=torch.int32, device=device)
    return SlotState(
        last_tok=z, pos=z.clone(), budget=z.clone(),
        active=torch.zeros((num_slots,), dtype=torch.bool, device=device),
        stop=torch.full((num_slots, stop_cap), -1, dtype=torch.int32,
                        device=device),
        pages=pg.init_pool(num_slots, table_len, num_pages, device))


def _bundle(pool: pg.PagePool, max_seq: int, page_size: int, write_mask,
            kernel: bool = False) -> attn.PagedKV:
    """The PagedKV bundle for one call: `owned` drops writes aimed at
    pages a slot does not own; `kernel` routes Sq=1 reads through the
    paged-decode kernels."""
    return attn.PagedKV(tables=pool.tables, n_pages=pool.n_pages,
                        write_mask=write_mask, max_seq=max_seq,
                        page_size=page_size, owned=pool.owned,
                        decode_kernel=kernel)


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """One host→device copy; pinned and asynchronous on CUDA."""
    t = torch.from_numpy(a)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class DecodeWorker:
    """Runs the decode tick against one pool's state."""

    def __init__(self, *, cfg, max_seq: int, decode_steps: int, sampling,
                 decode_kernel: bool):
        self.cfg = cfg
        self.max_seq = max_seq
        self.page_size = cfg.page_size
        self.decode_steps = decode_steps
        self.sampling = sampling
        self.decode_kernel = decode_kernel

    def tick(self, params, state: SlotState, caches):
        """`decode_steps` decode → sample → terminate steps.  Returns
        (state, caches, toks (steps, S) i32, emitted (steps, S) bool)."""
        max_seq = self.max_seq
        pre_active = state.active
        toks, emits = [], []
        for _ in range(self.decode_steps):
            # inactive slots must not write: their stale block-table
            # entries may point at pages since re-granted to another slot
            pv = _bundle(state.pages, max_seq, self.page_size, state.active,
                         self.decode_kernel)
            logits, caches = M.decode_step(params, state.last_tok[:, None],
                                           self.cfg, caches, state.pos,
                                           paged=pv)
            sampled = smp.sample(logits, self.sampling)
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
        dead = pre_active & ~state.active
        state = state._replace(pages=pg.release(state.pages, dead))
        return state, caches, torch.stack(toks), torch.stack(emits)


class PrefillWorker:
    """Runs the chunked admission path against one pool's state."""

    def __init__(self, *, cfg, num_slots: int, max_seq: int,
                 prefill_chunk: int, stop_cap: int, sampling):
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.page_size = cfg.page_size
        self.pages_per_slot = -(-max_seq // cfg.page_size)
        self.prefill_chunk = prefill_chunk
        self.stop_cap = stop_cap
        self.sampling = sampling

    def admit_chunk(self, params, state: SlotState, caches, tokens, valid,
                    offsets, true_lens, budgets0, stops, admitting,
                    new_pages):
        """One prefill chunk for every admitting slot.  `admitting` (only
        set on a round's first chunk) applies the round's page grant."""
        ns, C = tokens.shape
        max_seq = self.max_seq
        if admitting is not None:
            dev = tokens.device
            P = state.pages.refs.shape[0]
            zeros_p = torch.zeros((P,), dtype=torch.int32, device=dev)
            pool = pg.admit_update(
                state.pages, admitting,
                torch.zeros((ns, self.pages_per_slot), dtype=torch.int32,
                            device=dev),
                torch.zeros((ns,), dtype=torch.int32, device=dev),
                new_pages, zeros_p, zeros_p)
            state = state._replace(pages=pool)
        # unembed only each slot's true last prompt row
        idx = (true_lens - 1 - offsets).clamp(0, C - 1)
        pv = _bundle(state.pages, max_seq, self.page_size, valid)
        logits, _, caches = M.forward(params, {"tokens": tokens}, self.cfg,
                                      caches=caches, cache_pos=offsets,
                                      gather_pos=idx, paged=pv)
        final = valid & (offsets + C >= true_lens)
        toks = smp.sample(logits[:, 0], self.sampling)
        hit_stop = final & (toks[:, None] == stops).any(dim=1)
        act = final & (budgets0 > 0) & ~hit_stop & (true_lens < max_seq - 1)
        state = state._replace(
            last_tok=torch.where(final, toks, state.last_tok),
            pos=torch.where(final, true_lens, state.pos),
            budget=torch.where(final, budgets0, state.budget),
            active=torch.where(final, act, state.active),
            stop=torch.where(final[:, None], stops, state.stop))
        # a request that terminates AT admission (first token a stop token,
        # or no decode room) drops its references right here
        state = state._replace(pages=pg.release(state.pages, final & ~act))
        return state, caches, toks

    def run_round(self, params, state, caches, rnd):
        """Execute an AdmissionRound.  Returns (state, caches, toks
        (n_chunks, S) device tensor of each chunk's sampled tokens); the
        caller reads a slot's first token at its final chunk."""
        ns, C, K = self.num_slots, self.prefill_chunk, self.stop_cap
        n_calls = max(rnd.n_chunks.values())
        # one host block for the whole round: per chunk, the columns
        # [tokens (ns*C) | valid | offsets | true_lens | budgets0 |
        #  admitting | new_pages (ns each) | stops (ns*K)]
        width = ns * C + 6 * ns + ns * K
        host = np.zeros((n_calls, width), np.int32)
        for ci in range(n_calls):
            tok = host[ci, :ns * C].reshape(ns, C)
            cols = host[ci, ns * C:ns * C + 6 * ns].reshape(6, ns)
            stops = host[ci, ns * C + 6 * ns:].reshape(ns, K)
            cols[2] = 1                                  # true_lens padding
            stops[:] = -1
            for slot, req in rnd.admitted:
                if ci >= rnd.n_chunks[slot]:
                    continue
                off = ci * C
                piece = req.prompt[off:off + C]
                tok[slot, :len(piece)] = piece
                cols[0, slot] = 1
                cols[1, slot] = off
                cols[2, slot] = len(req.prompt)
                cols[3, slot] = req.max_new_tokens - 1
                if ci == 0:
                    cols[4, slot] = 1
                    cols[5, slot] = rnd.new_pages[slot]
                stops[slot, :len(req.stop_tokens)] = req.stop_tokens
        dev_block = _upload(host, state.last_tok.device)
        out = []
        for ci in range(n_calls):
            row = dev_block[ci]
            cols = row[ns * C:ns * C + 6 * ns].reshape(6, ns)
            state, caches, toks = self.admit_chunk(
                params, state, caches, row[:ns * C].reshape(ns, C),
                cols[0].bool(), cols[1], cols[2], cols[3],
                row[ns * C + 6 * ns:].reshape(ns, K),
                cols[4].bool() if ci == 0 else None, cols[5])
            out.append(toks)
        return state, caches, torch.stack(out)
