"""Refcounted KV page allocator (port of the allocator half of
`repro.runtime.pages`).

  PagePool — the device-resident allocator state (per-page refcounts,
             per-slot block tables, per-slot ownership bits).  Mutation
             goes through `admit_update` (evict → share → grant →
             register, in that order) and `release` (refcount decrement;
             zero reclaims).
  HostPool — the host-side numpy mirror replaying the same rules, so the
             engine knows every granted page id without a device sync.

Invariants kept from the reference: refcounts never go negative; a page is
free iff its refcount is 0; grants take the lowest free page id first,
admitting slots in ascending order.  The prefix cache, copy-on-write,
speculative rollback and page transfer come with later slices.

The reference's scatter-with-drop (`.at[...].add(mode="drop")`) becomes a
scatter-add whose masked entries add 0 — no extra page, no host sync.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PagePool(NamedTuple):
    """Refcounted page-pool state; one set of device tensors for all slots.

    refs[p]      — live references to page p (0 means free).
    tables[s, j] — pool page holding slot s's rows [j*ps, (j+1)*ps).
    n_pages[s]   — live table entries for slot s.
    owned[s, j]  — slot s may write through entry j."""
    refs: torch.Tensor      # (P,) i32
    tables: torch.Tensor    # (S, mp) i32
    n_pages: torch.Tensor   # (S,) i32
    owned: torch.Tensor     # (S, mp) bool


def init_pool(num_slots: int, table_len: int, num_pages: int,
              device=None) -> PagePool:
    return PagePool(
        refs=torch.zeros((num_pages,), dtype=torch.int32, device=device),
        tables=torch.zeros((num_slots, table_len), dtype=torch.int32,
                           device=device),
        n_pages=torch.zeros((num_slots,), dtype=torch.int32, device=device),
        owned=torch.zeros((num_slots, table_len), dtype=torch.bool,
                          device=device))


def free_mask(pool: PagePool) -> torch.Tensor:
    """(P,) bool — free iff refcount 0."""
    return pool.refs == 0


def _add_at(refs, idx, take, delta: int):
    """refs[idx[take]] += delta, as a masked scatter-add (masked entries
    add 0 at a clipped in-range index)."""
    P = refs.shape[0]
    flat = idx.reshape(-1).clamp(0, max(P - 1, 0)).long()
    vals = take.reshape(-1).to(torch.int32) * delta
    return refs.index_add(0, flat, vals)


def admit_update(pool: PagePool, admitting, shared, n_shared, new_pages,
                 evict_delta, register_delta) -> PagePool:
    """One admission round of pool bookkeeping, in the order the host
    mirror replays: (1) eviction deltas, (2) shared pages mapped read-only
    into entries [0, n_shared) with a refcount bump each, (3) `new_pages[s]`
    fresh pages granted (lowest free id first, slots ascending) into
    entries [n_shared, n_shared + new_pages) with refcount 1 and ownership,
    (4) registration deltas."""
    P = pool.refs.shape[0]
    mp = pool.tables.shape[1]
    refs = pool.refs + evict_delta
    j = torch.arange(mp, dtype=torch.int32, device=refs.device)[None, :]
    sh_take = admitting[:, None] & (j < n_shared[:, None])
    refs = _add_at(refs, shared, sh_take, 1)
    # grant AFTER shares bump: a re-shared page is no longer free
    order = torch.sort((refs != 0).to(torch.int32), stable=True)[1]
    starts = torch.cumsum(new_pages, 0) - new_pages   # ascending slot order
    k = j - n_shared[:, None]                         # fresh-grant index
    g_take = admitting[:, None] & (k >= 0) & (k < new_pages[:, None])
    grant = order[(starts[:, None] + k).clamp(0, max(P - 1, 0)).long()] \
        .to(torch.int32)
    refs = _add_at(refs, grant, g_take, 1)
    tables = torch.where(g_take, grant,
                         torch.where(sh_take, shared, pool.tables))
    owned = torch.where(g_take, True, torch.where(sh_take, False, pool.owned))
    n_pages = torch.where(admitting, n_shared + new_pages, pool.n_pages)
    return PagePool(refs + register_delta, tables, n_pages.to(torch.int32),
                    owned)


def release(pool: PagePool, dead) -> PagePool:
    """Drop every reference `dead` slots hold; a page whose refcount hits 0
    is thereby free."""
    j = torch.arange(pool.tables.shape[1], device=pool.tables.device)[None, :]
    held = dead[:, None] & (j < pool.n_pages[:, None])
    refs = _add_at(pool.refs, pool.tables, held, -1)
    return PagePool(refs, pool.tables,
                    torch.where(dead, 0, pool.n_pages).to(torch.int32),
                    pool.owned & ~dead[:, None])


class HostPool:
    """Numpy replay of the device allocator: the same evict → share →
    grant → register order and the same grant rule (lowest free id first,
    rounds in the order given), so every page id the device computes is
    known on the host without a sync."""

    def __init__(self, num_pages: int, num_slots: int):
        self.num_pages = num_pages
        self.refs = np.zeros(num_pages, np.int32)
        self.slot_tables: list[list[int]] = [[] for _ in range(num_slots)]
        self.slot_owned: list[list[bool]] = [[] for _ in range(num_slots)]

    @property
    def free_pages(self) -> int:
        return int((self.refs == 0).sum())

    @property
    def pages_in_use(self) -> int:
        return int((self.refs > 0).sum())

    @property
    def pages_shared(self) -> int:
        """Pages serving more than one consumer right now."""
        return int((self.refs > 1).sum())

    @property
    def slot_refs_total(self) -> int:
        return sum(len(t) for t in self.slot_tables)

    def refcount_hist(self) -> np.ndarray:
        """hist[r] = number of pages with refcount exactly r."""
        return np.bincount(self.refs, minlength=1)

    def apply_delta(self, delta: dict[int, int]) -> None:
        for p, d in delta.items():
            self.refs[p] += d
            if self.refs[p] < 0:
                raise AssertionError(f"refcount of page {p} went negative")

    def admit_round(self, grants, evict_delta, register_delta=None):
        """grants: [(slot, shared_ids, n_fresh)] in ascending slot order.
        Returns {slot: granted page ids}."""
        self.apply_delta(evict_delta)
        for _, shared_ids, _ in grants:
            for p in shared_ids:
                self.refs[p] += 1
        free_ids = np.flatnonzero(self.refs == 0)
        need = sum(n for _, _, n in grants)
        if need > free_ids.size:
            raise AssertionError(f"grant of {need} pages exceeds "
                                 f"{free_ids.size} free")
        granted: dict[int, list[int]] = {}
        i = 0
        for slot, shared_ids, n_fresh in grants:
            ids = [int(x) for x in free_ids[i:i + n_fresh]]
            i += n_fresh
            for p in ids:
                self.refs[p] += 1
            self.slot_tables[slot] = list(shared_ids) + ids
            self.slot_owned[slot] = [False] * len(shared_ids) \
                + [True] * n_fresh
            granted[slot] = ids
        if register_delta:
            self.apply_delta(register_delta)
        return granted

    def release_slot(self, slot: int) -> None:
        for p in self.slot_tables[slot]:
            self.refs[p] -= 1
            if self.refs[p] < 0:
                raise AssertionError(f"refcount of page {p} went negative")
        self.slot_tables[slot] = []
        self.slot_owned[slot] = []
