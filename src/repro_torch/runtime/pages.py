"""Refcounted KV page allocator with copy-on-write prefix sharing and the
cross-pool page transfer of disaggregated serving (port of
`repro.runtime.pages`).

  PagePool    — the device-resident allocator state (per-page refcounts,
                per-slot block tables, per-slot ownership bits).  Mutation
                goes through `admit_update` (evict → share → grant →
                register, in that order), `release` (refcount decrement;
                zero reclaims), `cow_copy` (a shared page's rows copied into
                a freshly granted private page at admission, never written
                in place), `apply_refs_delta` (bare registry deltas — the
                commit of an eviction round that admitted no slot),
                `rollback` (speculative rows the verify pass rejected,
                zeroed under the write's own mask, ownership and bound) and
                `adopt` (an imported request installed into a slot).
  Transfer    — `export_pages` gathers a request's page tiles from every
                pool leaf, `import_pages` writes them into another pool's
                pages: the prefill→decode handoff of a disaggregated
                engine, at page granularity.  `rows_of` / `put_rows` move
                rows instead: the mesh Engine's data ranks exchange the
                rows their slots wrote in a forward, so that every rank's
                pool is the same replica.
  HostPool    — the host-side numpy mirror replaying the same rules, so the
                engine knows every granted page id without a device sync.
  PrefixCache — the host-side prefix registry: chunk-incremental blake2b
                keys over the prompt's int32 bytes, mapped to the pool
                pages holding those rows; one cache reference per distinct
                page; LRU eviction when admission would stall or the
                registry passes `max_chains`.  Pure numpy and hashlib: every
                host decision equals the reference's on the same schedule.

Invariants kept from the reference (I1–I7 of its module docstring):

  I1  refcounts are never negative.
  I2  a page is free iff its refcount is 0.
  I3  sum(n_pages) == sum(refs) - cached_pages.
  I4  grants take the lowest free page id first, admitting slots in
      ascending order.
  I5  at most one slot owns a page, and shared mappings are never written.
  I6  speculative rows never outlive their rejection (`rollback`).
  I7  page transfer preserves the allocator discipline across pools:
      moving a request between pools (`export_pages` → `import_pages` +
      `adopt`, the prefill→decode handoff of disaggregated serving)
      copies its pages' contents bit-exactly, grants the destination ids
      by the same lowest-free-id rule as admission (I4, replayed by the
      destination HostPool, so no sync is needed), marks every imported
      page owned with refcount 1, and releases the source references in
      the same worker call that reads the tiles — so after any transfer
      round both pools independently satisfy I1–I6 and the moved
      request's rows read back identical to the rows the source pool held.

The reference's scatter-with-drop (`.at[...].add(mode="drop")`) becomes a
scatter-add whose masked entries add 0 — no extra page, no host sync; the
transfer writes only its live entries, whose count the host knows from the
scheduler's plan.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.models import attention as attn
from repro_torch.tree import tree_map


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


def apply_refs_delta(pool: PagePool, delta) -> PagePool:
    """Bare refcount delta ((P,) i32) with no table changes — the device
    commit of an eviction round that admitted no slot: the host registry
    already dropped its chains, so the -1 cache refs must land here too or
    the evicted pages leak as phantom-occupied."""
    return pool._replace(refs=pool.refs + delta)


def cow_copy(caches, pool_flags, src, dst):
    """Copy-on-write split, in place: for every slot s with src[s] >= 0,
    copy page src[s]'s rows into page dst[s] in every shared pool leaf
    (all layers).  The source — a cached page holding a prefix that
    diverges from the admitting prompt mid-page — is never written.

    All rows are gathered before any is written, so a source page granted
    again in the same round still yields its old rows.  Entries with
    src < 0 repeat the first copying entry's target and rows (or, when
    none copies, write page dst[0] onto itself): the scatter then writes
    identical values twice, with no host sync."""
    ok = src >= 0
    donor = torch.argmax(ok.to(torch.int32)).reshape(1)
    tgt = torch.where(ok, dst, dst[donor])
    frm = torch.where(ok, src, torch.where(ok.any(), src[donor], dst[donor]))

    def cp(leaf, is_pool):
        if is_pool:
            P = leaf.shape[1]                # leaf: (n_periods, P, ps, ...)
            leaf[:, tgt.clamp(0, P - 1).long()] = \
                leaf[:, frm.clamp(0, P - 1).long()]

    tree_map(cp, caches, pool_flags)
    return caches


def zero_rows(leaf, index, ok) -> None:
    """leaf[:, index] = 0 for the entries where `ok`, in place, over every
    period of a (n_periods, ...) cache leaf; the other entries drop, through
    `attention._scatter_drop` on a view with the period axis moved behind
    the two indexed axes.  No host sync."""
    view = leaf.movedim(0, 2)
    zeros = torch.zeros((ok.shape[0],) + tuple(view.shape[2:]),
                        dtype=leaf.dtype, device=leaf.device)
    attn._scatter_drop(view, tuple(i.long() for i in index), zeros, ok)


def rollback(caches, pool_flags, pv, positions):
    """Zero the speculative KV rows the verify pass rejected, in place.
    `positions` (S, L) holds the rejected rows' absolute positions per slot
    (the caller routes kept rows to pv.max_seq, which drops); `pv` is the
    attention.PagedKV bundle the window was WRITTEN with, so the rollback
    honours the same write-mask / ownership / bound discipline: it never
    touches a shared page, another slot's rows, or a row the write itself
    dropped."""
    ps, mp = pv.page_size, pv.tables.shape[1]
    pg_idx = torch.div(positions, ps, rounding_mode="floor")
    entry = pg_idx.clamp(0, mp - 1).long()
    ok = pv.write_mask[:, None] & (pg_idx < pv.n_pages[:, None]) \
        & (positions < pv.max_seq)
    if pv.owned is not None:
        ok = ok & torch.gather(pv.owned, 1, entry)
    if pv.bound is not None:
        ok = ok & (positions < pv.bound[:, None])
    index = (torch.gather(pv.tables, 1, entry).reshape(-1),
             torch.remainder(positions, ps).reshape(-1))
    ok = ok.reshape(-1)

    def zero(leaf, is_pool):
        if is_pool:
            zero_rows(leaf, index, ok)

    tree_map(zero, caches, pool_flags)
    return caches


def rows_of(leaves, page, row) -> list:
    """Each (n_periods, P, ps, …) pool leaf's rows at (`page`, `row`)
    (1-D long), as an (R, n_periods, …) tensor: what a data rank of the
    mesh Engine hands its peers."""
    return [leaf[:, page, row].movedim(1, 0) for leaf in leaves]


def put_rows(leaves, page, row, ok, rows) -> None:
    """Write `rows` (`rows_of`'s layout, over every slot's targets) into
    the pool `leaves` at (`page`, `row`) where `ok`, in place; the others
    drop.  The mesh Engine's data ranks thereby land each other's rows
    through the same block tables, ownership bits and bounds the writes
    used, and every rank's pool stays a bit-equal replica."""
    for leaf, r in zip(leaves, rows):
        attn._scatter_drop(leaf.movedim(0, 2), (page, row), r, ok)


def release(pool: PagePool, dead) -> PagePool:
    """Drop every reference `dead` slots hold; a page whose refcount hits 0
    is thereby free."""
    j = torch.arange(pool.tables.shape[1], device=pool.tables.device)[None, :]
    held = dead[:, None] & (j < pool.n_pages[:, None])
    refs = _add_at(pool.refs, pool.tables, held, -1)
    return PagePool(refs, pool.tables,
                    torch.where(dead, 0, pool.n_pages).to(torch.int32),
                    pool.owned & ~dead[:, None])


def export_pages(caches, pool_flags, src_ids):
    """Gather the page tiles at `src_ids` (a 1-D int tensor of page ids)
    from every pool leaf — the read half of a cross-pool transfer (I7).
    The returned tree mirrors `caches`, each pool leaf's page axis (axis 1
    of its (n_periods, P, ps, ...) shape) replaced by the gathered tiles;
    other leaves come back zero-width, as the reference's do."""
    idx = src_ids.long()

    def take(leaf, is_pool):
        if not is_pool:
            return leaf[:, :0]
        return leaf.index_select(1, idx.clamp(0, max(leaf.shape[1] - 1, 0)))

    return tree_map(take, caches, pool_flags)


def import_pages(caches, pool_flags, tiles, dst_ids, n: int):
    """Write the first `n` tiles of an `export_pages` tree into this pool's
    pages `dst_ids[:n]`, in place — the write half of a cross-pool
    transfer (I7).  `n` is the request's live page count, known on the
    host from the scheduler's plan, so the entries past it are never
    written (the reference routes them to a drop index).  Contents land
    bit-exact: the tiles were gathered, never recomputed."""
    idx = dst_ids[:n].long()

    def put(leaf, is_pool, tile):
        if is_pool and n:
            leaf.index_copy_(1, idx, tile[:, :n].to(leaf.dtype))

    tree_map(put, caches, pool_flags, tiles)
    return caches


def adopt(pool: PagePool, slot: int, page_ids, n: int) -> PagePool:
    """Install an imported request into `slot`: table entries [0, n) map
    `page_ids` ((mp,) int32; entries past n ignored) with ownership and one
    reference each.  The caller picks `page_ids` by the destination
    mirror's grant rule (lowest free id first — I4/I7), so they are known
    on the host without a sync."""
    S, mp = pool.tables.shape
    dev = pool.refs.device
    live = torch.arange(mp, device=dev) < n
    refs = _add_at(pool.refs, page_ids, live, 1)
    row = torch.arange(S, device=dev) == slot
    take = row[:, None] & live[None, :]
    return PagePool(refs,
                    torch.where(take, page_ids[None, :].to(torch.int32),
                                pool.tables),
                    torch.where(row, n, pool.n_pages).to(torch.int32),
                    torch.where(take, True, pool.owned))


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
        """Apply a bare registry refcount delta (eviction decrements /
        registration increments) with no table changes."""
        for p, d in delta.items():
            self.refs[p] += d
            if self.refs[p] < 0:
                raise AssertionError(f"refcount of page {p} went negative")

    def admit_round(self, grants, evict_delta, register_delta=None):
        """grants: [(slot, shared_ids, n_fresh)] in ascending slot order.
        Returns {slot: granted page ids}; `register_delta` may also come
        later, through `apply_register`."""
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

    def apply_register(self, register_delta: dict[int, int]) -> None:
        self.apply_delta(register_delta)

    def release_slot(self, slot: int) -> None:
        for p in self.slot_tables[slot]:
            self.refs[p] -= 1
            if self.refs[p] < 0:
                raise AssertionError(f"refcount of page {p} went negative")
        self.slot_tables[slot] = []
        self.slot_owned[slot] = []


# ---------------------------------------------------------------------------
# host-side prefix registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Chain:
    end: int                   # prefix length in tokens (k * prefix_chunk)
    pages: tuple[int, ...]     # pool pages holding rows [0, end)
    last_use: int              # LRU clock


class PrefixCache:
    """Registry of prefill prefixes at `prefix_chunk`-token granularity.
    A chain for `end` tokens maps the ceil(end/page_size) pages holding
    those rows; a partial last page (end not page-aligned) reaches
    consumers through copy-on-write, not a read-only mapping.  Each
    distinct page carries ONE cache refcount however many chains cover it.
    Beyond `max_chains` chains, registration evicts LRU chains."""

    def __init__(self, prefix_chunk: int, page_size: int,
                 max_chains: int = 4096):
        if prefix_chunk < 1:
            raise ValueError(f"prefix_chunk must be >= 1, "
                             f"got {prefix_chunk}")
        if max_chains < 1:
            raise ValueError(f"max_chains must be >= 1, got {max_chains}")
        self.prefix_chunk = prefix_chunk
        self.page_size = page_size
        self.max_chains = max_chains
        self.chains: dict[bytes, _Chain] = {}
        self.page_chains: dict[int, int] = {}     # page -> covering chains
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.tokens_skipped = 0

    @property
    def cached_pages(self) -> int:
        return len(self.page_chains)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def keys_for(self, prompt: np.ndarray) -> tuple[bytes, ...]:
        """Chunk-incremental blake2b digests over the int32 prompt bytes:
        keys[i] identifies tokens [0, (i+1)*prefix_chunk)."""
        prompt = np.asarray(prompt, np.int32)
        pc = self.prefix_chunk
        h = hashlib.blake2b(digest_size=16)
        keys = []
        for end in range(pc, len(prompt) + 1, pc):
            h.update(prompt[end - pc:end].tobytes())
            keys.append(h.digest())
        return tuple(keys)

    def match(self, keys, prompt_len: int):
        """Longest registered chain among `keys` that is a PROPER prefix
        (capped at prompt_len-1: the last prompt token's logits seed the
        first sampled token, so it is always computed).  Pure planning: no
        stats, no LRU tick (`commit` records them once the request admits).

        Returns (matched_tokens, full_page_ids, cow_src, key): full pages
        map read-only; cow_src (or -1) is the partial page the slot gets a
        private copy of; key (or None) goes to `commit`."""
        best, best_key = None, None
        for i, key in enumerate(keys):
            if (i + 1) * self.prefix_chunk >= prompt_len:
                break
            c = self.chains.get(key)
            if c is not None and (best is None or c.end > best.end):
                best, best_key = c, key
        if best is None:
            return 0, [], -1, None
        n_full = best.end // self.page_size
        cow = int(best.pages[n_full]) if best.end % self.page_size else -1
        return best.end, list(best.pages[:n_full]), cow, best_key

    def commit(self, key: bytes | None, matched: int) -> None:
        """Record a planned match's telemetry and LRU tick once its request
        admitted (the chain may be gone already: the same round's eviction
        can pop it after the match)."""
        if key is None:
            self.misses += 1
            return
        self.hits += 1
        self.tokens_skipped += matched
        c = self.chains.get(key)
        if c is not None:
            c.last_use = self._tick()

    def register(self, keys, table_ids, delta) -> None:
        """Add chains for every chunk-aligned prefix of a just-admitted
        prompt whose rows live in `table_ids` (the slot's block table);
        pages gaining their first covering chain get +1 in `delta`."""
        for i, key in enumerate(keys):
            end = (i + 1) * self.prefix_chunk
            c = self.chains.get(key)
            if c is not None:
                c.last_use = self._tick()
                continue
            pages = tuple(int(p)
                          for p in table_ids[:-(-end // self.page_size)])
            self.chains[key] = _Chain(end, pages, self._tick())
            for p in pages:
                n = self.page_chains.get(p, 0)
                self.page_chains[p] = n + 1
                if n == 0:
                    delta[p] = delta.get(p, 0) + 1
        # the cap evicts into the SAME delta, so the drops ride the round's
        # register update and host and device stay in lockstep
        while len(self.chains) > self.max_chains:
            key = min(self.chains, key=lambda k: self.chains[k].last_use)
            self._evict_chain(key, delta)

    def _evict_chain(self, key: bytes, delta, eff=None) -> int:
        """Drop one chain; pages losing their last covering chain get -1 in
        `delta` (and in `eff` when given).  Returns how many pages thereby
        became free as judged against `eff` (0 without one)."""
        c = self.chains.pop(key)
        self.evictions += 1
        freed = 0
        for p in c.pages:
            self.page_chains[p] -= 1
            if self.page_chains[p] == 0:
                del self.page_chains[p]
                delta[p] = delta.get(p, 0) - 1
                if eff is not None:
                    eff[p] -= 1
                    if eff[p] == 0:
                        freed += 1
        return freed

    def evict(self, need_free: int, eff: np.ndarray, delta) -> int:
        """Evict LRU chains until `need_free` more pages would be free,
        judged against `eff` (the mirror refcounts with this round's
        pending shares and evictions applied).  Returns pages freed."""
        freed = 0
        while freed < need_free and self.chains:
            key = min(self.chains, key=lambda k: self.chains[k].last_use)
            freed += self._evict_chain(key, delta, eff)
        return freed
