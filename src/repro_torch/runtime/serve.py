"""Continuous-batching serving engine (port of `repro.runtime.serve.Engine`
for one device, colocated or disaggregated).

The engine composes three layers, as the reference's:

  runtime.scheduler — host decisions: FIFO queue, admission with
                      backpressure, prefix matching and LRU eviction, the
                      `pages.HostPool` mirror, request lifecycle, results.
  runtime.workers   — device computation: `PrefillWorker` (chunked admit,
                      pool transaction, copy-on-write, drafter seeding) and
                      `DecodeWorker` (the decode tick, plain or
                      speculative).
  Engine (here)     — the composition and the public API: `submit`,
                      `step`, `run`, `abort`, `pages_in_use`,
                      `prefix_stats`, `spec_stats`, `disagg_stats`,
                      KV-read accounting, `close` / context manager.

KV layouts (`kv_layout=`):
  "paged" (default) — attention KV lives in a shared pool of
      `cfg.page_size`-row pages addressed through per-slot block tables;
      pages are granted at admission (lowest free id first) and reclaimed
      the moment a request terminates.  Decode reads go through the
      hand-written paged-decode kernels when `decode_kernel` is on — by
      default whenever the engine runs on CUDA; an explicit False selects
      the gather oracle.
  "dense" — the per-slot max_seq reservation, kept as the parity oracle;
      its decode reads always take the gather oracle (`chunk_attention`),
      never the kernels, as in the reference.

Prefix caching (`prefix_cache=True`, the default, paged only): prompts are
hashed at `submit` in `prefix_chunk`-token pieces; a warm admission maps
the longest cached prefix's full pages read-only into the slot's table,
skips their prefill compute, and receives a partially covered page as a
private copy (copy-on-write), so cached pages are never written.

Sampling is greedy or stochastic (temperature / top-k / top-p) from
per-request generators seeded by (engine seed, request seed).  The host
syncs once per decode tick and once per admission round;
`check_invariants=True` also reads the device allocator back after every
sync and compares it with the host mirror.

Speculative decoding (`EngineOptions.speculation.draft_len > 0`): each tick
step drafts `draft_len` tokens from the configured drafter —
`drafter="ngram"` (default), a per-slot n-gram table, or
`drafter="model"`, the serving model's own weights requantized to
`draft_bits` (the 2-bit BRAMAC datapath) decoding through a private
per-slot draft KV cache (`runtime/speculate.py`) — scores the whole window
[last_tok, g_1..g_d] in ONE forward through the chunked path prefill uses,
and accepts/replaces every position on the device
(`sampling.spec_verify`).  Greedy streams are identical to
non-speculative decoding (invariants A1-A6 in speculate.py); the host
still syncs once per tick whatever the acceptance length.  The verify
window reads the KV cache through the gather oracle, so speculation turns
the decode kernels off, and the model drafter turns the prefix cache off
(a skipped prefill chunk would leave its draft-cache rows unwritten).
`draft_len` is clamped to max_seq - 2.

Disaggregated mode (`disagg=True` / `EngineOptions.disagg`, paged layout
only): prefill and decode run as separate workers with separate page pools
and slot sets on the one device.  A prompt admits into the prefill
worker's pool, prefills there (its first token sampled at admission, so
TTFT is unchanged), then its KV pages move into the decode worker's pool
at page granularity — `pages.export_pages` gathers the tiles, the decode
mirror grants the destination ids by the same lowest-free-id rule, and
`pages.import_pages` / `adopt` land them bit-exactly (invariant I7;
`check_invariants=True` checks I1–I7 on both pools after every transfer
round).  The request's sampling generator moves with it, so sampled
streams do not depend on the split.  When no decode slot is free or the
decode pool is dry the transfer backpressures, FIFO.  `role="both"` runs
both workers in this process; "prefill" / "decode" name the endpoints of
a multi-process transport and raise NotImplementedError.  The prefix
cache and speculation switch off under disaggregation; the decode kernels
stay on.

Recurrent archs (a `mamba`, `mlstm` or `slstm` layer): the mixers' state
is a per-slot tuple, not token storage, so prompts prefill one token per
forward, a slot's first chunk restarts its state from the init values,
and the prefix cache and speculation opt out silently (a cached prefix
cannot stand in for the state, and a rejected draft cannot be rewound);
disaggregation raises ValueError, since the state has no page to move.

Tensor- and expert-parallel serving (`mesh=`, a `parallel.sharding.Mesh`
or a `build_mesh` spec over the ranks of the default process group): every
rank builds the Engine with the same weights and submissions.
Construction activates the `serve_rules` sharding ctx (released by
`close()`, also when construction fails) and keeps this rank's block of
every weight (`sharding.shard_params`; `sharding.serve_whole` stays
whole: the embedding, mamba's B/C/dt projections, the sLSTM's cell and
its `w_up`).  Each rank runs H/n query heads and Hkv/n KV heads (its
page pool holds its KV heads), d_ff/n of the dense FF and 1/n of each
recurrent mixer's width (`sharding.local_config`; `self.cfg` is that
per-rank view): the column-parallel linears need no collective, the
row-parallel `wo` / `w_down` take one max and one sum over the `model`
axis, the unembed one gather, MoE experts go through the EP route, and the MLA, mamba and xLSTM
mixers take the collectives their modules describe (MLA: its `wo`; mamba:
two gathers; mLSTM: two gathers and its `w_down`; sLSTM: its `w_down`).
Every rank keeps MLA's whole latent cache in its own pool, its heads'
mLSTM state, its channels' mamba state and the whole sLSTM state.
Greedy tokens come from the gathered logits, so the deterministic
scheduler makes the same decisions on every rank.  A `data` axis of n
ranks splits the slots as the reference's `serve_rules` split the batch
(`sharding.data_rows`): when n divides `num_slots`, data index i runs the
forwards of slots [i·S/n, (i+1)·S/n) only (`rank_slots` of them) and holds
only their per-slot caches (dense KV, recurrent state) and drafter state;
otherwise every data rank keeps every slot.  Each rank keeps every slot's
scalars and block tables and the whole page pool, which the prefix cache
and copy-on-write share across slots: after each forward one all-gather
over `data` brings the tokens the other ranks sampled and the pool rows
they wrote, which land through the same block tables (`workers.SlotBlock`),
so the pools stay bit-equal and the replicated scheduler decides alike.
MoE gathers its input over `data` before routing, so routing and capacity
drops see the whole batch, as in the reference; in an arch with a MoE
layer the pool rows are exchanged in each paged layer instead, before it
reads (a free slot's padding row reads through its stale block table,
and MoE routes it with the real rows).  Counters (`n_syncs`,
`kv_bytes_read`, the page high-water marks, `prefix_stats`, `spec_stats`)
are the whole Engine's, equal to the meshless Engine's.  The decode
kernels run under a mesh as without one, each rank's over its own KV
heads and pool: the reference
turns its kernel off there because the kernel carries no partition
annotations, and a rank here is a process with an ordinary local pool.
The model drafter is requantized from the whole serving tree before
sharding, so a row-parallel draft weight keeps the whole leaf's column
scales, then sharded like the serving tree; it runs under the same ctx,
its private KV cache holding the rank's heads.  As in the reference
disaggregation with a mesh is a ValueError.

The engine runs on the card unless the caller asks for the CPU
(`device="cpu"`); with no GPU and no explicit CPU request it raises.
A cross-attention (xattn) arch raises NotImplementedError at
construction: the Engine feeds no `vision_embeds`, so llama-3.2-vision
runs forward-level only (`model.prefill` / `decode_step`), as in the
reference, whose Engine fails at the first admission of such an arch.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.kernels import paged_attention as pk
from repro_torch.models import model as M
from repro_torch.models.transformer import is_recurrent
from repro_torch.parallel import sharding as shd
from repro_torch.runtime import pages as pg
from repro_torch.runtime import speculate as spc
from repro_torch.runtime.options import EngineOptions, RequestResult
from repro_torch.runtime.scheduler import Request, Scheduler
from repro_torch.runtime.workers import (DecodeWorker, PrefillWorker,
                                         SlotBlock, SlotState, _upload,
                                         init_slot_state)
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["Engine", "Request", "SlotState", "RequestResult", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """`None` means the card; the CPU only when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch serves on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


class Engine:
    """Continuous-batching engine.  Construction mirrors the reference:
    `Engine(cfg, params, options=EngineOptions(...))`, with the legacy flat
    kwargs merged by `EngineOptions.build`; `device` picks the card
    (default) or, by name, the CPU."""

    def __init__(self, cfg, params, num_slots: int | None = None,
                 max_seq: int | None = None, *,
                 options: EngineOptions | None = None, device=None,
                 **legacy):
        if num_slots is not None:
            legacy["num_slots"] = num_slots
        if max_seq is not None:
            legacy["max_seq"] = max_seq
        options = EngineOptions.build(base=options, **legacy)
        self._closed = False
        # close() must be callable on a partially constructed engine: the
        # sharding ctx is process-global, so a construction that raises
        # after activate() would otherwise leave it held
        self._ctx = None
        self.mesh = None
        try:
            self._build(cfg, params, options, resolve_device(device))
        except BaseException:
            self.close()
            raise

    def _build(self, cfg, params, options: EngineOptions, device) -> None:
        dis = options.disagg
        self.disagg = bool(dis.enabled)
        if self.disagg:
            # the reference's order and exception types; the mesh check
            # comes before the mesh's own NotImplementedError
            if dis.role in ("prefill", "decode"):
                raise NotImplementedError(
                    f"role={dis.role!r} is the single-process endpoint of "
                    f"the multi-process transport, which is not implemented "
                    f"yet — the page-transfer seam (pages.export_pages / "
                    f"import_pages) is where it plugs in; use role='both'")
            if options.paging.kv_layout != "paged":
                raise ValueError("disaggregation requires kv_layout="
                                 "'paged': pages are the transfer unit")
            if options.parallel.mesh is not None:
                raise ValueError("disaggregation and mesh= are mutually "
                                 "exclusive (single-process transport)")
            if not all(tree_leaves(M.cache_pool_flags(cfg))):
                raise ValueError(
                    "disaggregation requires every cache leaf to live in "
                    "the shared page pool; recurrent/xattn per-slot state "
                    f"has no page representation to transfer "
                    f"(layer_pattern={cfg.layer_pattern})")
        if any(s.startswith("xattn+") for s in cfg.layer_pattern):
            raise NotImplementedError(
                f"{cfg.name} has cross-attention (xattn) layers, and the "
                f"Engine feeds no vision inputs (vision_embeds): such an "
                f"arch runs forward-level only, through model.prefill / "
                f"model.decode_step with vision_embeds, as in the "
                f"reference")
        self.options = options
        self.device = device
        sch, par = options.schedule, options.parallel
        if par.dispatch is not None:
            cfg = cfg.replace(ep_dispatch=par.dispatch)
        if par.capacity_factor is not None:
            cfg = cfg.replace(moe_capacity_factor=float(par.capacity_factor))
        M.cache_pool_flags(cfg)         # rejects malformed layer specs
        mesh = par.mesh
        whole_cfg, whole_params = cfg, params
        if mesh is not None:
            cfg, params = self._shard(cfg, params, mesh)
        self.cfg = cfg
        self.params = tree_map(lambda a: a.to(device), params)
        self.num_slots, self.max_seq = sch.num_slots, sch.max_seq
        # the slots this rank's forwards run: its data block, or all
        lo, hi = shd.data_rows(self.num_slots, self.mesh)
        self.rank_slots = hi - lo
        split = self.rank_slots < self.num_slots
        if split:
            self._ctx.split_batch = True
        block = SlotBlock(lo, hi, self.mesh.group("data") if split else None,
                          per_layer=split and any(
                              s.endswith("+moe") for s in cfg.layer_pattern))
        self.stop_tokens = sch.stop_tokens
        self.eos_id = sch.stop_tokens[0] if len(sch.stop_tokens) == 1 \
            else None
        self.sampling = options.sampling
        self.decode_steps = sch.decode_steps
        self.check_invariants = options.debug.check_invariants
        self.n_invariant_checks = 0
        self.n_transfer_checks = 0      # transfer rounds checked for I7
        # recurrent mixers (mamba/mlstm/slstm) cannot skip padding in their
        # state, so their prompts are fed token by token (chunk = 1)
        recurrent = is_recurrent(cfg)
        self.prefill_chunk = 1 if recurrent \
            else max(1, min(sch.prefill_chunk, sch.max_seq - 1))
        self._stop_cap = max(4, len(self.stop_tokens))
        self.kv_layout = options.paging.kv_layout
        paged = self.kv_layout == "paged"
        self.page_size = cfg.page_size
        self.pages_per_slot = -(-self.max_seq // self.page_size)
        if paged:
            self.num_pages = int(options.paging.num_pages) \
                if options.paging.num_pages is not None \
                else self.num_slots * self.pages_per_slot
        else:
            self.num_pages = 0
        # disagg sizing: the prefill worker's own slot set and pool
        self.prefill_slots = (int(dis.prefill_slots)
                              if dis.prefill_slots is not None
                              else self.num_slots) if self.disagg \
            else self.num_slots
        self.prefill_pages = (int(dis.prefill_pages)
                              if dis.prefill_pages is not None
                              else self.prefill_slots * self.pages_per_slot) \
            if self.disagg else self.num_pages
        # speculation opts out silently where verify/decode parity breaks
        # (recurrent state cannot rewind a rejected draft; MoE capacity
        # drops depend on the rows of each call; cross-attention, which the
        # engine refuses above), and under disaggregation (drafter
        # state has no page representation)
        spec = options.speculation
        spec_ok = not recurrent and not self.disagg and not any(
            "xattn" in s or "moe" in s for s in cfg.layer_pattern)
        self.draft_len = min(spec.draft_len, max(0, self.max_seq - 2)) \
            if spec_ok else 0
        self.drafter_kind = spec.drafter if self.draft_len else None
        if not self.draft_len:
            self.drafter = None
        elif self.drafter_kind == "model":
            # the 2-bit BRAMAC draft model: the engine's own weights
            # requantized, with a private per-slot draft KV cache (A6);
            # under a mesh from the whole tree, then sharded
            if mesh is None:
                self.drafter = spc.QuantDrafter.build(
                    cfg, self.params, self.max_seq, bits=spec.draft_bits,
                    draft_layers=spec.draft_layers)
            else:
                whole = spc.QuantDrafter.build(
                    whole_cfg, whole_params, self.max_seq,
                    bits=spec.draft_bits, draft_layers=spec.draft_layers)
                self.drafter = spc.QuantDrafter(
                    cfg=shd.local_config(whole.cfg, self.mesh,
                                         self._tp_axis),
                    params=tree_map(lambda a: a.to(device), shd.shard_params(
                        whole.params, self._ctx,
                        whole=shd.serve_whole(whole.cfg))),
                    max_seq=self.max_seq)
                del whole
        else:
            self.drafter = spc.NGramDrafter(spec.ngram, spec.table)
        # dense speculative rollback zeroes the KV leaves, paged the pool's
        kv_flags = M.cache_pool_flags(cfg) if self.draft_len else None
        # the decode kernels read Sq=1; the verify window (Sq = d + 1)
        # reads through the gather oracle
        dk = options.paging.decode_kernel
        self.decode_kernel = paged and not self.draft_len and bool(
            dk if dk is not None else device.type == "cuda")
        # the prefix cache shares pool pages, so it is paged-only; recurrent
        # archs opt out (their state accumulates over every token, so a
        # cached prefix cannot stand in for it); the model drafter opts out
        # (a skipped prefill chunk would leave its draft-cache rows
        # unwritten, breaking A6), and so does disaggregation (cached pages
        # would pin the prefill pool while the decode reads happen in the
        # other pool)
        self.prefix_chunk = int(options.prefix.chunk) \
            if options.prefix.chunk is not None else self.page_size
        prefix = pg.PrefixCache(self.prefix_chunk, self.page_size,
                                max_chains=options.prefix.max_chains) \
            if options.prefix.enabled and paged and not recurrent \
            and not self.disagg and self.drafter_kind != "model" else None
        # the host-side scheduler; its admission side is the prefill side
        self.sched = Scheduler(
            num_slots=self.prefill_slots, max_seq=self.max_seq,
            page_size=self.page_size, prefill_chunk=self.prefill_chunk,
            paged=paged, num_pages=self.prefill_pages,
            stop_cap=self._stop_cap, stop_tokens=self.stop_tokens,
            prefix=prefix)
        if self.disagg:
            self.sched.attach_decode(self.num_slots, self.num_pages)
        self.prefill = PrefillWorker(
            cfg=cfg, num_slots=self.prefill_slots, max_seq=self.max_seq,
            prefill_chunk=self.prefill_chunk, stop_cap=self._stop_cap,
            sampling=self.sampling, paged=paged, base_seed=sch.seed,
            draft_len=self.draft_len, drafter=self.drafter, block=block)
        self.decode = DecodeWorker(
            cfg=cfg, max_seq=self.max_seq, decode_steps=self.decode_steps,
            sampling=self.sampling, paged=paged,
            decode_kernel=self.decode_kernel, draft_len=self.draft_len,
            drafter=self.drafter, kv_flags=kv_flags, block=block)
        # per-slot caches and drafter state: this rank's slots only
        draft0 = self.drafter.init_state(self.rank_slots, device) \
            if self.draft_len else spc.empty_state(self.rank_slots, device)
        self.state = init_slot_state(self.num_slots, self._stop_cap,
                                     self.pages_per_slot if paged else 0,
                                     self.num_pages, device, draft0)
        self.caches = M.init_cache(cfg, self.rank_slots, self.max_seq,
                                   num_pages=self.num_pages if paged
                                   else None, device=device)
        if self.disagg:
            # the prefill worker's own state and pool
            self.p_state = init_slot_state(
                self.prefill_slots, self._stop_cap, self.pages_per_slot,
                self.prefill_pages, device,
                spc.empty_state(self.prefill_slots, device))
            self.p_caches = M.init_cache(cfg, self.prefill_slots,
                                         self.max_seq,
                                         num_pages=self.prefill_pages,
                                         device=device)
        # pool occupancy lives in the HostPool mirror(s); pages_high_water
        # is the decode side's (a colocated engine's only pool)
        self.pages_high_water = 0
        self.pages_shared_high_water = 0
        self.prefill_pages_high_water = 0
        self.prefill_chunks_skipped = 0
        self.pages_transferred = 0
        self.transfer_rounds = 0
        # one host sync per tick and per admission round
        self.n_ticks = 0
        self.n_admit_calls = 0
        self.n_syncs = 0
        self.n_generated = 0
        # decode KV read accounting: bytes the decode path reads from the
        # KV cache, from the tick-start slot lengths
        self.kv_bytes_read = 0
        self.kv_read_steps = 0
        # the whole Engine's reads, whatever the mesh: every KV head
        self._kv_row_bytes = pk.kv_row_bytes(whole_cfg)

    def _shard(self, cfg, params, mesh):
        """Under a mesh: activate the serve rules and return this rank's
        config and weights."""
        if not isinstance(mesh, shd.Mesh):
            mesh = shd.build_mesh(mesh)
        if mesh.coords is None:
            raise ValueError(f"this rank is outside the mesh {mesh.shape}")
        self.mesh = mesh
        self._ctx = shd.activate(mesh,
                                 shd.serve_rules("pod" in mesh.axis_names))
        self._tp_axis = self._ctx.phys_axis("tp") or "model"
        return shd.local_config(cfg, mesh, self._tp_axis), \
            shd.shard_params(params, self._ctx, whole=shd.serve_whole(cfg))

    # ------------------------------------------------------------------
    @property
    def pool(self) -> pg.HostPool | None:
        """The decode-side HostPool mirror (a colocated engine's only
        pool); None under dense."""
        return self.sched.decode_pool

    @property
    def prefix(self) -> pg.PrefixCache | None:
        return self.sched.prefix

    @property
    def slot_req(self) -> list:
        """Decode-side slot occupancy (a colocated engine's only one)."""
        return self.sched.decode_slot_req

    @property
    def tokens_drafted(self) -> int:
        return self.sched.tokens_drafted

    @property
    def tokens_accepted(self) -> int:
        return self.sched.tokens_accepted

    @property
    def pages_in_use(self) -> int:
        """Decode-pool pages with refcount > 0, slot-held and cache-held
        alike."""
        pool = self.sched.decode_pool
        return pool.pages_in_use if pool is not None else 0

    def submit(self, prompt, max_new_tokens: int = 16,
               seed: int | None = None,
               stop_tokens: tuple | None = None) -> Request:
        """Queue a prompt.  `stop_tokens` overrides the engine's default
        stop set for this request; a budget that cannot fit the cache is
        clamped here (finish reason "max_seq").  `seed` keys the request's
        sampling stream (default: its uid)."""
        return self.sched.submit(prompt, max_new_tokens, seed, stop_tokens)

    def _admit_side(self):
        """(state, caches) of the pool admission lands in: the prefill
        worker's own under disaggregation, the one pool otherwise."""
        return (self.p_state, self.p_caches) if self.disagg \
            else (self.state, self.caches)

    def _set_admit_side(self, state, caches) -> None:
        if self.disagg:
            self.p_state, self.p_caches = state, caches
        else:
            self.state, self.caches = state, caches

    @staticmethod
    def _drop_gen(state, slot: int):
        """The slot's sampling generator goes with its request."""
        gens = list(state.gens)
        gens[slot] = None
        return state._replace(gens=tuple(gens))

    def _retire_admit(self, slot: int) -> None:
        """Retire a request from its admission-side slot."""
        st, ca = self._admit_side()
        self._set_admit_side(self._drop_gen(st, slot), ca)
        self.sched.release_admit_slot(slot)

    def _retire_decode(self, slot: int) -> None:
        """Retire a request from its decode-side slot."""
        self.state = self._drop_gen(self.state, slot)
        self.sched.release_decode_slot(slot)

    def _admit(self) -> None:
        paged = self.kv_layout == "paged"
        rnd = self.sched.plan_round()
        if rnd is None:
            return
        st, ca = self._admit_side()
        if not rnd.admitted:
            # eviction-only round: the registry already dropped its chains
            # host-side; commit the decrements on the device pool
            ev = np.zeros((st.pages.refs.shape[0],), np.int32)
            for p, d in rnd.evict_delta.items():
                ev[p] = d
            self._set_admit_side(st._replace(pages=pg.apply_refs_delta(
                st.pages, torch.from_numpy(ev).to(self.device))), ca)
            if self.check_invariants:
                self._verify_invariants()
            return
        if paged:
            hw = self.sched.pool.pages_in_use
            if self.disagg:
                self.prefill_pages_high_water = max(
                    self.prefill_pages_high_water, hw)
            else:
                self.pages_high_water = max(self.pages_high_water, hw)
            self.pages_shared_high_water = max(self.pages_shared_high_water,
                                               self.sched.pool.pages_shared)
        self.prefill_chunks_skipped += rnd.chunks_skipped
        st, ca, toks = self.prefill.run_round(self.params, st, ca, rnd)
        self._set_admit_side(st, ca)
        self.n_admit_calls += toks.shape[0]
        # one blocking sync for the whole admission round
        host = torch.cat([toks.reshape(-1),
                          st.active.to(torch.int32)]).cpu().numpy()
        toks_h = host[:toks.numel()].reshape(toks.shape)
        active = host[toks.numel():].astype(bool)
        now = time.perf_counter()
        for slot, req in rnd.admitted:
            req.out_tokens.append(int(toks_h[rnd.n_chunks[slot] - 1, slot]))
            req.t_first = now
            self.n_generated += 1
            if not active[slot]:
                # terminated at admission; the device already released it,
                # and it never transfers
                self._retire_admit(slot)
            elif self.disagg:
                self.sched.mark_ready(slot)
        self.n_syncs += 1
        if self.check_invariants:
            self._verify_invariants()

    def _transfer(self) -> None:
        """Disagg: move every transferable prefilled request's pages into
        the decode pool (FIFO, backpressured by the scheduler).  The page
        ids of the whole round go to the device in one copy; nothing is
        read back."""
        plans = self.sched.plan_transfers()
        if not plans:
            return
        mp = self.pages_per_slot
        ids = np.zeros((len(plans), 2, mp), np.int32)
        for i, t in enumerate(plans):
            ids[i, 0, :t.n] = t.src_ids
            ids[i, 1, :t.n] = t.dst_ids
        ids = _upload(ids, self.device)
        checked = [] if self.check_invariants else None
        for i, t in enumerate(plans):
            self.p_state, tiles, scalars = self.prefill.export_request(
                self.p_state, self.p_caches, ids[i, 0], t.n, t.src_slot)
            self.state, self.caches = self.decode.import_request(
                self.state, self.caches, tiles, scalars, ids[i, 1], t.n,
                t.dst_slot)
            self.pages_transferred += t.n
            if checked is not None:
                checked.append((t, tiles, ids[i, 1]))
        self.transfer_rounds += 1
        self.pages_high_water = max(self.pages_high_water,
                                    self.sched.decode_pool.pages_in_use)
        if self.check_invariants:
            self._verify_invariants()
            for t, tiles, dst in checked:
                self._verify_transfer(t, tiles, dst)
            self.n_transfer_checks += 1

    # ------------------------------------------------------------------
    # telemetry / debug
    # ------------------------------------------------------------------

    def prefix_stats(self) -> dict:
        """Prefix-cache telemetry for reports and benches."""
        if self.prefix is None:
            return {"enabled": False, "hits": 0, "misses": 0,
                    "hit_rate": 0.0, "tokens_skipped": 0, "evictions": 0,
                    "cached_pages": 0, "chunks_skipped": 0}
        c = self.prefix
        looked = c.hits + c.misses
        return {"enabled": True, "hits": c.hits, "misses": c.misses,
                "hit_rate": c.hits / looked if looked else 0.0,
                "tokens_skipped": c.tokens_skipped,
                "evictions": c.evictions, "cached_pages": c.cached_pages,
                "chunks_skipped": self.prefill_chunks_skipped}

    def spec_stats(self) -> dict:
        """Speculation telemetry: the drafter ("ngram" | "model", None when
        speculation is off) and drafted/accepted totals over finished
        requests plus the live slots' counters.  `abort` retires a running
        request through the same finish path, so its counters fold into
        the totals rather than vanishing."""
        drafted, accepted = self.tokens_drafted, self.tokens_accepted
        for r in self.sched.decode_slot_req:
            if r is not None:
                drafted += r.drafted_tokens
                accepted += r.accepted_tokens
        return {"enabled": bool(self.draft_len),
                "draft_len": self.draft_len,
                "drafter": self.drafter_kind,
                "drafted": drafted, "accepted": accepted,
                "acceptance_rate": accepted / drafted if drafted else 0.0}

    def disagg_stats(self) -> dict:
        """Disaggregation telemetry: the transfer volume and both pools'
        high-water occupancy (the prefill side reads 0 on a colocated
        engine)."""
        return {"enabled": self.disagg,
                "pages_transferred": self.pages_transferred,
                "transfer_rounds": self.transfer_rounds,
                "transfers_backpressured":
                    self.sched.transfers_backpressured,
                "decode_pages_high_water": self.pages_high_water,
                "decode_pages": self.num_pages,
                "prefill_pages_high_water": self.prefill_pages_high_water,
                "prefill_pages": self.prefill_pages if self.disagg else 0,
                "prefill_slots": self.prefill_slots if self.disagg else 0}

    def _verify_pool(self, host: pg.HostPool, dev: pg.PagePool,
                     num_slots: int, cached: int, label: str) -> None:
        """One pool's mirror-vs-device cross-check: refcounts, free
        popcount, per-slot block tables and ownership, and the I3 identity
        sum(n_pages) == sum(refs) - cached_pages."""
        refs = dev.refs.cpu().numpy()
        if (refs < 0).any():
            raise AssertionError(f"[{label}] device refcounts negative: "
                                 f"{refs}")
        if not np.array_equal(refs, host.refs):
            raise AssertionError(f"[{label}] host/device refcount drift:\n "
                                 f"host {host.refs}\n device {refs}")
        if int((refs == 0).sum()) != host.free_pages:
            raise AssertionError(
                f"[{label}] free popcount drift: host {host.free_pages}, "
                f"device {int((refs == 0).sum())}")
        n_pages = dev.n_pages.cpu().numpy()
        tables = dev.tables.cpu().numpy()
        owned = dev.owned.cpu().numpy()
        for s in range(num_slots):
            t = host.slot_tables[s]
            if int(n_pages[s]) != len(t):
                raise AssertionError(
                    f"[{label}] slot {s} n_pages drift: host {len(t)}, "
                    f"device {int(n_pages[s])}")
            if list(tables[s, :len(t)]) != t:
                raise AssertionError(
                    f"[{label}] slot {s} table drift: host {t}, "
                    f"device {list(tables[s, :len(t)])}")
            if list(owned[s, :len(t)]) != host.slot_owned[s]:
                raise AssertionError(
                    f"[{label}] slot {s} ownership drift: host "
                    f"{host.slot_owned[s]}, "
                    f"device {list(owned[s, :len(t)])}")
        if int(n_pages.sum()) != int(refs.sum()) - cached:
            raise AssertionError(
                f"[{label}] refcount identity broken: sum(n_pages)="
                f"{int(n_pages.sum())}, sum(refs)={int(refs.sum())}, "
                f"cached={cached}")

    def _verify_invariants(self) -> None:
        """Debug-mode cross-check (`check_invariants=True`): every HostPool
        mirror must equal its device allocator exactly; under disagg both
        pools are checked (I7: each side satisfies I1–I6 on its own after
        every transfer round).  Reads device tensors back; not counted in
        `n_syncs`."""
        if self.kv_layout != "paged":
            return
        if self.disagg:
            self._verify_pool(self.sched.pool, self.p_state.pages,
                              self.prefill_slots, 0, "prefill")
            self._verify_pool(self.sched.decode_pool, self.state.pages,
                              self.num_slots, 0, "decode")
        else:
            cached = self.prefix.cached_pages \
                if self.prefix is not None else 0
            self._verify_pool(self.sched.pool, self.state.pages,
                              self.num_slots, cached, "pool")
        self.n_invariant_checks += 1

    def _verify_transfer(self, t, tiles, dst) -> None:
        """I7 content check: the imported pages, exported again from the
        decode pool, must equal the moved tiles bit for bit."""
        got = pg.export_pages(self.caches, self.decode.pool_flags, dst[:t.n])
        for a, b in zip(tree_leaves(tiles), tree_leaves(got)):
            if not torch.equal(a[:, :t.n], b[:, :t.n]):
                raise AssertionError(
                    f"I7 broken: transferred pages for request "
                    f"{t.req.uid} differ between pools")

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One engine tick: admit queued prompts (disagg: after moving
        transferable prefilled requests into the decode pool, which frees
        prefill slots for this round, and again after, so a freshly
        prefilled prompt decodes in the same step as it would colocated),
        then `decode_steps` decode steps for all active decode slots,
        ending in one host sync."""
        if self.disagg:
            self._transfer()
        self._admit()
        if self.disagg:
            self._transfer()
        live = [r for r in self.sched.decode_slot_req if r is not None]
        if not live:
            # prefill-side work (queued, mid-prefill or awaiting transfer)
            # still counts as progress
            return self.disagg and bool(
                self.sched.queue or self.sched.ready
                or any(r is not None for r in self.sched.slot_req))
        # KV rows this tick's steps read (tick-start lengths): the kernels
        # touch live pages only; the gather oracle (dense decode, and the
        # speculative verify window) materializes num_slots x max_seq rows
        if self.decode_kernel:
            rows = pk.decode_read_rows(
                [len(r.prompt) + len(r.out_tokens) for r in live],
                self.page_size)
        else:
            rows = pk.oracle_read_rows(self.num_slots, self.max_seq)
        self.kv_bytes_read += self.decode_steps * rows * self._kv_row_bytes
        self.kv_read_steps += self.decode_steps
        self.state, self.caches, toks, emitted = self.decode.tick(
            self.params, self.state, self.caches)
        # plain tick: (steps, slots); speculative: (steps, slots, window) —
        # normalized to a trailing window axis of 1
        if toks.ndim == 2:
            toks, emitted = toks[..., None], emitted[..., None]
        n, ns = toks.numel(), self.num_slots
        parts = [toks.reshape(-1), emitted.reshape(-1).to(torch.int32),
                 self.state.active.to(torch.int32)]
        if self.draft_len:
            parts += [self.state.n_drafted, self.state.n_accepted]
        host = torch.cat(parts).cpu().numpy()      # the tick's one sync
        toks_h = host[:n].reshape(toks.shape)
        emitted_h = host[n:2 * n].reshape(toks.shape).astype(bool)
        active = host[2 * n:2 * n + ns].astype(bool)
        n_dr, n_ac = host[2 * n + ns:2 * n + 2 * ns], host[2 * n + 2 * ns:]
        self.n_ticks += 1
        self.n_syncs += 1
        for slot, req in enumerate(self.sched.decode_slot_req):
            if req is None:
                continue
            for t in range(toks_h.shape[0]):
                for j in range(toks_h.shape[2]):
                    if emitted_h[t, slot, j]:
                        req.out_tokens.append(int(toks_h[t, slot, j]))
                        self.n_generated += 1
            if self.draft_len:
                req.drafted_tokens = int(n_dr[slot])
                req.accepted_tokens = int(n_ac[slot])
            if not active[slot]:
                self._retire_decode(slot)
        if self.check_invariants:
            self._verify_invariants()
        return True

    def run(self, max_ticks: int = 10_000) -> list[RequestResult]:
        """Serve until the queue drains (or max_ticks); returns the results
        completed during this call, in completion order."""
        for _ in range(max_ticks):
            if not self.step() and not self.sched.queue:
                break
        done, self.sched.finished = self.sched.finished, []
        return done

    def abort(self, req: Request) -> bool:
        """Cancel a request.  Queued: removed before it ever runs.  Running:
        its slot is deactivated and (paged) its page references released
        at once — the freed pages are grantable in the next admission
        round.  Disagg: a prefilled request awaiting transfer is dropped on
        the prefill side and never moves.  Returns False if the request had already finished.  Either
        way an aborted request keeps the tokens it emitted, with
        finish_reason "aborted"."""
        if req.done:
            return False
        req.aborted = True
        if req in self.sched.queue:
            self.sched.queue.remove(req)
            self.sched.finish(req)
            return True
        if self.disagg and req.uid in self.sched._ready_slot:
            # prefilled, awaiting transfer: dropped on the prefill side,
            # never moves
            slot = self.sched.drop_ready(req)
            dead = torch.arange(self.prefill_slots,
                                device=self.device) == slot
            self.p_state = self.p_state._replace(
                active=self.p_state.active & ~dead,
                pages=pg.release(self.p_state.pages, dead))
            self._retire_admit(slot)
            if self.check_invariants:
                self._verify_invariants()
            return True
        for slot, r in enumerate(self.sched.decode_slot_req):
            if r is req:
                dead = torch.arange(self.num_slots,
                                    device=self.device) == slot
                state = self.state._replace(active=self.state.active & ~dead)
                if self.kv_layout == "paged":
                    state = state._replace(pages=pg.release(state.pages,
                                                            dead))
                self.state = state
                self._retire_decode(slot)
                if self.check_invariants:
                    self._verify_invariants()
                return True
        # not queued, not in a slot, not done — unreachable by construction
        raise AssertionError(f"request {req.uid} is in no engine structure")

    def close(self) -> None:
        """Release the engine's sharding ctx (process-global: a later
        meshless Engine or trainer in the same process would otherwise run
        under this engine's rules) and drop its device state.  Idempotent,
        and safe on a partially constructed engine — __init__ calls it
        before re-raising."""
        if self._ctx is not None and shd.active() is self._ctx:
            shd.deactivate()
        self._ctx = None
        if not self._closed:
            self._closed = True
            self.caches = None
            self.state = None
            self.p_caches = None
            self.p_state = None

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
