"""Continuous-batching serving engine (port of `repro.runtime.serve.Engine`
for the colocated, non-speculative paged engine).

The engine composes three layers, as the reference's:

  runtime.scheduler — host decisions: FIFO queue, admission with
                      backpressure, the `pages.HostPool` mirror, request
                      lifecycle and results.
  runtime.workers   — device computation: `PrefillWorker` (chunked admit)
                      and `DecodeWorker` (the decode tick).
  Engine (here)     — the composition and the public API: `submit`,
                      `step`, `run`, `pages_in_use`, KV-read accounting,
                      `close` / context manager.

Attention KV lives in a shared pool of `cfg.page_size`-row pages addressed
through per-slot block tables; pages are granted at admission (lowest free
id first) and reclaimed the moment a request terminates.  Decode reads go
through the hand-written paged-decode kernels when `decode_kernel` is on —
by default whenever the engine runs on CUDA; an explicit False selects the
gather oracle.  The host syncs once per decode tick and once per admission
round.

The engine runs on the card unless the caller asks for the CPU
(`device="cpu"`); with no GPU and no explicit CPU request it raises.
Options this slice does not serve raise NotImplementedError at
construction: speculation, disaggregation, a mesh, the dense KV layout,
stochastic sampling and `check_invariants`.  The prefix cache (on by
default in `PrefixOptions`) is not ported yet; the engine serves without
it, which leaves greedy streams unchanged.
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from repro_torch.kernels import paged_attention as pk
from repro_torch.models import model as M
from repro_torch.models.transformer import tree_map
from repro_torch.runtime.options import EngineOptions, RequestResult
from repro_torch.runtime.scheduler import Request, Scheduler
from repro_torch.runtime.workers import (DecodeWorker, PrefillWorker,
                                         SlotState, init_slot_state)

__all__ = ["Engine", "Request", "SlotState", "RequestResult", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """`None` means the card; the CPU only when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch serves on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def _unported(options: EngineOptions) -> str | None:
    """The first option this slice cannot serve, described, or None."""
    if options.speculation.draft_len > 0:
        return "speculative decoding"
    if options.disagg.enabled:
        return "prefill/decode disaggregation"
    if options.parallel.mesh is not None:
        return "a device mesh (tensor and expert parallel serving)"
    if options.paging.kv_layout != "paged":
        return "the dense KV layout in the Engine"
    if options.sampling.method != "greedy":
        return (f"{options.sampling.method!r} sampling (per-request "
                "torch.Generator streams)")
    if options.debug.check_invariants:
        return "check_invariants (the engine's invariant checks)"
    return None


class Engine:
    """Paged continuous-batching engine.  Construction mirrors the
    reference: `Engine(cfg, params, options=EngineOptions(...))`, with the
    legacy flat kwargs merged by `EngineOptions.build`; `device` picks the
    card (default) or, by name, the CPU."""

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
        self._build(cfg, params, options, resolve_device(device))

    def _build(self, cfg, params, options: EngineOptions, device) -> None:
        missing = _unported(options)
        if missing is not None:
            raise NotImplementedError(f"{missing} is not ported to "
                                      f"repro_torch yet")
        self.options = options
        self.device = device
        sch, par = options.schedule, options.parallel
        if par.dispatch is not None:
            cfg = cfg.replace(ep_dispatch=par.dispatch)
        if par.capacity_factor is not None:
            cfg = cfg.replace(moe_capacity_factor=float(par.capacity_factor))
        M.cache_pool_flags(cfg)         # rejects layer kinds not ported yet
        if options.prefix.enabled:
            warnings.warn("prefix cache (refcounted shared prefix pages): "
                          "not ported to repro_torch yet; serving without "
                          "it (greedy streams are unchanged)", stacklevel=3)
        self.cfg = cfg
        self.params = tree_map(lambda a: a.to(device), params)
        self.num_slots, self.max_seq = sch.num_slots, sch.max_seq
        self.stop_tokens = sch.stop_tokens
        self.eos_id = sch.stop_tokens[0] if len(sch.stop_tokens) == 1 \
            else None
        self.sampling = options.sampling
        self.decode_steps = sch.decode_steps
        self.prefill_chunk = max(1, min(sch.prefill_chunk, sch.max_seq - 1))
        self._stop_cap = max(4, len(self.stop_tokens))
        self.kv_layout = "paged"
        self.page_size = cfg.page_size
        self.pages_per_slot = -(-self.max_seq // self.page_size)
        self.num_pages = int(options.paging.num_pages) \
            if options.paging.num_pages is not None \
            else self.num_slots * self.pages_per_slot
        dk = options.paging.decode_kernel
        self.decode_kernel = bool(dk if dk is not None
                                  else device.type == "cuda")
        self.sched = Scheduler(
            num_slots=self.num_slots, max_seq=self.max_seq,
            page_size=self.page_size, prefill_chunk=self.prefill_chunk,
            num_pages=self.num_pages, stop_cap=self._stop_cap,
            stop_tokens=self.stop_tokens)
        self.prefill = PrefillWorker(
            cfg=cfg, num_slots=self.num_slots, max_seq=self.max_seq,
            prefill_chunk=self.prefill_chunk, stop_cap=self._stop_cap,
            sampling=self.sampling)
        self.decode = DecodeWorker(
            cfg=cfg, max_seq=self.max_seq, decode_steps=self.decode_steps,
            sampling=self.sampling, decode_kernel=self.decode_kernel)
        self.state = init_slot_state(self.num_slots, self._stop_cap,
                                     self.pages_per_slot, self.num_pages,
                                     device)
        self.caches = M.init_cache(cfg, self.num_slots, self.max_seq,
                                   num_pages=self.num_pages, device=device)
        self.pages_high_water = 0
        # one host sync per tick and per admission round
        self.n_ticks = 0
        self.n_admit_calls = 0
        self.n_syncs = 0
        self.n_generated = 0
        # decode KV read accounting: bytes the decode path reads from the
        # KV cache, from the tick-start slot lengths
        self.kv_bytes_read = 0
        self.kv_read_steps = 0
        self._kv_row_bytes = pk.kv_row_bytes(cfg)

    # ------------------------------------------------------------------
    @property
    def pool(self):
        """The HostPool mirror of the page pool."""
        return self.sched.pool

    @property
    def pages_in_use(self) -> int:
        """Pages with refcount > 0."""
        return self.sched.pool.pages_in_use

    def submit(self, prompt, max_new_tokens: int = 16,
               seed: int | None = None,
               stop_tokens: tuple | None = None) -> Request:
        """Queue a prompt.  `stop_tokens` overrides the engine's default
        stop set for this request; a budget that cannot fit the cache is
        clamped here (finish reason "max_seq")."""
        return self.sched.submit(prompt, max_new_tokens, seed, stop_tokens)

    def _admit(self) -> None:
        rnd = self.sched.plan_round()
        if rnd is None:
            return
        self.pages_high_water = max(self.pages_high_water,
                                    self.sched.pool.pages_in_use)
        self.state, self.caches, toks = self.prefill.run_round(
            self.params, self.state, self.caches, rnd)
        self.n_admit_calls += toks.shape[0]
        # one blocking sync for the whole admission round
        host = torch.cat([toks.reshape(-1),
                          self.state.active.to(torch.int32)]).cpu().numpy()
        toks_h = host[:toks.numel()].reshape(toks.shape)
        active = host[toks.numel():].astype(bool)
        now = time.perf_counter()
        for slot, req in rnd.admitted:
            req.out_tokens.append(int(toks_h[rnd.n_chunks[slot] - 1, slot]))
            req.t_first = now
            self.n_generated += 1
            if not active[slot]:
                # terminated at admission; the device already released it
                self.sched.release_slot(slot)
        self.n_syncs += 1

    def step(self) -> bool:
        """One engine tick: admit queued prompts, then `decode_steps`
        decode steps for all active slots, ending in one host sync."""
        self._admit()
        live = [r for r in self.sched.slot_req if r is not None]
        if not live:
            return False
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
        n = toks.numel()
        host = torch.cat([toks.reshape(-1), emitted.reshape(-1).to(torch.int32),
                          self.state.active.to(torch.int32)]).cpu().numpy()
        toks_h = host[:n].reshape(toks.shape)
        emitted_h = host[n:2 * n].reshape(toks.shape).astype(bool)
        active = host[2 * n:].astype(bool)
        self.n_ticks += 1
        self.n_syncs += 1
        for slot, req in enumerate(self.sched.slot_req):
            if req is None:
                continue
            for t in range(toks_h.shape[0]):
                if emitted_h[t, slot]:
                    req.out_tokens.append(int(toks_h[t, slot]))
                    self.n_generated += 1
            if not active[slot]:
                self.sched.release_slot(slot)
        return True

    def run(self, max_ticks: int = 10_000) -> list[RequestResult]:
        """Serve until the queue drains (or max_ticks); returns the results
        completed during this call, in completion order."""
        for _ in range(max_ticks):
            if not self.step() and not self.sched.queue:
                break
        done, self.sched.finished = self.sched.finished, []
        return done

    def close(self) -> None:
        """Drop the engine's device state (idempotent)."""
        if not self._closed:
            self._closed = True
            self.caches = None
            self.state = None

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
