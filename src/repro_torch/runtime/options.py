"""Engine configuration and result surface (port of `repro.runtime.options`;
every section and validation message is the reference's, so options
compare equal across the two packages; the port's Engine serves every
section).

This module groups the engine's knobs into one frozen `EngineOptions`
dataclass of themed sections
(sampling, schedule, paging, prefix cache, speculation, parallelism,
disaggregation, debug), each validating itself in `__post_init__` so a bad knob fails at
construction — before anything is traced — with the same error messages
the loose kwargs raised.  `Engine(cfg, params, options=EngineOptions(...))`
is the primary constructor; the legacy flat kwargs are still accepted and
merged via `EngineOptions.build`, so existing callers keep working.

`RequestResult` is the structured completion record the engine attaches
to every finished request (and returns from `Engine.run`): the emitted
tokens, a text-agnostic finish reason, and the serving counters
(prefill compute actually run, speculative drafted/accepted tokens,
prefix pages shared) that previously had to be scraped from engine
telemetry.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.runtime.sampling import SamplingConfig

FINISH_REASONS = ("eos", "budget", "max_seq", "aborted")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclasses.dataclass(frozen=True)
class ScheduleOptions:
    """Slot count, sequence ceiling and the fused-loop shapes.

    stop_tokens is the engine-level default stop set (the generalized
    `eos_id`): any emitted token in the set terminates the request; a
    `submit(stop_tokens=...)` override replaces it per request."""
    num_slots: int = 4
    max_seq: int = 128
    decode_steps: int = 1
    prefill_chunk: int = 16
    seed: int = 0
    stop_tokens: tuple = ()

    def __post_init__(self):
        _check(self.num_slots >= 1,
               f"num_slots must be >= 1, got {self.num_slots}")
        _check(self.max_seq >= 2,
               f"max_seq must be >= 2, got {self.max_seq}")
        _check(self.decode_steps >= 1,
               f"decode_steps must be >= 1, got {self.decode_steps}")
        _check(self.prefill_chunk >= 1,
               f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        object.__setattr__(self, "stop_tokens",
                           tuple(int(t) for t in self.stop_tokens))


@dataclasses.dataclass(frozen=True)
class PagingOptions:
    """KV layout: "paged" (shared refcounted page pool) or "dense" (the
    per-slot max_seq reservation kept as the parity oracle).  num_pages
    None means capacity-equal to dense (num_slots * ceil(max_seq /
    page_size)).

    decode_kernel routes the Sq=1 decode read through the hand-written
    paged-decode kernels (kernels/paged_attention.py): per-step KV
    traffic walks the block table page by page instead of gathering
    max_seq rows.  None (default) resolves at engine construction to on
    for an engine on CUDA, off elsewhere (on the CPU the wrappers run
    their plain versions).  gqa layers use the kernel; mla and the
    speculative verify window read through the gather oracle.  Ignored
    under kv_layout="dense"; under a mesh each rank runs it over its own
    KV heads."""
    kv_layout: str = "paged"
    num_pages: int | None = None
    decode_kernel: bool | None = None

    def __post_init__(self):
        if self.kv_layout not in ("paged", "dense"):
            raise ValueError(f"kv_layout must be 'paged' or 'dense', "
                             f"got {self.kv_layout!r}")
        if self.num_pages is not None:
            _check(int(self.num_pages) >= 1,
                   f"num_pages must be >= 1, got {self.num_pages}")


@dataclasses.dataclass(frozen=True)
class PrefixOptions:
    """Copy-on-write prefix caching (paged layout only; recurrent archs
    opt out silently).  chunk None defaults to cfg.page_size."""
    enabled: bool = True
    chunk: int | None = None
    max_chains: int = 4096

    def __post_init__(self):
        if self.chunk is not None:
            _check(int(self.chunk) >= 1,
                   f"prefix chunk must be >= 1, got {self.chunk}")
        _check(self.max_chains >= 1,
               f"prefix_max_chains must be >= 1, got {self.max_chains}")


@dataclasses.dataclass(frozen=True)
class SpeculationOptions:
    """Self-speculative decoding inside the fused tick.

    draft_len 0 disables speculation (the default); > 0 drafts that many
    tokens per decode step from a device-resident per-slot n-gram table
    (`ngram` transition order, `table` direct-mapped buckets) and scores
    them in one batched verify pass.  Greedy streams are bit-identical
    either way — speculation only changes how many host syncs a stream
    costs.  Recurrent-hybrid, cross-attention and MoE archs opt out
    silently (recurrent state cannot rewind a rejected draft; MoE
    capacity drops depend on tokens-per-call, which would break
    verify/decode bit parity).

    `drafter` selects the proposal engine: "ngram" (the table above) or
    "model" — the serving model's own weights requantized to `draft_bits`
    (2 by default: the BRAMAC reduced-precision datapath) and optionally
    truncated to the first `draft_layers` blocks, drafting through a
    private per-slot draft KV cache (speculate.QuantDrafter, invariant
    A6).  The model drafter additionally opts out of the prefix cache:
    a skipped prefill chunk would leave draft-cache rows unwritten.
    """
    draft_len: int = 0
    ngram: int = 2
    table: int = 512
    drafter: str = "ngram"
    draft_bits: int = 2
    draft_layers: int | None = None

    def __post_init__(self):
        _check(self.draft_len >= 0,
               f"draft_len must be >= 0, got {self.draft_len}")
        _check(self.ngram >= 2,
               f"speculation ngram must be >= 2, got {self.ngram}")
        _check(self.table >= 1,
               f"speculation table must be >= 1, got {self.table}")
        if self.drafter not in ("ngram", "model"):
            raise ValueError(f"drafter must be 'ngram' or 'model', "
                             f"got {self.drafter!r}")
        _check(self.draft_bits in (2, 4, 8),
               f"draft_bits must be one of (2, 4, 8), got {self.draft_bits}")
        if self.draft_layers is not None:
            _check(int(self.draft_layers) >= 1,
                   f"draft_layers must be >= 1, got {self.draft_layers}")


@dataclasses.dataclass(frozen=True)
class ParallelOptions:
    """mesh may be a `parallel.sharding.Mesh` of torch.distributed ranks or
    a `build_mesh` spec ("model=4", "2x4", 4) over the ranks of the
    default process group; capacity_factor / dispatch override the MoE
    routing knobs on cfg for this engine."""
    mesh: Any = None
    capacity_factor: float | None = None
    dispatch: str | None = None

    def __post_init__(self):
        if self.dispatch is not None and \
                self.dispatch not in ("global", "per_source"):
            raise ValueError(f"dispatch must be 'global' or 'per_source', "
                             f"got {self.dispatch!r}")


@dataclasses.dataclass(frozen=True)
class DisaggOptions:
    """Prefill/decode disaggregation (paged layout only, meshless).

    enabled=True splits the engine into a prefill worker with its OWN
    page pool and slot set and a decode worker owning the fused tick;
    a finished prompt's KV pages move between the pools at page
    granularity (`pages.export_pages` / `import_pages`, invariant I7)
    and greedy streams stay bit-identical to the colocated engine.
    Prefix caching and speculation switch off under disaggregation
    (cached pages would pin the prefill pool the decode side cannot
    read, and drafter state has no page representation to transfer);
    archs with per-slot cache leaves (recurrent hybrids, xattn) are
    rejected for the same reason.

    role="both" runs both workers in this process (the only transport
    implemented today); "prefill" / "decode" name the single-role
    endpoints of the future multi-process transport and currently
    raise NotImplementedError at engine construction.

    prefill_slots / prefill_pages size the prefill worker's slot set
    and pool; None defaults to the decode side's num_slots and a
    capacity-equal pool (prefill_slots * ceil(max_seq / page_size))."""
    enabled: bool = False
    role: str = "both"
    prefill_slots: int | None = None
    prefill_pages: int | None = None

    def __post_init__(self):
        if self.role not in ("prefill", "decode", "both"):
            raise ValueError(f"role must be 'prefill', 'decode' or "
                             f"'both', got {self.role!r}")
        if self.prefill_slots is not None:
            _check(int(self.prefill_slots) >= 1,
                   f"prefill_slots must be >= 1, got {self.prefill_slots}")
        if self.prefill_pages is not None:
            _check(int(self.prefill_pages) >= 1,
                   f"prefill_pages must be >= 1, got {self.prefill_pages}")


@dataclasses.dataclass(frozen=True)
class DebugOptions:
    """check_invariants cross-checks the HostPool mirror against the
    device allocator after every sync (and after speculative rollback
    rounds) — debug aid, costs extra transfers."""
    check_invariants: bool = False


# legacy flat kwarg -> (section attribute, field name)
_LEGACY = {
    "num_slots": ("schedule", "num_slots"),
    "max_seq": ("schedule", "max_seq"),
    "decode_steps": ("schedule", "decode_steps"),
    "prefill_chunk": ("schedule", "prefill_chunk"),
    "seed": ("schedule", "seed"),
    "stop_tokens": ("schedule", "stop_tokens"),
    "kv_layout": ("paging", "kv_layout"),
    "num_pages": ("paging", "num_pages"),
    "decode_kernel": ("paging", "decode_kernel"),
    "prefix_cache": ("prefix", "enabled"),
    "prefix_chunk": ("prefix", "chunk"),
    "prefix_max_chains": ("prefix", "max_chains"),
    "draft_len": ("speculation", "draft_len"),
    "spec_ngram": ("speculation", "ngram"),
    "spec_table": ("speculation", "table"),
    "drafter": ("speculation", "drafter"),
    "draft_bits": ("speculation", "draft_bits"),
    "draft_layers": ("speculation", "draft_layers"),
    "mesh": ("parallel", "mesh"),
    "capacity_factor": ("parallel", "capacity_factor"),
    "dispatch": ("parallel", "dispatch"),
    "disagg": ("disagg", "enabled"),
    "role": ("disagg", "role"),
    "prefill_slots": ("disagg", "prefill_slots"),
    "prefill_pages": ("disagg", "prefill_pages"),
    "check_invariants": ("debug", "check_invariants"),
}


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """Everything the serving engine bakes into its compiled functions,
    in one validated bundle.  All sections are frozen: the jit'd tick and
    admit close over these values, so they cannot change after
    construction."""
    sampling: SamplingConfig = SamplingConfig()
    schedule: ScheduleOptions = ScheduleOptions()
    paging: PagingOptions = PagingOptions()
    prefix: PrefixOptions = PrefixOptions()
    speculation: SpeculationOptions = SpeculationOptions()
    parallel: ParallelOptions = ParallelOptions()
    disagg: DisaggOptions = DisaggOptions()
    debug: DebugOptions = DebugOptions()

    def __post_init__(self):
        # ergonomic coercion: EngineOptions(sampling="top_p", ...) would
        # miss the method's parameters, so only the bare method name is
        # accepted here — parameterized methods build a SamplingConfig
        if isinstance(self.sampling, str):
            object.__setattr__(self, "sampling",
                               SamplingConfig(method=self.sampling))
        for name, typ in (("sampling", SamplingConfig),
                          ("schedule", ScheduleOptions),
                          ("paging", PagingOptions),
                          ("prefix", PrefixOptions),
                          ("speculation", SpeculationOptions),
                          ("parallel", ParallelOptions),
                          ("disagg", DisaggOptions),
                          ("debug", DebugOptions)):
            if not isinstance(getattr(self, name), typ):
                raise TypeError(f"EngineOptions.{name} must be a "
                                f"{typ.__name__}, "
                                f"got {type(getattr(self, name)).__name__}")

    @classmethod
    def build(cls, base: "EngineOptions | None" = None,
              **legacy) -> "EngineOptions":
        """Merge flat legacy Engine kwargs over `base` (or the defaults).

        Reproduces the historic loose-kwarg semantics exactly: `sampling`
        may be a method name or a ready SamplingConfig, with
        temperature/top_k/top_p as its parameters; `eos_id` becomes a
        one-token default stop set (an explicit `stop_tokens` wins).
        None values mean "not given" and are skipped; unknown names raise
        TypeError like a bad keyword argument would."""
        base = cls() if base is None else base
        legacy = {k: v for k, v in legacy.items() if v is not None}
        smp_over = {f: legacy.pop(f) for f in
                    ("temperature", "top_k", "top_p") if f in legacy}
        sampling = base.sampling
        if "sampling" in legacy:
            s = legacy.pop("sampling")
            if isinstance(s, SamplingConfig):
                sampling = dataclasses.replace(s, **smp_over) \
                    if smp_over else s
            else:
                knobs = dict(temperature=1.0, top_k=0, top_p=1.0)
                knobs.update(smp_over)
                sampling = SamplingConfig(method=s, **knobs)
        elif smp_over:
            sampling = dataclasses.replace(sampling, **smp_over)
        if "eos_id" in legacy:
            eos = legacy.pop("eos_id")
            legacy.setdefault("stop_tokens", (int(eos),))
        sections: dict[str, dict] = {}
        for name, val in list(legacy.items()):
            if name not in _LEGACY:
                raise TypeError(f"unknown Engine option {name!r}")
            sec, field = _LEGACY[name]
            sections.setdefault(sec, {})[field] = legacy.pop(name)
        out = {"sampling": sampling}
        for sec, over in sections.items():
            out[sec] = dataclasses.replace(getattr(base, sec), **over)
        return dataclasses.replace(base, **out)


@dataclasses.dataclass(frozen=True)
class RequestResult:
    """Structured completion record for one request.

    finish_reason (text-agnostic):
      eos     — an emitted token hit the request's stop set
      budget  — the request's max_new_tokens were all emitted
      max_seq — the sequence ceiling bound the request (its budget was
                clamped at submit; see Engine.submit)
      aborted — cancelled via Engine.abort before completing

    Counters:
      prefill_tokens  — prompt tokens whose prefill compute actually ran
                        (prompt length minus the cached-prefix skip)
      drafted_tokens  — speculative tokens proposed for this request
      accepted_tokens — drafted tokens the verify pass emitted (the
                        per-request speedup numerator)
      pages_shared    — prefix-cache pages mapped read-only at admission
      ttft            — wall seconds from submit to first token, or None
                        if the request never produced one."""
    uid: int
    tokens: tuple
    finish_reason: str
    prefill_tokens: int = 0
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    pages_shared: int = 0
    ttft: float | None = None

    def __post_init__(self):
        if self.finish_reason not in FINISH_REASONS:
            raise ValueError(f"finish_reason must be one of "
                             f"{FINISH_REASONS}, got {self.finish_reason!r}")
        object.__setattr__(self, "tokens",
                           tuple(int(t) for t in self.tokens))
