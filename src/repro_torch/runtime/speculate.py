"""Self-speculative decoding for the serving engine (port of
`repro.runtime.speculate`): draft cheap, verify exact — the BRAMAC trade (a
reduced-precision approximate datapath whose results the exact one
validates) applied to token generation.

Two drafters behind one `Drafter` protocol (the engine only calls
init_state / reset / observe / propose): `NGramDrafter`, a per-slot
direct-mapped n-gram table learned online from the slot's own prompt and
emitted tokens, and `QuantDrafter`, the serving model's own weights
requantized to 2 bits (the BRAMAC low-precision datapath, through the
same `bramac_matmul` kernel) decoding through a private per-slot draft KV
cache.  The engine scores the window [last_tok, g_1..g_d] in ONE forward
(the chunked path prefill uses) and `sampling.spec_verify` accepts or
replaces every position on the device.

Acceptance invariants (the contract the parity tests prove):

  A1 (greedy parity)  Under greedy sampling the emitted stream is identical
      to non-speculative decoding, whatever the drafter proposes: position
      i's draft is accepted iff it EQUALS the argmax of position i-1's
      verify logits, and the first rejected position emits that argmax
      instead.  A drafter changes how fast tokens appear, never which.
  A2 (stochastic marginals)  Under temperature/top_k/top_p the accept rule
      is rejection sampling against the drafter's point mass: accept g with
      probability p(g), else resample from p with g masked out — each
      emitted token is marginally ~ p, as in the sequential loop (the
      stream itself may differ: randomness is drawn per window).
  A3 (termination parity)  Stop-token / budget / max_seq clamping applies to
      the accepted window exactly as the sequential loop would: n_emit =
      min(first-stop-index + 1, n_acc + 1, budget, max_seq - 1 - pos).
  A4 (rollback)  KV rows written for rejected draft positions (window
      indices >= n_emit) are zeroed through the write's own mask /
      ownership / bound discipline (pages.rollback for the paged pool,
      rollback_dense here) before the tick returns, page-boundary
      crossings included.
  A5 (determinism)  Table inserts are a sequential loop over the observed
      positions (last write wins), never a duplicate-index scatter whose
      order is unspecified: the table equals a pure-Python replay.
  A6 (draft-cache replay)  The model drafter's private KV cache holds
      exactly the K/V of the slot's verified stream: only `observe` writes
      it (verified emissions, appended at the stream offset with the same
      masked / bounded writes as the main cache).  The port writes caches
      in place, so `propose` saves the d cache rows its draft steps write
      (positions n_stream-1 .. n_stream+d-2) before it runs and puts them
      back after, dropping positions outside [0, max_seq): a rejected
      window leaves no residue.

The n-gram hash is FNV-1a over uint32 in int64 arithmetic: every product
is masked back to 32 bits (h < 2^32 and the prime < 2^25, so it fits), and
keys are stored as int64 holding the uint32 value `h | 1`.  Nothing here
reads a device value back.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Protocol

import torch

from repro_torch.core import bramac_linear as bl
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.tree import tree_map
from repro_torch.runtime.pages import zero_rows

# FNV-1a over (token + 1) in wrapping uint32; +1 keeps the -1 history
# padding from colliding with token 0
FNV_OFFSET = 2166136261
FNV_PRIME = 16777619
_U32 = 0xFFFFFFFF


def ngram_hash(ctx: torch.Tensor) -> torch.Tensor:
    """(…, n) int token context -> (…,) int64 holding the uint32 FNV-1a
    hash (wrapping)."""
    h = torch.full(ctx.shape[:-1], FNV_OFFSET, dtype=torch.int64,
                   device=ctx.device)
    for j in range(ctx.shape[-1]):
        t = (ctx[..., j].to(torch.int64) + 1) & _U32
        h = ((h ^ t) * FNV_PRIME) & _U32
    return h


class DraftState(NamedTuple):
    """Per-slot n-gram drafter state.

    keys  (S, T) i64 — uint32 `hash | 1` of the context stored per bucket
          (0 means empty; the offset keeps a context whose hash is exactly
          0 from false-hitting every empty bucket)
    nexts (S, T) i32 — the token observed after that context
    hist  (S, ctx) i32 — the slot's most recent ctx tokens, -1-padded"""
    keys: torch.Tensor
    nexts: torch.Tensor
    hist: torch.Tensor


def empty_state(num_slots: int, device=None) -> DraftState:
    """Zero-width placeholder when speculation is off."""
    return DraftState(
        torch.zeros((num_slots, 0), dtype=torch.int64, device=device),
        torch.zeros((num_slots, 0), dtype=torch.int32, device=device),
        torch.zeros((num_slots, 0), dtype=torch.int32, device=device))


class Drafter(Protocol):
    """What the engine needs from a drafter: a per-slot state, a reset of
    admitted slots, `observe` of verified tokens (S, L) under a (S, L) mask,
    and `propose` of (S, draft_len) i32 drafts.  None of them syncs."""

    def init_state(self, num_slots: int, device=None): ...

    def reset(self, state, mask): ...

    def observe(self, state, tokens, mask): ...

    def propose(self, state, draft_len: int): ...


@dataclasses.dataclass(frozen=True)
class NGramDrafter:
    """Prompt-lookup / n-gram self-speculation.

    A direct-mapped table of `table` buckets per slot maps the hash of the
    last `ngram - 1` tokens to the token that followed it last time (last
    write wins).  Lookups check the stored full hash; a miss falls back to
    repeating the most recent token."""
    ngram: int = 2
    table: int = 512

    @property
    def ctx(self) -> int:
        return self.ngram - 1

    def init_state(self, num_slots: int, device=None) -> DraftState:
        return DraftState(
            torch.zeros((num_slots, self.table), dtype=torch.int64,
                        device=device),
            torch.zeros((num_slots, self.table), dtype=torch.int32,
                        device=device),
            torch.full((num_slots, self.ctx), -1, dtype=torch.int32,
                       device=device))

    def reset(self, ds: DraftState, mask) -> DraftState:
        """Clear the slots in `mask` (S,) bool: a new request must not
        inherit its slot's previous occupant's transitions."""
        m = mask[:, None]
        return DraftState(torch.where(m, 0, ds.keys),
                          torch.where(m, 0, ds.nexts),
                          torch.where(m, -1, ds.hist))

    def observe(self, ds: DraftState, tokens, mask) -> DraftState:
        """Feed observed tokens (S, L) in window order; mask (S, L) bool
        selects the real entries per slot.  One transition (hash(hist) ->
        token) per observed token, then the history shifts — a loop over
        the L columns, so same-bucket collisions resolve last-write-wins
        (A5).  Masked entries write to a sink column T, which is cut off."""
        S, T = tokens.shape[0], self.table
        z = torch.zeros((S, 1), dtype=ds.keys.dtype, device=ds.keys.device)
        keys = torch.cat([ds.keys, z], dim=1)
        nexts = torch.cat([ds.nexts, z.to(ds.nexts.dtype)], dim=1)
        hist = ds.hist
        tokens = tokens.to(torch.int32)
        for j in range(tokens.shape[1]):
            tok, m = tokens[:, j], mask[:, j]
            h = ngram_hash(hist)                                   # (S,)
            tgt = torch.where(m, h % T, T)[:, None]
            keys.scatter_(1, tgt, (h | 1)[:, None])
            nexts.scatter_(1, tgt, tok[:, None])
            hist = torch.where(m[:, None],
                               torch.cat([hist[:, 1:], tok[:, None]], dim=1),
                               hist)
        return DraftState(keys[:, :T], nexts[:, :T], hist)

    def propose(self, ds: DraftState, draft_len: int) -> torch.Tensor:
        """Chain `draft_len` table lookups from each slot's history.
        Read-only: speculative continuations are never inserted (only
        verified emissions are, via observe).  Returns (S, draft_len) i32."""
        T = self.table
        hist, gs = ds.hist, []
        for _ in range(draft_len):
            h = ngram_hash(hist)
            idx = (h % T)[:, None]
            hit = torch.gather(ds.keys, 1, idx)[:, 0] == (h | 1)
            g = torch.where(hit, torch.gather(ds.nexts, 1, idx)[:, 0],
                            hist[:, -1])
            hist = torch.cat([hist[:, 1:], g[:, None]], dim=1)
            gs.append(g)
        return torch.stack(gs, dim=1)


class QuantDraftState(NamedTuple):
    """Per-slot state of the model drafter (the requantized weights stay
    on the drafter; the reference carries them in the state only so that
    buffer donation aliases them through its compiled tick).

    caches    private dense draft KV, (n_periods, S, max_seq, …) leaves
              from model.init_cache on the draft config.
    n_stream  (S,) i32 — verified-stream length = draft-cache rows held.
    last      (S,) i32 — the slot's most recent verified token."""
    caches: Any
    n_stream: torch.Tensor
    last: torch.Tensor


@dataclasses.dataclass(frozen=True)
class QuantDrafter:
    """The 2-bit BRAMAC draft model: the serving model's own weights
    requantized to `draft_bits` (optionally cut to the first
    `draft_layers` blocks, sharing the embedding and final norm), run
    through the quantized serving path (`bramac_linear.serve_dense` →
    `ops.quant_matmul` → `bramac_matmul`).

    Its draft KV cache obeys A6: rows [0, n_stream) hold exactly the K/V of
    the slot's verified stream.  `observe` appends verified tokens in ONE
    chunked draft forward at `cache_pos = n_stream` (masked rows, and rows
    at or past n_stream + n, drop); `propose` decodes `draft_len` greedy
    steps, feeding `last` at position n_stream - 1 first, and restores the
    rows it wrote.  `reset` restores admitted slots' rows to the init-cache
    values (int8-KV scale leaves init to ones, not zeros)."""
    cfg: Any                       # draft ModelConfig (quant enabled)
    params: Any = dataclasses.field(repr=False)
    max_seq: int = 0

    @classmethod
    def build(cls, cfg, params, max_seq: int, bits: int,
              draft_layers: int | None) -> "QuantDrafter":
        """Requantize the serving tree into a drafter.  `draft_layers` cuts
        to the first N blocks (whole periods of cfg.layer_pattern); the
        embedding and final norm are shared with the serving tree, the
        unembed head is requantized like every other servable matmul."""
        n_layers = cfg.num_layers if draft_layers is None else draft_layers
        pat = len(cfg.layer_pattern)
        if n_layers % pat or not 0 < n_layers <= cfg.num_layers:
            raise ValueError(
                f"draft_layers must be a multiple of the {pat}-block "
                f"layer pattern in [1, {cfg.num_layers}], got {n_layers}")
        periods = n_layers // pat
        draft_cfg = cfg.replace(
            num_layers=n_layers,
            quant=bl.QuantConfig(enabled=True, bits_w=bits, bits_a=bits))
        layers = tree_map(lambda a: a[:periods], params["layers"])
        draft_params = bl.tree_requantize_serving(
            {"embed": params["embed"], "final_norm": params["final_norm"],
             "layers": layers}, draft_cfg.quant)
        return cls(cfg=draft_cfg, params=draft_params, max_seq=max_seq)

    @property
    def device(self) -> torch.device:
        return self.params["final_norm"]["scale"].device

    def init_state(self, num_slots: int, device=None) -> QuantDraftState:
        device = self.device if device is None else device
        z = torch.zeros((num_slots,), dtype=torch.int32, device=device)
        return QuantDraftState(
            caches=M.init_cache(self.cfg, num_slots, self.max_seq,
                                device=device),
            n_stream=z, last=z.clone())

    def reset(self, ds: QuantDraftState, mask) -> QuantDraftState:
        """Restore the slots in `mask` (S,) bool to init-cache values, in
        place: each cache leaf is constant at init (zeros, or ones for the
        int8 scales), so a masked fill writes only those slots' rows."""
        S = ds.n_stream.shape[0]
        init = M.init_cache(self.cfg, 1, 1, device="cpu")

        def fill(v, ini):
            m = mask.reshape((1, S) + (1,) * (v.ndim - 2))
            v.masked_fill_(m, ini.reshape(-1)[0].item())

        tree_map(fill, ds.caches, init)
        return ds._replace(n_stream=torch.where(mask, 0, ds.n_stream),
                           last=torch.where(mask, 0, ds.last))

    def observe(self, ds: QuantDraftState, tokens, mask) -> QuantDraftState:
        """Append verified tokens (S, L) to the draft cache in one chunked
        draft forward at cache_pos = n_stream.  mask (S, L) bool must be
        left-contiguous per slot (it is at every call site: admission
        chunks and the tick's emission window); rows at or past each slot's
        n_stream + n drop, so the masked tail never reaches the cache."""
        n = mask.sum(dim=1).to(torch.int32)                        # (S,)
        pv = attn.DenseKV(write_mask=n > 0, max_seq=self.max_seq,
                          bound=ds.n_stream + n)
        M.forward(self.params, {"tokens": tokens}, self.cfg,
                  caches=ds.caches, cache_pos=ds.n_stream, last_only=True,
                  paged=pv)
        L = tokens.shape[1]
        last = torch.gather(tokens.to(torch.int32), 1,
                            (n - 1).clamp(0, L - 1).long()[:, None])[:, 0]
        return ds._replace(n_stream=ds.n_stream + n,
                           last=torch.where(n > 0, last, ds.last))

    def propose(self, ds: QuantDraftState, draft_len: int) -> torch.Tensor:
        """`draft_len` greedy draft decode steps from the verified stream;
        the first feeds `last` at position n_stream - 1.  The rows the
        steps write (positions n_stream-1 .. n_stream+draft_len-2) are
        saved first and put back after, so the draft cache never keeps a
        draft token (A6).  Returns (S, draft_len) i32 drafts."""
        S = ds.n_stream.shape[0]
        dev = ds.n_stream.device
        win = ds.n_stream[:, None] - 1 \
            + torch.arange(draft_len, dtype=torch.int32, device=dev)[None]
        rows = torch.arange(S, device=dev)[:, None].expand(S, draft_len)
        index = (rows.reshape(-1),
                 win.clamp(0, self.max_seq - 1).reshape(-1).long())
        saved = _gather_rows(ds.caches, index)
        pv = attn.DenseKV(write_mask=torch.ones((S,), dtype=torch.bool,
                                                device=dev),
                          max_seq=self.max_seq)
        tok, pos, gs = ds.last, ds.n_stream - 1, []
        for _ in range(draft_len):
            logits, _ = M.decode_step(self.params, tok[:, None], self.cfg,
                                      ds.caches, pos, paged=pv)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            pos = pos + 1
            gs.append(tok)
        # every row a step wrote lies in [0, max_seq) and is among the
        # clamped saved positions; rows saved twice hold identical values
        _put_rows(ds.caches, index, saved)
        return torch.stack(gs, dim=1)


def _gather_rows(caches, index):
    return tree_map(lambda v: v[(slice(None),) + index], caches)


def _put_rows(caches, index, saved) -> None:
    def put(v, rows):
        v[(slice(None),) + index] = rows
    tree_map(put, caches, saved)


def rollback_dense(caches, kv_flags, positions, write_mask, max_seq: int):
    """Zero rejected speculative rows in the dense layout (A4), in place.
    positions (S, L) holds the rejected rows' absolute positions (the
    caller routes kept rows to max_seq, which drops); kv_flags is
    model.cache_pool_flags(cfg) — True at the attention KV leaves, whose
    dense shape is (n_periods, S, max_seq, ...)."""
    S, L = positions.shape
    ok = (write_mask[:, None] & (positions < max_seq)).reshape(-1)
    rows = torch.arange(S, device=positions.device)[:, None].expand(S, L)
    index = (rows.reshape(-1), positions.clamp(0, max_seq - 1).reshape(-1))

    def zero(v, is_kv):
        if is_kv:
            zero_rows(v, index, ok)

    tree_map(zero, caches, kv_flags)
    return caches
