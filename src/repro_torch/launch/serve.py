"""Serving launcher: batched requests through the port's engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        [--smoke] [--requests 8] [--new-tokens 12] [--slots 4] \
        [--max-seq 128] [--quant-bits 8] \
        [--capacity-factor 1.0] [--dispatch global|per_source] \
        [--sampling top_p --temperature 0.8 --top-p 0.95] [--seed 0] \
        [--decode-steps 1] [--prefill-chunk 16] \
        [--kv-layout paged|dense] [--page-size 16] [--num-pages 0] \
        [--decode-kernel auto|on|off] \
        [--prefix-cache on|off] [--prefix-chunk 16] \
        [--prefix-max-chains 4096] [--shared-prefix 0] \
        [--draft-len 0] [--spec-ngram 2] [--spec-table 512] \
        [--drafter ngram|model] [--draft-bits 2] [--draft-layers 0] \
        [--role prefill|decode|both --prefill-slots 4 --prefill-pages 16] \
        [--check-invariants] [--shard SPEC] [--device cuda|cpu]

Runs on the card by default (`--device cpu` runs the plain PyTorch
versions of the kernels).  Weights are random (`init_params` from a seeded
generator) and, with --quant-bits, quantized for serving one period at a
time as they are drawn (so qwen3-moe-30b-a3b fits the card at 8 bits).
Recurrent archs (xlstm-1.3b; jamba-1.5-large-398b, whose full depth does
not fit one card, at --smoke) prefill one token at a time.  The flags
are the reference launcher's (`--role both` serves disaggregated in this
process; "prefill" / "decode" raise, as the reference's do; without a mesh
`--dispatch per_source` is the dense dispatch, as in the reference).
`--shard SPEC` (an int for model-parallel ways, or a `build_mesh` spec
such as `data=2,model=2`) spawns one rank per mesh cell
(`parallel.comm.spawn`: gloo, every rank on the card, all on cuda:0 on one
H100, with host staging); each rank draws the same weights, keeps its
shard and serves the same requests, and rank 0 prints the report, with a
last line naming the mesh and the slots each rank's forwards run (a
`data` axis splits them: `--shard data=2` runs 2 of 4 slots a rank).  The
report lines keep the reference's wording: requests done and
tok/s, syncs and finish reasons, speculation's acceptance and tokens per
tick, the kv pool, the page transfer of disaggregation, the prefix
cache's hit rate and refcount histogram, or the dense reservation.
"""
from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.bramac_linear import QuantConfig
from repro_torch.models import model as M
from repro_torch.models.transformer import is_recurrent
from repro_torch.parallel import comm, sharding
from repro_torch.runtime.options import (DebugOptions, DisaggOptions,
                                         EngineOptions, PagingOptions,
                                         ParallelOptions, PrefixOptions,
                                         ScheduleOptions, SpeculationOptions)
from repro_torch.runtime.sampling import SamplingConfig
from repro_torch.runtime.serve import Engine, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--quant-bits", type=int, default=0, choices=(0, 2, 4, 8))
    ap.add_argument("--capacity-factor", type=float, default=0.0,
                    help="MoE expert-capacity factor (0 = config default, "
                         "%(default)s); lower is lossier but faster")
    ap.add_argument("--dispatch", default="",
                    choices=("", "global", "per_source"),
                    help="MoE token dispatch: 'global' or 'per_source' "
                         "(without a mesh both are the dense dispatch; "
                         "empty = config default)")
    ap.add_argument("--sampling", default="greedy",
                    choices=("greedy", "temperature", "top_k", "top_p"),
                    help="on-device sampling method (%(default)s)")
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="softmax temperature for stochastic sampling")
    ap.add_argument("--top-k", type=int, default=0,
                    help="k for --sampling top_k")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus mass for --sampling top_p")
    ap.add_argument("--decode-steps", type=int, default=1,
                    help="decode steps per engine tick: host syncs per "
                         "generated token scale as 1/decode_steps")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="prompt chunk size for admission prefill "
                         "(recurrent archs always use 1)")
    ap.add_argument("--seed", type=int, default=0,
                    help="engine base seed for request sampling streams")
    ap.add_argument("--kv-layout", default="paged",
                    choices=("paged", "dense"),
                    help="KV-cache layout: 'paged' shares a pool of fixed-"
                         "size pages through per-slot block tables, 'dense' "
                         "reserves max_seq rows per slot (%(default)s)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="rows per KV page (0 = config default)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="total pages in the shared pool (0 = slots * "
                         "ceil(max_seq/page_size))")
    ap.add_argument("--decode-kernel", default="auto",
                    choices=("auto", "on", "off"),
                    help="paged-decode kernels for Sq=1 reads ('auto' = on "
                         "for CUDA; 'off' = the gather oracle)")
    ap.add_argument("--prefix-cache", default="on", choices=("on", "off"),
                    help="share cached prompt prefixes across requests "
                         "(paged layout only; %(default)s)")
    ap.add_argument("--prefix-chunk", type=int, default=0,
                    help="prefix-cache hash granularity in tokens "
                         "(0 = page_size)")
    ap.add_argument("--prefix-max-chains", type=int, default=4096,
                    help="prefix-registry capacity; LRU chains beyond it "
                         "are evicted (%(default)s)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many identical 'system prompt' "
                         "tokens to every request (exercises the prefix "
                         "cache)")
    ap.add_argument("--draft-len", type=int, default=0,
                    help="self-speculative draft window per decode step "
                         "(0 = off); greedy streams are identical either "
                         "way, accepted drafts just land several tokens per "
                         "verify pass")
    ap.add_argument("--spec-ngram", type=int, default=2,
                    help="n-gram order of the speculation drafter")
    ap.add_argument("--spec-table", type=int, default=512,
                    help="per-slot drafter table buckets")
    ap.add_argument("--drafter", default="ngram", choices=("ngram", "model"),
                    help="speculation proposal engine: the online n-gram "
                         "table, or 'model' — the serving weights "
                         "requantized to --draft-bits decoding through a "
                         "private draft KV cache (%(default)s)")
    ap.add_argument("--draft-bits", type=int, default=2, choices=(2, 4, 8),
                    help="draft-model weight/activation precision "
                         "(%(default)s — the BRAMAC 2-bit datapath)")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="truncate the draft model to its first N blocks "
                         "(0 = full depth; whole layer-pattern periods)")
    ap.add_argument("--role", default="",
                    choices=("", "prefill", "decode", "both"),
                    help="prefill/decode disaggregation: 'both' runs the "
                         "split engine in-process (prefill worker with its "
                         "own page pool, page-granularity KV handoff into "
                         "the decode worker); 'prefill'/'decode' are the "
                         "future multi-process endpoints (empty = "
                         "colocated, no split)")
    ap.add_argument("--prefill-slots", type=int, default=0,
                    help="disagg: prefill-worker slot count (0 = same as "
                         "--slots)")
    ap.add_argument("--prefill-pages", type=int, default=0,
                    help="disagg: prefill-worker pool pages (0 = capacity-"
                         "equal: prefill_slots * ceil(max_seq/page_size))")
    ap.add_argument("--check-invariants", action="store_true",
                    help="cross-check the host page-pool mirror against "
                         "the device allocator after every sync")
    ap.add_argument("--shard", default="",
                    help="mesh of ranks: an int for model-parallel ways or a "
                         "composed spec such as data=2,model=2 (one rank "
                         "per cell; empty or 0 = one process, no mesh)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.shard and args.shard != "0":
        try:
            world = sharding.spec_ranks(args.shard)
        except ValueError as e:
            raise SystemExit(f"--shard {args.shard!r}: {e}")
        comm.spawn(_serve_rank, world, args, device=args.device)
        return
    _serve(args, resolve_device(args.device))


def _serve_rank(rank, world, device, args):
    """One rank of `--shard`: the mesh over every rank, then the serve;
    rank 0 reports."""
    _serve(args, device, mesh=sharding.build_mesh(args.shard),
           report=rank == 0)


def _serve(args, device, mesh=None, report=True):
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.page_size:
        cfg = cfg.replace(page_size=args.page_size)
    if args.quant_bits:
        cfg = cfg.replace(quant=QuantConfig(enabled=True,
                                            bits_w=args.quant_bits,
                                            bits_a=args.quant_bits))
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, gen, device, serving=cfg.quant)
    options = EngineOptions(
        sampling=SamplingConfig(method=args.sampling,
                                temperature=args.temperature,
                                top_k=args.top_k, top_p=args.top_p),
        schedule=ScheduleOptions(num_slots=args.slots, max_seq=args.max_seq,
                                 decode_steps=args.decode_steps,
                                 prefill_chunk=args.prefill_chunk,
                                 seed=args.seed),
        paging=PagingOptions(kv_layout=args.kv_layout,
                             num_pages=args.num_pages or None,
                             decode_kernel=None if args.decode_kernel ==
                             "auto" else args.decode_kernel == "on"),
        prefix=PrefixOptions(enabled=args.prefix_cache == "on",
                             chunk=args.prefix_chunk or None,
                             max_chains=args.prefix_max_chains),
        speculation=SpeculationOptions(draft_len=args.draft_len,
                                       ngram=args.spec_ngram,
                                       table=args.spec_table,
                                       drafter=args.drafter,
                                       draft_bits=args.draft_bits,
                                       draft_layers=args.draft_layers
                                       or None),
        parallel=ParallelOptions(mesh=mesh,
                                 capacity_factor=args.capacity_factor
                                 or None,
                                 dispatch=args.dispatch or None),
        disagg=DisaggOptions(enabled=bool(args.role),
                             role=args.role or "both",
                             prefill_slots=args.prefill_slots or None,
                             prefill_pages=args.prefill_pages or None),
        debug=DebugOptions(check_invariants=args.check_invariants))
    rng = np.random.default_rng(0)
    with Engine(cfg, params, options=options, device=device) as eng:
        shared = rng.integers(0, cfg.vocab_size, size=args.shared_prefix)
        reqs = [eng.submit(np.concatenate([
                    shared, rng.integers(0, cfg.vocab_size,
                                         size=int(rng.integers(4, 24)))]),
                           args.new_tokens)
                for _ in range(args.requests)]
        t0 = time.perf_counter()
        results = eng.run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        if not report:
            return
        done = sum(r.done for r in reqs)
        toks = sum(len(r.tokens) for r in results)
        ttft = [r.ttft for r in results if r.ttft is not None]
        reasons = collections.Counter(r.finish_reason for r in results)
        print(f"{done}/{len(reqs)} requests done, {toks} tokens in {dt:.1f}s "
              f"({toks / dt:.1f} tok/s, quant="
              f"{'int%d' % args.quant_bits if args.quant_bits else 'off'}, "
              f"sampling={args.sampling}, device={device}"
              f"{'' if mesh is None else f', mesh={mesh.shape}'})")
        print(f"  {eng.n_syncs} host syncs for {eng.n_generated} tokens "
              f"({eng.n_syncs / max(eng.n_generated, 1):.2f} syncs/tok at "
              f"decode_steps={args.decode_steps}); mean ttft "
              f"{1e3 * float(np.mean(ttft)) if ttft else 0.0:.0f}ms; "
              f"finish reasons "
              f"{{{', '.join(f'{k}: {v}' for k, v in sorted(reasons.items()))}}}")
        if is_recurrent(cfg):
            print("  prefill: recurrent arch, prompts prefill one token at a "
                  "time")
        st = eng.spec_stats()
        if args.draft_len:
            if st["enabled"]:
                print(f"  speculation: drafter={st['drafter']}, "
                      f"draft_len={st['draft_len']}, "
                      f"{st['accepted']}/{st['drafted']} drafts accepted "
                      f"({100 * st['acceptance_rate']:.0f}%), "
                      f"{eng.n_generated / max(eng.n_ticks, 1):.2f} "
                      f"tokens/tick")
            else:
                print("  speculation: requested but this arch opts out "
                      "(recurrent / cross-attention / MoE)")
        if eng.kv_layout == "paged":
            dense_rows = eng.num_slots * eng.max_seq
            hw_rows = eng.pages_high_water * eng.page_size
            print(f"  kv pool: {eng.pages_high_water}/{eng.num_pages} pages "
                  f"high-water x {eng.page_size} rows = {hw_rows} rows "
                  f"({100 * hw_rows / dense_rows:.0f}% of the dense "
                  f"{dense_rows}-row reservation); "
                  f"{eng.pages_in_use} pages still in use")
            print(f"  kv reads: decode_kernel="
                  f"{'on' if eng.decode_kernel else 'off'}, "
                  f"{eng.kv_bytes_read / max(eng.kv_read_steps, 1):.0f} "
                  f"bytes/step over {eng.kv_read_steps} decode steps "
                  f"({'live-token bounded' if eng.decode_kernel else 'max_seq gather'})")
            if eng.disagg:
                dg = eng.disagg_stats()
                print(f"  disagg: {dg['pages_transferred']} pages "
                      f"transferred in {dg['transfer_rounds']} rounds "
                      f"({dg['transfers_backpressured']} backpressured); "
                      f"decode-worker occupancy "
                      f"{dg['decode_pages_high_water']}/"
                      f"{dg['decode_pages']} pages high-water, prefill "
                      f"pool {dg['prefill_pages_high_water']}/"
                      f"{dg['prefill_pages']} over {dg['prefill_slots']} "
                      f"slots")
            st = eng.prefix_stats()
            if st["enabled"]:
                hist = eng.pool.refcount_hist()
                print(f"  prefix cache: {st['hits']}/{st['hits'] + st['misses']}"
                      f" hits ({100 * st['hit_rate']:.0f}%), "
                      f"{st['tokens_skipped']} prefill tokens skipped "
                      f"({st['chunks_skipped']} chunks), "
                      f"{st['evictions']} evictions, "
                      f"{st['cached_pages']} pages cached; "
                      f"pages-shared high-water "
                      f"{eng.pages_shared_high_water}; refcount hist "
                      f"{{{', '.join(f'{r}: {n}' for r, n in enumerate(hist) if n)}}}")
            else:
                print("  prefix cache: off")
        else:
            print(f"  kv dense: {eng.num_slots} slots x {eng.max_seq} rows "
                  f"reserved up front ({eng.num_slots * eng.max_seq} rows)")
        if mesh is not None:
            print(f"  mesh {mesh.shape}: each rank's forwards run "
                  f"{eng.rank_slots} of the {eng.num_slots} slots")


if __name__ == "__main__":
    main()
