"""Serving launcher: batched requests through the port's engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        [--smoke] [--requests 8] [--new-tokens 12] [--slots 4] \
        [--max-seq 128] [--quant-bits 8] [--decode-steps 1] \
        [--prefill-chunk 16] [--page-size 16] [--num-pages 0] \
        [--decode-kernel auto|on|off] [--device cuda|cpu]

Runs on the card by default (`--device cpu` runs the plain PyTorch
versions of the kernels).  Weights are random (`init_params` from a seeded
generator) and, with --quant-bits, quantized once for serving.  The flags
are the subset of the reference launcher's that this slice serves, and the
report keeps its `N/N requests done, … tok/s` line.
"""
from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.bramac_linear import QuantConfig, tree_prepare_serving
from repro_torch.models import model as M
from repro_torch.runtime.options import (EngineOptions, PagingOptions,
                                         PrefixOptions, ScheduleOptions)
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
    ap.add_argument("--decode-steps", type=int, default=1,
                    help="decode steps per engine tick: host syncs per "
                         "generated token scale as 1/decode_steps")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="prompt chunk size for admission prefill")
    ap.add_argument("--page-size", type=int, default=0,
                    help="rows per KV page (0 = config default)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="total pages in the shared pool (0 = slots * "
                         "ceil(max_seq/page_size))")
    ap.add_argument("--decode-kernel", default="auto",
                    choices=("auto", "on", "off"),
                    help="paged-decode kernels for Sq=1 reads ('auto' = on "
                         "for CUDA; 'off' = the gather oracle)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.page_size:
        cfg = cfg.replace(page_size=args.page_size)
    if args.quant_bits:
        cfg = cfg.replace(quant=QuantConfig(enabled=True,
                                            bits_w=args.quant_bits,
                                            bits_a=args.quant_bits))
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, gen, device)
    if args.quant_bits:
        params = tree_prepare_serving(params, cfg.quant)
    options = EngineOptions(
        schedule=ScheduleOptions(num_slots=args.slots, max_seq=args.max_seq,
                                 decode_steps=args.decode_steps,
                                 prefill_chunk=args.prefill_chunk),
        paging=PagingOptions(num_pages=args.num_pages or None,
                             decode_kernel=None if args.decode_kernel ==
                             "auto" else args.decode_kernel == "on"),
        prefix=PrefixOptions(enabled=False))
    rng = np.random.default_rng(0)
    with Engine(cfg, params, options=options, device=device) as eng:
        reqs = [eng.submit(rng.integers(0, cfg.vocab_size,
                                        size=int(rng.integers(4, 24))),
                           args.new_tokens)
                for _ in range(args.requests)]
        t0 = time.perf_counter()
        results = eng.run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        done = sum(r.done for r in reqs)
        toks = sum(len(r.tokens) for r in results)
        ttft = [r.ttft for r in results if r.ttft is not None]
        reasons = collections.Counter(r.finish_reason for r in results)
        print(f"{done}/{len(reqs)} requests done, {toks} tokens in {dt:.1f}s "
              f"({toks / dt:.1f} tok/s, quant="
              f"{'int%d' % args.quant_bits if args.quant_bits else 'off'}, "
              f"sampling=greedy, device={device})")
        print(f"  {eng.n_syncs} host syncs for {eng.n_generated} tokens "
              f"({eng.n_syncs / max(eng.n_generated, 1):.2f} syncs/tok at "
              f"decode_steps={args.decode_steps}); mean ttft "
              f"{1e3 * float(np.mean(ttft)) if ttft else 0.0:.0f}ms; "
              f"finish reasons "
              f"{{{', '.join(f'{k}: {v}' for k, v in sorted(reasons.items()))}}}")
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
        print("  prefix cache: not ported")


if __name__ == "__main__":
    main()
