"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Every phase runs, and the result lines are printed.

Builds the port's CUDA kernels from `src/repro_torch/kernels/csrc`, holds
each against its plain PyTorch version at its path's shapes, runs the paper
path (`repro_torch.launch.paper`: the analytical models' rows, which must
equal `benchmarks/baseline.json`, and the Fig 11 GEMVs through the
dummy-array MAC2 kernel) and times that kernel on every granite-8b linear
as a GEMV, serves granite-8b at full size (36 layers, d=4096, bf16, 8-bit
BRAMAC weights, random weights from a seed) through the port's Engine with
fp and int8 KV caches, counts that each path went through its kernels, and
checks that greedy streams are identical with the decode kernels on and off
and under the dense layout, with the prefix cache on and off, and with
speculation on and off (phase 6, f32). Phases 8-10 run granite-8b at full
width cut to 12 of its 36 layers (views of phase 5's stacked weights).
Phase 8 serves the rest of the Engine: the prefix cache with copy-on-write
splits and invariant checks (bf16 and int8 KV, on vs off), abort of a
running and a queued request, and per-request sampling streams that depend
on the seed only. Phase 9 serves speculative decoding: an integer-exact
structured stream without speculation, with the n-gram drafter and with the
2-bit draft model (all 12 layers), then phase 5's weights and prompts with
both drafters, every `bramac_matmul` launch held to its derived count.
Phase 10 serves prefill/decode disaggregation (streams and launch counts
equal to the cut's colocated serves, invariants I1–I7 checked on both
pools, decode-pool backpressure, the transfer rounds timed beside their
byte bound) and minicpm3-4b (MLA) at full size, colocated and
disaggregated. Phase 11 serves the MoE feed-forward: the expert einsum (one
`bramac_matmul` per expert) bit-exact and timed at qwen3-moe-30b-a3b's
shapes, one MoE layer at full width against its dense reference,
qwen3-moe-30b-a3b at full width cut to 16 of its 48 layers (128 experts,
each layer quantized as it is drawn) with bf16 and int8 KV, and its stream
identities at 2 layers. Phase 12 serves the recurrent mixers: one
full-width mLSTM, sLSTM and mamba block (sequence == steps at f32; bf16
8-bit vs plain f32), xlstm-1.3b at full width (48 layers, one-token
prefill) and jamba-1.5-large-398b at full width cut to one period (8 of its
72 layers), and their stream identities and slot reuse at 2 periods of the
smoke widths; phase 2 holds `bramac_matmul` at their mixers' shapes and
phases 3-4 both decode kernels at jamba's 64/8 heads. Phase 13 trains: the
QAT `bramac_dense` bit-exact vs its plain version at granite-8b's training
rows (M = 256) with its straight-through gradients equal to the plain
products; granite-8b at full width (36 layers, bf16, QAT 8/8, int8 m / bf16
v AdamW) taking 4 `Trainer.run_step`s, 253 `bramac_matmul` launches each,
step 1's loss equal to the plain version's; failure recovery at the smoke
widths equal to an uninterrupted run bit for bit, and the checkpoint round
trip. Phase 14 runs cross-attention and the stub frontends:
llama-3.2-vision-11b at full width (forward-level: prefill with vision
embeddings, 16 decode steps, the xattn K/V caches unchanged, each token the
full forward's argmax or a near-tie swap) and musicgen-large at full width
through the Engine (bf16 and int8 KV; `frame_embeds` == tokens); phase 2
holds `bramac_matmul` at their linears (the xattn K/V projection at M =
1600 and 6400) and phases 3-4 both decode kernels at musicgen's 32/32
heads. Phase 15 runs the parallel family on 2 ranks (processes) that
share the card, collecting over gloo with host staging: (a) the matmul's
int32 output mode bit-exact vs plain at granite-8b's TP-2 row shards and
at |acc| > 2^24, timed; (b) `tp_quant_matmul`, `ep_quant_einsum_edf`,
`ep_moe` and `make_dp_train_step` against their single-rank versions,
bit for bit; (c) granite-8b at full width and depth (36 layers) and (d)
qwen3-moe-30b-a3b at full width, 16 of 48 layers, through
`Engine(mesh="model=2")` with the decode kernels on each rank's KV heads,
streams equal to phases 5's and 11c's meshless serves, matmul and decode
kernel launches and collectives per forward equal to their derivation;
(e) `launch/serve.py --shard 2` and `launch/train.py
--data 2`. Phase 16 holds the dry run (`launch.dryrun`, counted on the
CPU's meta device) to live runs of the same step functions: granite-8b
training's predicted peak within 10% of phase 13b's measured one, a q8
decode step (B=8, 4096-row dense cache) and prefill (B=1, S=4096) on the
card with their peaks within 10% (or 0.5 GB) of the prediction and their
`bramac_matmul` launches equal to the counted calls, and the 145
collectives of the model=2 decode cell. Phase 2 also times the speculative shapes (the verify window at
M=20; 2-bit at M=4 with the unpack of the packed weights), every
minicpm3-4b linear and qwen3-moe-30b-a3b's attention linears and unembed;
phases 3-4 also hold both decode kernels at qwen3-moe-30b-a3b's heads
(32/4, hd 64); phase 6 also holds disaggregated == colocated and
minicpm3-4b's identities, the exact one on integer-exact structured
weights. Imports torch, numpy and `repro_torch` only. Exits non-zero,
printing no result, when any phase fails or no CUDA device is present.

Output: one line per phase; then a JSON line listing every kernel with its
check, times and bound; the card's name and power limit as nvidia-smi gives
them; and, last, {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# deterministic cuBLAS for phase 13c's bit-for-bit recovery check; it must
# be set before the first cuBLAS call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, int8 ops/s and
# float32 FLOP/s outside the tensor cores, from the port's one table of them
from repro_torch.launch.device import H100  # noqa: E402
HBM_BYTES_PER_S = H100.hbm_bytes_per_s
INT8_OPS_PER_S = H100.int8_ops_per_s
FP32_OPS_PER_S = H100.fp32_flops_per_s
L2_FLUSH_BYTES = 64 << 20          # > the 50 MB L2: each timed launch is cold

GRANITE_SHAPES = {                  # (K, N) of every linear on the path
    "wq/wo": (4096, 4096), "wk/wv": (4096, 1024), "w_gate/w_up": (4096, 14336),
    "w_down": (14336, 4096), "unembed": (4096, 49152)}


class PhaseError(RuntimeError):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


HOST_BOUND = []                    # readings whose enqueue outlasted the spin


@functools.cache
def spin_cycles_per_ms() -> float:
    """Clock cycles of `torch.cuda._sleep` per ms of device time."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    torch.cuda._sleep(20_000_000)
    b.record()
    torch.cuda.synchronize()
    return 20_000_000 / a.elapsed_time(b)


def time_cold(fn, iters: int = 20, spin_factor: float = 4,
              warmup: int = 3) -> float:
    """Mean ms of `fn()` on the device, the L2 flushed before each launch,
    after `warmup` untimed calls.
    A spin kernel ahead of the start event keeps the device busy while the
    host enqueues `fn`, so the interval holds device time, not the
    wrapper's Python time.  The spin lasts `spin_factor` x the host's
    enqueue time of one call (at least 1 ms); a reading in which some
    call's enqueue still outlasted the spin may include host time, and is
    printed and kept in HOST_BOUND."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = max(1.0, spin_factor * enqueue_ms)
    cycles = int(spin_ms * spin_cycles_per_ms())
    pairs, host_ms = [], []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        pairs.append((a, b))
    torch.cuda.synchronize()
    ms = sum(a.elapsed_time(b) for a, b in pairs) / iters
    if max(host_ms) > spin_ms:
        HOST_BOUND.append((ms, max(host_ms), spin_ms))
        print(f"  (timing: an enqueue took {max(host_ms):.3f} ms, longer "
              f"than the {spin_ms:.3f} ms device spin; the reading printed "
              f"next, {ms:.4f} ms, may include host time)")
    return ms


def rand_q(gen, bits, shape, signed=True):
    lo, hi = (-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if signed \
        else (0, (1 << bits) - 1)
    return torch.randint(lo, hi + 1, shape, generator=gen,
                         device="cuda").to(torch.int8)


# ---------------------------------------------------------------------------
# phase 2: bramac_matmul
# ---------------------------------------------------------------------------

def _offset_view(t, off):
    """The same values in a contiguous view that starts `off` elements into
    its storage, so the base pointer is off the allocation's alignment."""
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    v = buf[off:].view(t.shape)
    v.copy_(t)
    return v


def phase_matmul(gen, report):
    from repro_torch.core import quant
    from repro_torch.kernels import bramac_matmul as bm

    worst = 0.0

    def case(M, K, N, bits, signed, packed, od, per_channel, off=0):
        nonlocal worst
        x = rand_q(gen, bits, (M, K), signed)
        w = rand_q(gen, bits, (K, N))
        if per_channel:
            xs = torch.rand((M, 1), generator=gen, device="cuda") + 0.5
            ws = torch.rand((1, N), generator=gen, device="cuda") + 0.5
        else:
            xs = torch.full((1, 1), 0.75, device="cuda")
            ws = torch.full((1, 1), 1.25, device="cuda")
        wq = quant.pack_bits(w.T, 4).T.contiguous() if packed else w
        if off:
            x, wq = _offset_view(x, off), _offset_view(wq, 4 - off)
            need(x.is_contiguous() and x.data_ptr() % 4 == off,
                 "offset view is not what the case needs")
        kw = dict(bits_a=bits, bits_w=bits, signed=signed, out_dtype=od,
                  w_packed=packed)
        got = bm.bramac_matmul(x, wq, xs, ws, **kw)
        want = bm.bramac_matmul_plain(x, wq, xs, ws, **kw)
        torch.cuda.synchronize()
        worst = max(worst, (got.float() - want.float()).abs().max().item())
        need(torch.equal(got, want),
             f"bramac_matmul != plain at M,K,N={M},{K},{N} bits={bits} "
             f"signed={signed} packed={packed} out={od} offset={off}")
        return x, wq, xs, ws, kw

    n = 0
    for (M, K, N) in ((3, 100, 77), (5, 98, 33), (16, 64, 128)):
        for bits in (2, 4, 8):
            for signed in (True, False):
                for packed in ((False, True) if bits == 4 else (False,)):
                    for od in (torch.float32, torch.bfloat16):
                        for per_channel in (True, False):
                            case(M, K, N, bits, signed, packed, od,
                                 per_channel)
                            n += 1
    # contiguous views whose storage starts off a 4-byte boundary (K and N
    # multiples of 4): the kernel reads such chunks byte by byte
    for off in (1, 2, 3):
        for packed in (False, True):
            case(8, 64, 128, 4, True, packed, torch.float32, True, off=off)
            case(64, 256, 256, 4, True, packed, torch.bfloat16, True,
                 off=off)
            n += 2
    # the tile edges of the tensor-core kernel: rows around its 16- and
    # 64-row blocks, K off its 128-byte steps, N off its 128-column blocks,
    # packed weights in a 64-row block, and K split across many blocks
    for M in (1, 15, 16, 17, 63, 64, 65, 128):
        case(M, 200, 136, 8, True, False, torch.bfloat16, True)
        case(M, 192, 128, 4, False, True, torch.float32, True)
        n += 2
    for K in (96, 100, 4100):
        for M in (4, 64):
            case(M, K, 128, 8, True, False, torch.float32, True)
            n += 1
    for N in (77, 136):
        for M in (16, 64):
            case(M, 256, N, 2, True, False, torch.float32, False)
            n += 1
    case(64, 4096, 1024, 4, True, True, torch.bfloat16, True)
    n += 1
    for M in (4, 64):
        case(M, 14336, 256, 8, True, False, torch.bfloat16, True)
        n += 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    need(bm._plan(64, 14336, 256, sms)[1] > 1 and
         bm._plan(4, 4100, 128, sms)[1] > 1, "split-K cases do not split K")
    rows = []
    for name, (K, N) in GRANITE_SHAPES.items():
        for M in (4, 64):
            x, w, xs, ws, kw = case(M, K, N, 8, True, False, torch.bfloat16,
                                    True)
            n += 1
            ms = time_cold(lambda: bm.bramac_matmul(x, w, xs, ws, **kw))
            plain_ms = time_cold(
                lambda: bm.bramac_matmul_plain(x, w, xs, ws, **kw), iters=5)
            bound, by = _matmul_bound(M, K, N, K * N)
            if M > 16 and K % 8 == 0 and N % 8 == 0:
                lib_name = "torch._int_mm"
                lib_ms = time_cold(lambda: torch._int_mm(x, w))
            else:
                lib_name = "bf16 torch.matmul"
                xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
                lib_ms = time_cold(lambda: torch.matmul(xb, wb))
            rows.append(dict(shape=name, M=M, K=K, N=N, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                             library=lib_name, library_ms=lib_ms))
            print(f"  bramac_matmul {name} M={M} K={K} N={N}: {ms:.4f} ms "
                  f"(bound {bound:.4f} ms by {by}, plain {plain_ms:.4f} ms, "
                  f"{lib_name} {lib_ms:.4f} ms)")
    # what the digit passes cost: unembed again at 2 and 4 bits (1 and 2
    # digit passes) beside its 8-bit row (4 passes)
    K, N = GRANITE_SHAPES["unembed"]
    for M in (4, 64):
        by_digits = {}
        for bits in (2, 4):
            x, w, xs, ws, kw = case(M, K, N, bits, True, False,
                                    torch.bfloat16, True)
            n += 1
            by_digits[bits] = time_cold(
                lambda: bm.bramac_matmul(x, w, xs, ws, **kw))
        r8 = next(r for r in rows if r["shape"] == "unembed" and r["M"] == M)
        print(f"  bramac_matmul unembed M={M} by digit passes: 1 (2-bit) "
              f"{by_digits[2]:.4f} ms, 2 (4-bit) {by_digits[4]:.4f} ms, 4 "
              f"(8-bit) {r8['ms']:.4f} ms")
    spec_rows, n_spec = phase_matmul_spec(case)
    n += n_spec
    mc_rows, n_mc = phase_matmul_model(case, "minicpm3", MINICPM3_SHAPES)
    qw_rows, n_qw = phase_matmul_model(case, "qwen3-moe", QWEN3_SHAPES)
    rec_rows, n_rec = phase_matmul_recurrent(case)
    lv_rows, n_lv = phase_matmul_model(case, "llama-3.2-vision",
                                       LLAMA_VISION_SHAPES)
    mg_rows, n_mg = phase_matmul_model(case, "musicgen", MUSICGEN_SHAPES)
    print(f"phase 14a bramac_matmul: {n_lv + n_mg} cases bit-exact vs plain "
          f"(every llama-3.2-vision-11b linear at its prefill and decode "
          f"rows, the xattn K/V projection at M = 1600 and 6400 vision rows, "
          f"the 128256-column unembed; every musicgen-large linear)")
    n += n_mc + n_qw + n_rec + n_lv + n_mg
    print(f"phase 2 bramac_matmul: {n} cases bit-exact vs plain, max abs "
          f"err {worst:.3g} (bits 2/4/8, signed+unsigned, 4-bit packed, "
          f"f32+bf16 out, scalar and per-channel scales, ragged M/K/N at the "
          f"16/64-row, 128-byte and 128-column tile edges, split K, unaligned "
          f"views, granite-8b, minicpm3-4b, qwen3-moe-30b-a3b, xlstm-1.3b "
          f"and jamba-1.5-large-398b shapes)")
    main = next(r for r in rows if r["shape"] == "w_gate/w_up" and r["M"] == 4)
    report["bramac_matmul"] = dict(
        name="bramac_matmul", route="cuda",
        source="src/repro_torch/kernels/csrc/bramac_matmul.cu",
        replaces="src/repro/kernels/bramac_matmul.py:47", max_abs_err=worst,
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"],
        shapes=rows, spec_shapes=spec_rows, minicpm3_shapes=mc_rows,
        qwen3_moe_shapes=qw_rows, recurrent_shapes=rec_rows,
        llama_vision_shapes=lv_rows, musicgen_shapes=mg_rows)


# every minicpm3-4b linear at the rows its serve gives it: the seven MLA
# projections and the MLP at decode (M = 4 slots) and prefill (M = 64 = 4
# slots x 16-token chunks); w_uk / w_uv always run over the gathered
# (slots x max_seq) view, M = 4 x 256 = 1024
MINICPM3_SHAPES = {                 # name: (K, N, rows)
    "w_dq": (2560, 768, (4, 64)), "w_uq": (768, 3840, (4, 64)),
    "w_dkv": (2560, 256, (4, 64)), "w_kr": (2560, 32, (4, 64)),
    "w_uk/w_uv": (256, 2560, (1024,)), "wo": (2560, 2560, (4, 64)),
    "w_gate/w_up": (2560, 6400, (4, 64)), "w_down": (6400, 2560, (4, 64)),
    "unembed": (2560, 73448, (4, 64))}

# qwen3-moe-30b-a3b's attention linears and unembed at its serve's rows
# (phase 11c: 4 slots, 16-token chunks); its expert einsums are phase 11a's
QWEN3_SHAPES = {                    # name: (K, N, rows)
    "wq/wo": (2048, 2048, (4, 64)), "wk/wv": (2048, 256, (4, 64)),
    "unembed": (2048, 151936, (4, 64))}


# llama-3.2-vision-11b's linears at phase 14b's rows: 4 prompts of 64
# tokens prefill (M = 256) and decode (M = 4); its xattn layers project
# K/V over the 1600 vision tokens of each request (M = 1600, 6400 at 4);
# the unembed runs on the last row of each prompt at prefill (M = 4)
LLAMA_VISION_SHAPES = {             # name: (K, N, rows)
    "wq/wo": (4096, 4096, (4, 256)), "wk/wv": (4096, 1024, (4, 256)),
    "xattn wk/wv": (4096, 1024, (1600, 6400)),
    "w_gate/w_up": (4096, 14336, (4, 256)), "w_down": (14336, 4096, (4, 256)),
    "unembed": (4096, 128256, (4,))}

# musicgen-large's linears at phase 14c's serve rows (4 slots, 16-token
# chunks): MHA 2048 -> 32 x 64 for q, k, v and o, the 8192-wide FF, and
# the 2048-token unembed
MUSICGEN_SHAPES = {                 # name: (K, N, rows)
    "wq/wk/wv/wo": (2048, 2048, (4, 64)),
    "w_gate/w_up": (2048, 8192, (4, 64)), "w_down": (8192, 2048, (4, 64)),
    "unembed": (2048, 2048, (4, 64))}


def phase_matmul_model(case, label, shapes):
    """A model's linear shapes (`shapes`: name -> (K, N, rows)), 8-bit:
    bit-exact against the plain version, and timed beside their bound and
    bf16 `torch.matmul` on the same values.  minicpm3-4b's w_kr has N = 32,
    below one 128-column tile; its unembed's N = 73448 is ragged."""
    from repro_torch.kernels import bramac_matmul as bm
    rows, n = [], 0
    for name, (K, N, ms) in shapes.items():
        for M in ms:
            x, w, xs, ws, kw = case(M, K, N, 8, True, False, torch.bfloat16,
                                    True)
            n += 1
            ms_ = time_cold(lambda: bm.bramac_matmul(x, w, xs, ws, **kw))
            plain_ms = time_cold(
                lambda: bm.bramac_matmul_plain(x, w, xs, ws, **kw), iters=5)
            bound, by = _matmul_bound(M, K, N, K * N)
            xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
            lib_ms = time_cold(lambda: torch.matmul(xb, wb))
            rows.append(dict(shape=name, M=M, K=K, N=N, ms=ms_,
                             plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                             library="bf16 torch.matmul", library_ms=lib_ms))
            print(f"  bramac_matmul {label} {name} M={M} K={K} N={N}: "
                  f"{ms_:.4f} ms (bound {bound:.4f} ms by {by}, plain "
                  f"{plain_ms:.4f} ms, bf16 torch.matmul {lib_ms:.4f} ms)")
    return rows, n


# every quantized linear of xlstm-1.3b and jamba-1.5-large-398b (K, N,
# rows).  xlstm: the mLSTM's w_up, dense 4096 x 4096 q/k/v and w_down, the
# sLSTM's w_gates and ragged w_up 2048 -> 2 x 2730 and w_down 2730 -> 2048,
# and the unembed.  jamba (phase 12d): mamba w_in / w_out, the attention's
# wq/wo and wk/wv (64/8 heads of 128), the dense FF (also each expert's
# shapes) and the unembed.  Rows: M = 4 (4 slots, at decode and at the
# one-token admission chunks of a recurrent arch), M = 64 (a 64-row
# sequence), and for the FF M = 1: jamba's serve gives each of its 16
# experts C = round(4 x 2 / 16 x 1.25) = 1 row
XLSTM_SHAPES = {
    "mLSTM w_up": (2048, 8192, (4, 64)),
    "mLSTM wq/wk/wv": (4096, 4096, (4, 64)),
    "mLSTM w_down": (4096, 2048, (4, 64)),
    "sLSTM w_gates": (2048, 8192, (4, 64)),
    "sLSTM w_up": (2048, 5460, (4, 64)),
    "sLSTM w_down": (2730, 2048, (4, 64)),
    "unembed": (2048, 50304, (4, 64))}
JAMBA_SHAPES = {
    "mamba w_in": (8192, 32768, (4, 64)),
    "mamba w_out": (16384, 8192, (4, 64)),
    "wq/wo": (8192, 8192, (4, 64)), "wk/wv": (8192, 1024, (4, 64)),
    "dense FF / expert w_gate/w_up": (8192, 24576, (1, 4, 64)),
    "dense FF / expert w_down": (24576, 8192, (1, 4, 64)),
    "unembed": (8192, 65536, (4, 64))}


def phase_matmul_recurrent(case):
    """12a: every shape above at 8 bits, and the sLSTM's ragged shapes at 4
    bits, pair-packed (K = 2730 packs to 1365 rows; N = 5460 rows are not
    16-byte multiples): bit-exact against the plain version, timed beside
    their bound and bf16 `torch.matmul`."""
    from repro_torch.kernels import bramac_matmul as bm
    rows, n = [], 0
    for label, shapes in (("xlstm-1.3b", XLSTM_SHAPES),
                          ("jamba-1.5-large-398b", JAMBA_SHAPES)):
        r, k = phase_matmul_model(case, label, shapes)
        rows += [dict(x, model=label, bits=8) for x in r]
        n += k
    for name in ("sLSTM w_up", "sLSTM w_down"):
        K, N, _ = XLSTM_SHAPES[name]
        for M in (4, 64):
            x, w, xs, ws, kw = case(M, K, N, 4, True, True, torch.bfloat16,
                                    True)
            n += 1
            ms = time_cold(lambda: bm.bramac_matmul(x, w, xs, ws, **kw))
            plain_ms = time_cold(
                lambda: bm.bramac_matmul_plain(x, w, xs, ws, **kw), iters=5)
            bound, by = _matmul_bound(M, K, N, K * N // 2)
            xb = x.to(torch.bfloat16)
            wb = torch.randn((K, N), device="cuda").to(torch.bfloat16)
            lib_ms = time_cold(lambda: torch.matmul(xb, wb))
            rows.append(dict(model="xlstm-1.3b", shape=name, M=M, K=K, N=N,
                             bits=4, packed_rows=K // 2, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                             library="bf16 torch.matmul", library_ms=lib_ms))
            print(f"  bramac_matmul xlstm-1.3b {name} M={M} K={K} N={N} "
                  f"4-bit packed ({K // 2} rows): {ms:.4f} ms (bound "
                  f"{bound:.4f} ms by {by}, plain {plain_ms:.4f} ms, bf16 "
                  f"torch.matmul {lib_ms:.4f} ms)")
    print(f"phase 12a bramac_matmul: {n} cases bit-exact vs plain (every "
          f"xlstm-1.3b and jamba-1.5-large-398b linear at M = 4 and 64, "
          f"jamba's FF also at M = 1 (one row per expert), 8-bit; the "
          f"sLSTM's w_up N=5460 and w_down K=2730 at 4 bits pair-packed)")
    return rows, n


def _matmul_bound(M, K, N, w_bytes):
    """-> (ms, by): the larger of the bytes (x, weights as stored, both
    scales, the bf16 output, each once) over HBM and the 2·M·N·K
    operations of one int8 product, which is exact at every supported
    width, over the int8 peak."""
    nbytes = M * K + w_bytes + 4 * (M + N) + 2 * M * N
    ops = 2 * M * N * K
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / INT8_OPS_PER_S \
        else "operations"
    return max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3, by


def phase_matmul_spec(case):
    """The speculative paths' matmul shapes: the verify window (M = 4 slots
    x 5 rows = 20) at 8 bits on every granite linear, and the 2-bit draft
    model at decode (M = 4) on w_gate and unembed, whose weights are stored
    pair-packed 4 to a byte and unpacked to int8 at every call
    (`QuantizedTensor.unpacked_values` in `serve_dense`): the kernel alone,
    the unpack alone, and both.  Yardstick: bf16 torch.matmul at the same
    shape.  Also the unpack of every granite shape at 2 bits, summed over
    one 36-layer draft forward."""
    from repro_torch.core import quant
    from repro_torch.kernels import bramac_matmul as bm
    rows, n = [], 0

    def yardstick(x, w):
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        return time_cold(lambda: torch.matmul(xb, wb))

    for name, (K, N) in GRANITE_SHAPES.items():
        x, w, xs, ws, kw = case(20, K, N, 8, True, False, torch.bfloat16,
                                True)
        n += 1
        ms = time_cold(lambda: bm.bramac_matmul(x, w, xs, ws, **kw))
        plain_ms = time_cold(
            lambda: bm.bramac_matmul_plain(x, w, xs, ws, **kw), iters=5)
        bound, by = _matmul_bound(20, K, N, K * N)
        lib_ms = yardstick(x, w)
        rows.append(dict(shape=name, M=20, K=K, N=N, bits=8, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                         library="bf16 torch.matmul", library_ms=lib_ms))
        print(f"  bramac_matmul verify {name} M=20 K={K} N={N} 8-bit: "
              f"{ms:.4f} ms (bound {bound:.4f} ms by {by}, plain "
              f"{plain_ms:.4f} ms, bf16 torch.matmul {lib_ms:.4f} ms)")
    unpack_ms = {}
    for name, (K, N) in GRANITE_SHAPES.items():
        x, w, xs, ws, kw = case(4, K, N, 2, True, False, torch.bfloat16,
                                True)
        n += 1
        packed = quant.pack_bits_axis(w, 2, -2)
        need(torch.equal(quant.unpack_axis(packed, 2, -2), w),
             f"2-bit pack/unpack round trip at {name}")
        unpack_ms[name] = time_cold(lambda: quant.unpack_axis(packed, 2, -2))
        if name not in ("w_gate/w_up", "unembed"):
            continue
        ms = time_cold(lambda: bm.bramac_matmul(x, w, xs, ws, **kw))
        both_ms = time_cold(lambda: bm.bramac_matmul(
            x, quant.unpack_axis(packed, 2, -2), xs, ws, **kw))
        plain_ms = time_cold(
            lambda: bm.bramac_matmul_plain(x, w, xs, ws, **kw), iters=5)
        bound, by = _matmul_bound(4, K, N, K * N)
        bound_p, by_p = _matmul_bound(4, K, N, K * N // 4)
        lib_ms = yardstick(x, w)
        rows.append(dict(shape=name, M=4, K=K, N=N, bits=2, ms=ms,
                         unpack_ms=unpack_ms[name], with_unpack_ms=both_ms,
                         plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                         packed_bound_ms=bound_p, library="bf16 torch.matmul",
                         library_ms=lib_ms))
        print(f"  bramac_matmul draft {name} M=4 K={K} N={N} 2-bit: kernel "
              f"{ms:.4f} ms (bound {bound:.4f} ms by {by} on int8 weights), "
              f"unpack {unpack_ms[name]:.4f} ms, unpack + kernel "
              f"{both_ms:.4f} ms (bound {bound_p:.4f} ms by {by_p} on the "
              f"packed weights), plain {plain_ms:.4f} ms, bf16 torch.matmul "
              f"{lib_ms:.4f} ms")
    per_layer = {"wq/wo": 2, "wk/wv": 2, "w_gate/w_up": 2, "w_down": 1}
    fwd_ms = 36 * sum(per_layer[k] * unpack_ms[k] for k in per_layer) \
        + unpack_ms["unembed"]
    print(f"  2-bit unpack per 36-layer draft forward (252 layer weights + "
          f"unembed, summed from the per-shape times "
          f"{ {k: round(v, 4) for k, v in unpack_ms.items()} }): "
          f"{fwd_ms:.1f} ms")
    rows.append(dict(shape="unpack per 36-layer draft forward",
                     unpack_ms=fwd_ms, per_shape_ms=unpack_ms))
    return rows, n


def matmul_build(ptxas: str | None) -> str:
    """What the accumulate kernel was built to: registers and local (spill)
    memory per thread from the loaded library, for all 24 instantiations;
    spill stores from this run's ptxas report when it compiled now."""
    import ctypes
    from repro_torch.kernels import build
    lib = build.library("bramac_matmul")
    info = (ctypes.c_int * 4)()
    parts = []
    for bm_ in (16, 64):
        regs, local = [], []
        for bits in (2, 4, 8):
            for sgn in (0, 1):
                for packed in (0, 1):
                    build.check(lib.bramac_matmul_info(
                        bm_, bits, sgn, packed, ctypes.addressof(info)),
                        "bramac_matmul_info")
                    regs.append(info[0])
                    local.append(info[1])
        build.check(lib.bramac_matmul_info(bm_, 8, 1, 0,
                                           ctypes.addressof(info)),
                    "bramac_matmul_info")
        parts.append(f"BM={bm_}: {info[3]} threads, {info[2]} B dynamic "
                     f"shared memory, {min(regs)}-{max(regs)} registers/thread "
                     f"({info[0]} at 8-bit signed), {max(local)} B local "
                     f"memory")
    spills = "not compiled in this run"
    if ptxas:
        found = [int(v) for chunk in ptxas.split("Compiling entry function")
                 if "bramac_accumulate" in chunk
                 for v in re.findall(r"(\d+) bytes spill stores", chunk)]
        spills = f"{sum(found)} bytes spill stores over {len(found)} entries"
    return "; ".join(parts) + f"; ptxas: {spills}"


def paged_fp_build() -> str:
    """Registers and local (spill) memory per thread of the fp decode
    kernel's eight instantiations (q f32/bf16 x KV f32/bf16 x g <= 4 /
    g <= 16)."""
    import ctypes
    from repro_torch.kernels import build
    lib = build.library("paged_attention")
    info = (ctypes.c_int * 4)()
    parts = []
    for g_large in (0, 1):
        for q_bf16 in (0, 1):
            for kv_bf16 in (0, 1):
                build.check(lib.paged_decode_info(q_bf16, kv_bf16, g_large,
                                                  ctypes.addressof(info)),
                            "paged_decode_info")
                parts.append(f"g<={16 if g_large else 4} q "
                             f"{'bf16' if q_bf16 else 'f32'} KV "
                             f"{'bf16' if kv_bf16 else 'f32'}: {info[0]} "
                             f"registers, {info[1]} B local")
    return (f"{info[3]} threads, dynamic shared memory up to {info[2]} B; "
            + "; ".join(parts))


def paged_q_build() -> str:
    """Registers and local (spill) memory per thread of the int8 decode
    kernel's four instantiations (f32/bf16 out x g <= 4 / g <= 16)."""
    import ctypes
    from repro_torch.kernels import build
    lib = build.library("paged_attention")
    info = (ctypes.c_int * 4)()
    parts = []
    for g_large in (0, 1):
        for bf16 in (0, 1):
            build.check(lib.paged_decode_q_info(bf16, g_large,
                                                ctypes.addressof(info)),
                        "paged_decode_q_info")
            parts.append(f"g<={16 if g_large else 4} "
                         f"{'bf16' if bf16 else 'f32'}: {info[0]} registers, "
                         f"{info[1]} B local")
    return (f"{info[3]} threads, dynamic shared memory up to {info[2]} B; "
            + "; ".join(parts))


def mac2_build(ptxas: str | None) -> str:
    """What the dummy-array kernel was built to: registers and local
    (spill) memory per thread for its 12 instantiations (bits x signed x
    16-byte or byte loads), and spill stores from this run's ptxas report
    when it compiled now."""
    import ctypes
    from repro_torch.kernels import build
    lib = build.library("mac2_kernel")
    info = (ctypes.c_int * 4)()
    parts = []
    for vec in (1, 0):
        regs, local = [], []
        for bits in (2, 4, 8):
            for sgn in (0, 1):
                build.check(lib.mac2_mvm_info(bits, sgn, vec,
                                              ctypes.addressof(info)),
                            "mac2_mvm_info")
                regs.append(info[0])
                local.append(info[1])
        parts.append(f"{'16-byte' if vec else 'byte'} loads: "
                     f"{min(regs)}-{max(regs)} registers/thread ({regs[-1]} "
                     f"at 8-bit signed), {max(local)} B local memory")
    spills = "not compiled in this run"
    if ptxas:
        found = [int(v) for chunk in ptxas.split("Compiling entry function")
                 if "mac2_mvm" in chunk
                 for v in re.findall(r"(\d+) bytes spill stores", chunk)]
        spills = f"{sum(found)} bytes spill stores over {len(found)} entries"
    return (f"{info[3]} threads, up to {info[2]} B dynamic shared memory; "
            + "; ".join(parts) + f"; ptxas: {spills}")


# ---------------------------------------------------------------------------
# phases 3-4: paged decode kernels
# ---------------------------------------------------------------------------

B, H, HKV, HD, PS, MAXP = 4, 32, 8, 128, 16, 16
CASES = {                          # (lengths, n_pages): below / at / across
    "boundaries": ((15, 16, 17, 33), (1, 1, 2, 3)),   # page edges
    "free_slot": ((40, 1, 96, 20), (3, 0, 6, 2)),     # n_pages=0 -> zeros
    "owned_past_len": ((20, 33, 1, 64), (4, 5, 3, 6)),  # n_pages > ceil(L/ps)
    "serve": ((57, 104, 121, 136), (4, 7, 8, 9)),     # decode-time lengths
}


# the int8 kernel's cluster split at its edges: (lengths, n_pages, H, Hkv,
# max_pages, hd).  max_pages 256 splits a walk over 8 blocks of 32 pages,
# and lengths up to 4096 make all 8 active; H/Hkv = 16 and H = Hkv;
# max_pages 1024 at H/Hkv = 16 keeps the scores in the device scratch
# buffer.  "qwen3" is qwen3-moe-30b-a3b's decode read in phase 11c (32/4
# heads, hd 64) at its last step's lengths (prompts 105/83/70/45 + 7);
# "jamba" is jamba-1.5-large-398b's attention layer in phase 12d (64/8
# heads, hd 128) on the same traffic; "musicgen" is musicgen-large's MHA
# read in phase 14c (32/32 heads, hd 64, group size 1) on that traffic
Q_CASES = {
    "long": ((4096, 3000, 1500, 4000), (256, 188, 94, 256), H, HKV, 256, HD),
    "long_g16": ((4096, 2500, 1, 3333), (256, 160, 1, 209), 32, 2, 256, HD),
    "g1": ((57, 104, 121, 136), (4, 7, 8, 9), 8, 8, MAXP, HD),
    "scratch_g16": ((16384, 9000, 20, 12000), (1024, 563, 2, 750), 32, 2,
                    1024, HD),
    "qwen3": ((112, 90, 77, 52), (7, 6, 5, 4), 32, 4, MAXP, 64),
    "jamba": ((112, 90, 77, 52), (7, 6, 5, 4), 64, 8, MAXP, HD),
    "musicgen": ((112, 90, 77, 52), (7, 6, 5, 4), 32, 32, MAXP, 64),
}


# the fp kernel's cluster split and ring at the int8 cases' edges (random
# fp pools), and one case off the serve geometry: (lengths, n_pages, H,
# Hkv, max_pages, hd, page_size).  "hd100_ps12" has 12-row pages, so the
# ring's 32-row tiles end inside pages, and bf16 rows of 200 bytes, which
# the kernel copies element by element.  At hd 256 the f32 rows pass 512
# bytes, so the ring takes 16-row tiles (bf16: 32); "hd256_g16" is the
# largest plan the wrapper accepts (H/Hkv 16, 128 pages a block; its bf16
# run holds the most shared memory of any plan)
FP_CASES = {
    **{name: Q_CASES[name] + (PS,)
       for name in ("long", "long_g16", "g1", "qwen3", "jamba",
                    "musicgen")},
    "hd100_ps12": ((450, 13, 0, 200), (38, 2, 0, 40), 8, 2, 40, 100, 12),
    "hd256": CASES["serve"] + (H, HKV, MAXP, 256, PS),
    "hd256_g16": Q_CASES["scratch_g16"][:5] + (256, PS),
}


def _pool_case(gen, lengths, n_pages, maxp=MAXP, ps=PS):
    """Block tables over a pool of B*maxp pages (B = len(lengths)), and the
    (P, ps) mask of the rows the reference reads: the first
    min(n_pages, ceil(len/ps)) pages of each table, rows below the length.
    Everything else (pages no table lists, owned pages past the length,
    rows past the length in the last page) is to be poisoned by the
    caller."""
    B = len(lengths)
    P = B * maxp
    tables = torch.randperm(P, generator=gen, device="cuda")[:B * maxp] \
        .reshape(B, maxp).to(torch.int32)
    read = torch.zeros(P, ps, dtype=torch.bool, device="cuda")
    for b, (L, n) in enumerate(zip(lengths, n_pages)):
        for j in range(min(n, -(-L // ps))):
            read[tables[b, j].long(), :max(0, min(ps, L - j * ps))] = True
    return (tables, torch.tensor(n_pages, dtype=torch.int32, device="cuda"),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"), read)


def _live_rows(lengths, n_pages, ps=PS):
    """-> (rows, pages): the K/V rows the function needs (those below each
    length in the walked pages) and the table entries it walks."""
    walked = [min(n, -(-L // ps)) for L, n in zip(lengths, n_pages)]
    return (sum(min(L, w * ps) for L, w in zip(lengths, walked)),
            sum(walked))


def _sdpa_yardstick(pa, q, k, v, tables, npg, lens):
    """One torch.nn.functional.scaled_dot_product_attention call over the
    same live rows, as a yardstick: K and V gathered beforehand into
    contiguous (B, H, Lmax, hd) tensors with the GQA groups expanded, and a
    (B, 1, 1, Lmax) mask of the rows below each length, all built outside
    the timed call (so its time leaves out the gather).  Returns (ms, max
    abs difference from the plain version)."""
    B, H, hd = q.shape
    P, ps, Hkv = k.shape[:3]
    n_eff = torch.minimum(npg, (lens + ps - 1) // ps)
    lmax = int(n_eff.max()) * ps
    valid, tbl = pa._gather_valid(tables, npg, lens, ps, P)
    kv = [pa._view(pool, tbl)[:, :lmax].permute(0, 2, 1, 3)
          .repeat_interleave(H // Hkv, dim=1).contiguous() for pool in (k, v)]
    mask = valid[:, None, None, :lmax].contiguous()
    q4 = q[:, :, None, :].contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def call():
        return sdpa(q4, kv[0], kv[1], attn_mask=mask)
    want = pa.paged_decode_plain(q, k, v, tables, npg, lens)
    err = (call()[:, :, 0].float() - want.float()).abs().max().item()
    return time_cold(call), err


def phase_paged(gen, report):
    from repro_torch.kernels import paged_attention as pa
    worst = 0.0
    timed, rows = [], []

    def fp_case(cname, lengths, n_pages, dt, H, Hkv, maxp, hd, ps):
        # f32: fp32 reassociation (pages summed online vs one softmax), the
        # reference suite's own kernel-vs-oracle bound; bf16: the same
        # sums rounded once to bf16 (2^-8 relative on O(1) outputs)
        nonlocal worst
        atol = 2e-6 if dt == torch.float32 else 8e-3
        B = len(lengths)
        tables, npg, lens, read = _pool_case(gen, lengths, n_pages, maxp, ps)
        q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dt)
        k = torch.randn(B * maxp, ps, Hkv, hd, generator=gen,
                        device="cuda").to(dt)
        v = torch.randn(B * maxp, ps, Hkv, hd, generator=gen,
                        device="cuda").to(dt)
        got = pa.paged_decode(q, k, v, tables, npg, lens)
        again = pa.paged_decode(q, k, v, tables, npg, lens)
        want = pa.paged_decode_plain(q, k, v, tables, npg, lens)
        # every row the reference does not read is poisoned: the output
        # must not move
        ok = read[:, :, None, None]
        got_p = pa.paged_decode(q, torch.where(ok, k, 1e9),
                                torch.where(ok, v, 1e9), tables, npg, lens)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        worst = max(worst, err)
        need(err <= atol + atol * want.float().abs().max().item(),
             f"paged_decode {cname} {dt}: max err {err} > {atol}")
        need(torch.equal(got, again),
             f"paged_decode {cname} {dt}: two launches differ")
        need(torch.equal(got, got_p),
             f"paged_decode {cname} {dt}: poisoned pages changed output")
        if 0 in n_pages:
            need(bool((got[list(n_pages).index(0)] == 0).all()),
                 "paged_decode: a slot without pages must emit zeros")
        if cname in ("serve", "long", "qwen3", "jamba", "musicgen") and \
                dt == torch.bfloat16:
            live, walked = _live_rows(lengths, n_pages, ps)
            nbytes = 2 * live * Hkv * hd * 2 + 2 * (2 * B * H * hd) \
                + 4 * (walked + 2 * B)
            ops = 4 * live * H * hd
            bound = max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
            by = "bytes" if nbytes / HBM_BYTES_PER_S >= \
                ops / FP32_OPS_PER_S else "operations"
            ms = time_cold(lambda: pa.paged_decode(q, k, v, tables, npg,
                                                   lens))
            plain_ms = time_cold(lambda: pa.paged_decode_plain(
                q, k, v, tables, npg, lens))
            lib_ms, lib_err = _sdpa_yardstick(pa, q, k, v, tables, npg, lens)
            timed.append((cname, ms, plain_ms))
            rows.append(dict(case=cname, B=B, H=H, Hkv=Hkv, hd=hd,
                             max_pages=maxp,
                             lengths=lengths, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by, library_ms=lib_ms))
            print(f"  paged_decode {cname} bf16 B={B} H={H} Hkv={Hkv} "
                  f"max_pages={maxp} lengths={lengths}: {ms:.4f} ms (bound "
                  f"{bound:.5f} ms by {by}, plain {plain_ms:.4f} ms, sdpa "
                  f"yardstick {lib_ms:.4f} ms, max abs diff {lib_err:.3g})")

    n = 0
    for dt in (torch.float32, torch.bfloat16):
        for cname, (lengths, n_pages) in CASES.items():
            fp_case(cname, lengths, n_pages, dt, H, HKV, MAXP, HD, PS)
            n += 1
        for cname, case in FP_CASES.items():
            fp_case(cname, *case[:2], dt, *case[2:])
            n += 1
    need(all(ms < plain_ms for _, ms, plain_ms in timed),
         f"paged_decode slower than its plain version: {timed}")
    main = next(r for r in rows if r["case"] == "serve")
    report["paged_decode"] = dict(
        name="paged_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:79", max_abs_err=worst,
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"], shapes=rows)
    print(f"phase 3 paged_decode: {n} cases within tolerance (f32 atol "
          f"2e-6, bf16 8e-3), max abs err {worst:.3g}; two launches "
          f"bit-identical; poisoned unread pages and rows ignored; free slot "
          f"emits zeros; cluster split up to 8 blocks at max_pages 256, H/Hkv "
          f"16 and 1, 12-row pages, hd 100, and hd 256 (f32: 16-row ring "
          f"tiles) up to H/Hkv 16 at max_pages 1024; qwen3-moe-30b-a3b's "
          f"32/4 heads at hd 64; jamba-1.5-large-398b's 64/8 heads at hd "
          f"128; musicgen-large's 32/32 heads at hd 64")

    worst = 0.0
    timed, q_rows = [], []

    def q_case(cname, lengths, n_pages, dt, H, Hkv, maxp, hd=HD):
        nonlocal worst
        B = len(lengths)
        tables, npg, lens, read = _pool_case(gen, lengths, n_pages, maxp)
        P = B * maxp
        k = torch.randint(-127, 128, (P, PS, Hkv, hd), generator=gen,
                          device="cuda").to(torch.int8)
        v = torch.randint(-127, 128, (P, PS, Hkv, hd), generator=gen,
                          device="cuda").to(torch.int8)
        ks = torch.rand(P, PS, Hkv, generator=gen, device="cuda") * 0.02
        vs = torch.rand(P, PS, Hkv, generator=gen, device="cuda") * 0.02
        qq = torch.randint(-127, 128, (B, H, hd), generator=gen,
                           device="cuda").to(torch.int8)
        qs = torch.rand(B, H, generator=gen, device="cuda") * 0.02
        args = (qq, qs, k, ks, v, vs, tables, npg, lens)
        got = pa.paged_decode_q(*args, dt)
        want, pscale = pa._q_plain(*args, dt)
        # rows the reference does not read, poisoned: no change
        ok = read[:, :, None]
        got_p = pa.paged_decode_q(
            qq, qs, torch.where(ok[..., None], k, 127),
            torch.where(ok, ks, 1e3), torch.where(ok[..., None], v, 127),
            torch.where(ok, vs, 1e3), tables, npg, lens, dt)
        torch.cuda.synchronize()
        need(torch.equal(got, got_p),
             f"paged_decode_q {cname} {dt}: poisoned rows changed output")
        # the normalizer is summed in another order; a last-bit change
        # can move a requantized probability across a rounding edge,
        # which changes an output by at most 127*pscale per flip: allow
        # two flips, plus one bf16 rounding of the output
        tol = 2 * 127 * pscale[..., None] + 1e-6
        if dt == torch.bfloat16:
            tol = tol + want.float().abs() * 2 ** -7
        diff = (got.float() - want.float()).abs()
        worst = max(worst, diff.max().item())
        need(bool((diff <= tol).all()),
             f"paged_decode_q {cname} {dt}: max err {diff.max().item()}")
        if cname in ("serve", "long", "qwen3", "jamba", "musicgen") and \
                dt == torch.bfloat16:
            rows, walked = _live_rows(lengths, n_pages)
            nbytes = 2 * rows * Hkv * (hd + 4) + B * H * (hd + 4) \
                + 2 * B * H * hd + 4 * (walked + 2 * B)
            ops = 4 * rows * H * hd
            bound = max(nbytes / HBM_BYTES_PER_S,
                        ops / INT8_OPS_PER_S) * 1e3
            by = "bytes" if nbytes / HBM_BYTES_PER_S >= \
                ops / INT8_OPS_PER_S else "operations"
            ms = time_cold(lambda: pa.paged_decode_q(*args, dt))
            plain_ms = time_cold(lambda: pa.paged_decode_q_plain(*args, dt))
            timed.append((cname, ms, plain_ms))
            q_rows.append(dict(case=cname, B=B, H=H, Hkv=Hkv, hd=hd,
                               max_pages=maxp, lengths=lengths, ms=ms,
                               plain_ms=plain_ms, bound_ms=bound,
                               bound_by=by))
            if cname == "serve":
                report["paged_decode_q"] = dict(
                    name="paged_decode_q", route="cuda",
                    source="src/repro_torch/kernels/csrc/paged_attention.cu",
                    replaces="src/repro/kernels/paged_attention.py:111",
                    ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                    library_ms=None)
            print(f"  paged_decode_q {cname} bf16 B={B} H={H} Hkv={Hkv} "
                  f"max_pages={maxp} lengths={lengths}: {ms:.4f} ms (bound "
                  f"{bound:.5f} ms by {by}, plain {plain_ms:.4f} ms)")

    n = 0
    for dt in (torch.float32, torch.bfloat16):
        for cname, (lengths, n_pages) in CASES.items():
            q_case(cname, lengths, n_pages, dt, H, HKV, MAXP)
            n += 1
        for cname, (lengths, n_pages, H_, Hkv_, maxp, hd) in \
                Q_CASES.items():
            q_case(cname, lengths, n_pages, dt, H_, Hkv_, maxp, hd)
            n += 1
    need(all(ms < plain_ms for _, ms, plain_ms in timed),
         f"paged_decode_q slower than its plain version: {timed}")
    report["paged_decode_q"].update(max_abs_err=worst, shapes=q_rows)
    print(f"phase 4 paged_decode_q: {n} cases within tolerance (<= 2 "
          f"requantization flips), max abs err {worst:.3g}; poisoned unread "
          f"pages and rows ignored; cluster split up to 8 blocks at "
          f"max_pages 256 and 1024 (scratch), H/Hkv 16 and 1; "
          f"qwen3-moe-30b-a3b's 32/4 heads at hd 64; "
          f"jamba-1.5-large-398b's 64/8 heads at hd 128; musicgen-large's "
          f"32/32 heads at hd 64")


# ---------------------------------------------------------------------------
# phase 7: the dummy-array MAC2 kernel and the paper path
# ---------------------------------------------------------------------------

def _read_as(x, bits, signed):
    """x as the dummy array reads it: its bits-bit view, two's complement
    when signed."""
    u = x.to(torch.int32) & ((1 << bits) - 1)
    return torch.where(u >= 1 << (bits - 1), u - (1 << bits), u) if signed \
        else u


def _baseline_rows() -> dict:
    with open(os.path.join(ROOT, "benchmarks", "baseline.json")) as f:
        records = json.load(f)["records"]
    return {r["name"]: r["derived"] for r in records if r["deterministic"]
            and r["name"].split("_")[0] in
            ("table2", "fig7", "fig9", "fig10", "fig11", "fig13")}


def phase_mac2(gen, report):
    from repro_torch.core import gemv_model as gm
    from repro_torch.kernels import mac2_kernel as mk
    from repro_torch.kernels import ref
    from repro_torch.launch import paper
    kern, plain = mk.mac2_mvm_kernel, mk.mac2_mvm_kernel_plain
    worst, n = 0, 0

    def case(w, x, bits, signed, what):
        nonlocal worst, n
        got = kern(w, x, bits=bits, signed=signed)
        want_p = plain(w, x, bits=bits, signed=signed)
        want = ref.mac2_mvm_ref(w, _read_as(x, bits, signed))
        torch.cuda.synchronize()
        worst = max(worst, int((got.long() - want.long()).abs().max()),
                    int((want_p.long() - want.long()).abs().max()))
        need(torch.equal(got, want_p) and torch.equal(got, want),
             f"mac2_mvm_kernel != plain / w @ x at {what} R,C={tuple(w.shape)} "
             f"bits={bits} signed={signed}")
        n += 1

    t0 = time.perf_counter()
    # ragged shapes; inputs in the bits range, and over the whole int8
    # range (outside the bits range; unsigned 8-bit values >= 128 stored as
    # negative int8)
    for bits in (2, 4, 8):
        for signed in (True, False):
            for R in (1, 7, 129, 1000):
                for C in (2, 6, 482):
                    w = rand_q(gen, bits, (R, C))
                    case(w, rand_q(gen, bits, (C,), signed), bits, signed,
                         "in-range x")
                    case(w, rand_q(gen, 8, (C,)), bits, signed, "int8 x")
    # the tensor-core kernel's edges: rows around its 16-row MMA tiles, K
    # split into many ranges, and operands whose storage starts 1 byte off
    # 16 (byte loads)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    need(mk._plan(64, 14336, sms)[1] >= 4,
         "the R=64, C=14336 case does not split K 4 ways")
    for bits in (2, 4, 8):
        for signed in (True, False):
            for R in (15, 16, 17):
                case(rand_q(gen, bits, (R, 4096)),
                     rand_q(gen, bits, (4096,), signed), bits, signed,
                     "row tile edge")
            for R in (64, 4096):
                case(rand_q(gen, bits, (R, 14336)),
                     rand_q(gen, bits, (14336,), signed), bits, signed,
                     "split K")
            for R, C in ((17, 4096), (64, 482)):
                w = _offset_view(rand_q(gen, bits, (R, C)), 1)
                x = rand_q(gen, bits, (C,), signed)
                need(w.data_ptr() % 16 == 1, "offset view is not off 16")
                case(w, x, bits, signed, "w at storage offset 1")
                case(w, _offset_view(x, 1), bits, signed,
                     "w and x at storage offset 1")
    # the paper path's shapes (Fig 11)
    for bits in (2, 4, 8):
        for R in gm.ROW_SIZES:
            for C in gm.COL_SIZES:
                case(rand_q(gen, bits, (R, C)), rand_q(gen, bits, (C,)), bits,
                     True, "Fig 11")
    odd = rand_q(gen, 8, (4, 5))
    try:
        kern(odd, odd[0], bits=8)
        need(False, "mac2_mvm_kernel took an odd number of columns")
    except ValueError:
        pass
    print(f"phase 7 mac2 check: {n} cases bit-exact vs plain and w @ x, max "
          f"abs err {worst} (bits 2/4/8, signed+unsigned, ragged R x C, x in "
          f"and out of the bits range, R 15/16/17 at C=4096, C=14336 split "
          f"K, storage offset 1, the 105 Fig 11 shapes); odd C raises; "
          f"{time.perf_counter() - t0:.1f} s")

    # the paper path, through the launcher's own functions, on the card
    counters = {**_counters(), "mac2_mvm_kernel": kern}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = paper.run(torch.device("cuda"), seed=0)
    got = {k: fn.launches for k, fn in counters.items()}
    need(out["gemvs"] == 105 and got["mac2_mvm_kernel"] == 105,
         f"paper path: {out['gemvs']} GEMVs, {got['mac2_mvm_kernel']} "
         f"mac2_mvm_kernel launches (want 105 each)")
    need(all(v == 0 for k, v in got.items() if k != "mac2_mvm_kernel"),
         f"paper path launched other kernels: {got}")
    need(out["max_abs_err"] == 0, "paper path: a Fig 11 GEMV differed")
    base = _baseline_rows()
    need(len(base) == 23, f"baseline.json has {len(base)} paper rows, not 23")
    diff = {k: (out["derived"].get(k), v) for k, v in base.items()
            if out["derived"].get(k) != v}
    need(not diff and out["derived"].keys() == base.keys(),
         f"paper rows differ from benchmarks/baseline.json: {diff}")
    print(f"phase 7 paper path: {len(base)} table2/fig rows equal "
          f"benchmarks/baseline.json; 105 Fig 11 GEMVs bit-exact; launches "
          f"{got}; {time.perf_counter() - t0:.1f} s")
    report["mac2_mvm_kernel"] = dict(
        name="mac2_mvm_kernel", route="cuda",
        source="src/repro_torch/kernels/csrc/mac2_kernel.cu",
        replaces="src/repro/kernels/mac2_kernel.py:35",
        launches=got["mac2_mvm_kernel"])

    # full width: every granite-8b linear as a GEMV (R = out, C = in)
    rows = []
    for name, (K, N) in GRANITE_SHAPES.items():
        R, C = N, K
        lib_name, lib_ms = None, None
        for bits in (2, 4, 8):
            w, x = rand_q(gen, bits, (R, C)), rand_q(gen, bits, (C,))
            case(w, x, bits, True, f"granite {name}")
            ms = time_cold(lambda: kern(w, x, bits=bits))
            plain_ms = time_cold(lambda: plain(w, x, bits=bits), iters=5)
            nbytes = R * C + C + 4 * R
            ops = 2 * R * C
            bound = max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
            by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / INT8_OPS_PER_S \
                else "operations"
            if lib_ms is None:
                lib_name, lib_ms = _gemv_library_ms(w, x)
            rows.append(dict(shape=name, R=R, C=C, bits=bits, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                             library=lib_name, library_ms=lib_ms))
            print(f"  mac2_mvm_kernel {name} R={R} C={C} bits={bits}: "
                  f"{ms:.4f} ms (bound {bound:.4f} ms by {by}, plain "
                  f"{plain_ms:.4f} ms, {lib_name} {lib_ms:.4f} ms)")
            del w, x
        torch.cuda.empty_cache()
    main = next(r for r in rows
                if r["shape"] == "w_gate/w_up" and r["bits"] == 8)
    report["mac2_mvm_kernel"].update(
        max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"], shapes=rows)
    print(f"phase 7 mac2 full width: {len(rows)} granite-8b GEMVs timed; "
          f"{n} cases bit-exact in all, max abs err {worst}")


def _gemv_library_ms(w, x):
    """One PyTorch call as a yardstick: torch._int_mm of x repeated to 32
    rows against w.T (the same int8 weights, read once); if its layout
    rules refuse the shape, f32 torch.mv over copies cast beforehand."""
    xr = x[None].repeat(32, 1).contiguous()
    try:
        torch._int_mm(xr, w.T)
        torch.cuda.synchronize()
    except RuntimeError:
        wf, xf = w.float(), x.float()
        return "f32 torch.mv", time_cold(lambda: torch.mv(wf, xf))
    return "torch._int_mm", time_cold(lambda: torch._int_mm(xr, w.T))


# ---------------------------------------------------------------------------
# phase 5: granite-8b at full size through the Engine
# ---------------------------------------------------------------------------

def _counters():
    from repro_torch.kernels import bramac_matmul as bm
    from repro_torch.kernels import paged_attention as pa
    return {"bramac_matmul": bm.bramac_matmul,
            "paged_decode": pa.paged_decode,
            "paged_decode_q": pa.paged_decode_q}


def _phase5_prompts(vocab):
    """Phase 5's traffic: 8 random prompts of 17-120 tokens (seed 0)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=int(n))
            for n in rng.integers(17, 121, size=8)]


def serve(cfg, params, prompts, new_tokens, *, decode_kernel=True,
          num_slots=4, max_seq=256, top2=None, routes=None, **kw):
    """Serve `prompts` on a fresh Engine and return the run's readings.
    `top2` (a dict) collects, per (request uid, position), the top two
    tokens and their logit gap of every logits row the decode ticks
    computed from the request's own emitted context (`_log_top2`);
    `routes` (a list) collects every decode tick's router probabilities
    (`_log_routes`)."""
    from repro_torch.runtime.serve import Engine
    kw.setdefault("prefix_cache", False)
    with Engine(cfg, params, num_slots=num_slots, max_seq=max_seq,
                decode_kernel=decode_kernel, device="cuda", **kw) as eng:
        reqs = [eng.submit(p, new_tokens) for p in prompts]
        restore = [_log_top2(eng, top2)] if top2 is not None else []
        if routes is not None:
            restore.append(_log_routes(eng, routes))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            results = eng.run()
        finally:
            for undo in restore:
                undo()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = eng.n_ticks * eng.decode_steps
        forwards = steps + eng.n_admit_calls
        streams = [list(r.out_tokens) for r in reqs]
        done = sum(r.done for r in reqs)
        ttft = [r.ttft for r in results if r.ttft is not None]
        spec = eng.spec_stats()
        ticks, admits = eng.n_ticks, eng.n_admit_calls
        reasons = [r.result.finish_reason for r in reqs]
        disagg = eng.disagg_stats()
        checks, i7 = eng.n_invariant_checks, eng.n_transfer_checks
        drained = eng.kv_layout != "paged" or (
            eng.pages_in_use == 0 and eng.sched.pool.pages_in_use == 0)
        kernel = eng.decode_kernel
        chunk, prefix_on = eng.prefill_chunk, eng.prefix is not None
    return dict(streams=streams, done=done, wall=wall, steps=steps,
                forwards=forwards, ttft=ttft, spec=spec, ticks=ticks,
                admits=admits, reasons=reasons, disagg=disagg, checks=checks,
                transfer_checks=i7, drained=drained, decode_kernel=kernel,
                prefill_chunk=chunk, prefix_on=prefix_on,
                tokens=sum(len(s) for s in streams))


def _log_top2(eng, out):
    """Wrap `eng`'s decode tick so that every logits row whose context is
    the request's emitted stream lands in `out[(uid, position)]` as (top
    token, runner-up, logit gap): each active slot's row of a plain tick,
    and the emitted rows (accepted drafts and the correction) of a verify
    window.  Returns the function that restores the sampling hooks."""
    from repro_torch.runtime import sampling as smp
    seen = []
    plain = (smp.sample, smp.spec_verify)
    tick = eng.decode.tick

    def sample(logits, *a, **k):
        seen.append(logits)
        return plain[0](logits, *a, **k)

    def verify(logits, *a, **k):
        seen.append(logits)
        return plain[1](logits, *a, **k)

    def logged_tick(params, state, caches):
        pos = state.pos.cpu().tolist()
        uids = [r.uid if r is not None else None for r in eng.slot_req]
        seen.clear()
        state, caches, toks, emitted = tick(params, state, caches)
        lg = seen[0]                              # decode_steps 1
        if lg.ndim == 2:
            lg, em = lg[:, None], emitted[0][:, None]
        else:
            em = emitted[0]
        v, i = torch.topk(lg.float(), 2, dim=-1)
        v, i, em = v.cpu(), i.cpu(), em.cpu()
        for s, uid in enumerate(uids):
            for j in range(lg.shape[1]):
                if uid is not None and em[s, j]:
                    out[(uid, pos[s] + j)] = (int(i[s, j, 0]), int(i[s, j, 1]),
                                              float(v[s, j, 0] - v[s, j, 1]))
        return state, caches, toks, emitted

    smp.sample, smp.spec_verify = sample, verify
    eng.decode.tick = logged_tick

    def restore():
        smp.sample, smp.spec_verify = plain
    return restore


def _log_routes(eng, out):
    """Wrap `models.moe.route` and `eng`'s decode tick so that every decode
    tick appends (request uid per slot, position per slot, [each MoE
    layer's router probabilities, (slots, E), on the host]) to `out`.
    Returns the function that restores `route`."""
    from repro_torch.models import moe as moe_mod
    plain, tick = moe_mod.route, eng.decode.tick
    calls = []

    def route(p, xf, cfg, capacity_factor):
        r = plain(p, xf, cfg, capacity_factor)
        calls.append(r.probs)
        return r

    def logged_tick(params, state, caches):
        pos = state.pos.cpu().tolist()
        uids = [r.uid if r is not None else None for r in eng.slot_req]
        calls.clear()
        res = tick(params, state, caches)
        out.append((uids, pos, [c.cpu() for c in calls]))
        return res

    moe_mod.route = route
    eng.decode.tick = logged_tick
    return lambda: setattr(moe_mod, "route", plain)


# Two runs whose activations differ in last bits (and in the 8-bit
# roundings those move) see router log-probabilities that differ by some
# d at a row; its top-k expert set can then differ only where the k-th
# and (k+1)-th log-probabilities lie within 2d in both runs.  Held: d
# below ROUTE_MOVE_EPS, a tenth of the router logits' unit spread, at
# every compared row
ROUTE_MOVE_EPS = 0.1
# the same at f32 weights, where nothing is requantized: the routes differ
# by f32 reassociation only
F32_ROUTE_EPS = 1e-4


def expert_switches(prompts, a, b, top_a, top_b, ra, rb, k, what="11d"):
    """Runs a and b of one schedule: streams, `_log_top2` rows and
    `_log_routes` ticks.  Each request's rows are compared tick by tick up
    to the tick that emits its first differing token (whose input is
    still the same) or its first expert switch: a MoE layer whose top-k
    set differs between the runs.  Every compared row's router
    log-probabilities must agree within ROUTE_MOVE_EPS.  A request whose
    streams part must have a switch in its own row at or before that
    tick, or part by a swap of its top two tokens (`same_or_near_tie`).
    Returns {"d_max": the largest log-probability move, "rows",
    "switches": each switch's readings, "partings": how each request
    parted}."""
    last = {}                     # uid -> position of its parting tick
    for r, (x, y) in enumerate(zip(a, b)):
        if x != y:
            j = next(i for i in range(min(len(x), len(y))) if x[i] != y[i])
            need(j > 0, f"request {r} differs at its first token")
            last[r] = len(prompts[r]) + j - 1
    switch, seen, d_max, rows = {}, set(), 0.0, 0
    for t, ((ua, pa, ca), (ub, pb, cb)) in enumerate(zip(ra, rb)):
        if (ua, pa) != (ub, pb):
            break                 # schedules part (a stream stopped)
        for s, uid in enumerate(ua):
            if uid is None or uid in switch or pa[s] > last.get(uid, 1 << 30):
                continue
            if pa[s] == last.get(uid):
                seen.add(uid)
            for layer, (x, y) in enumerate(zip(ca, cb)):
                moved = float((torch.log(x[s]) - torch.log(y[s])).abs().max())
                d_max, rows = max(d_max, moved), rows + 1
                need(moved < ROUTE_MOVE_EPS,
                     f"request {uid} tick {t} layer {layer}: router "
                     f"log-probabilities moved {moved} between the runs "
                     f"(limit {ROUTE_MOVE_EPS})")
                vx, ix = torch.sort(x[s], descending=True, stable=True)
                vy, iy = torch.sort(y[s], descending=True, stable=True)
                sx, sy = set(ix[:k].tolist()), set(iy[:k].tolist())
                if sx == sy:
                    continue
                gaps = [float(torch.log(v[k - 1] / v[k])) for v in (vx, vy)]
                switch[uid] = (
                    pa[s], f"request {uid}: expert switch at position "
                    f"{pa[s]} layer {layer} ({sorted(sx - sy)} -> "
                    f"{sorted(sy - sx)}, k-th/(k+1)-th log gaps "
                    f"{gaps[0]:.3g} / {gaps[1]:.3g}, log-probabilities moved "
                    f"up to {moved:.3g})")
                break
    need(set(last) <= seen, f"parting ticks not logged: {set(last) - seen}")
    partings = []
    for r, pos in sorted(last.items()):
        if r in switch:
            partings.append(f"request {r} parts at position {pos}, after "
                            f"its switch at {switch[r][0]}")
        else:
            only = [[x if i == r else [] for i, x in enumerate(run)]
                    for run in (a, b)]
            partings += same_or_near_tie(prompts, *only, top_a, top_b,
                                         f"phase {what} request {r}")
    return dict(d_max=d_max, rows=rows, partings=partings,
                switches=[w for _, (_, w) in sorted(switch.items())])


def same_or_near_tie(prompts, a, b, top_a, top_b, what):
    """Streams `a` and `b` (request uid = index) must be equal, except that
    a request may leave the other run's stream where both runs rank the
    same two tokens first and differ only in their order: a near tie of
    the top two logits, which programs of other shapes (a verify window
    against a decode step) resolve differently at f32.  After such a swap
    the contexts differ and nothing more is compared.  Returns the swaps
    found, with both runs' gaps."""
    swaps = []
    for r, (x, y) in enumerate(zip(a, b)):
        if x == y:
            continue
        j = next(k for k in range(min(len(x), len(y))) if x[k] != y[k])
        key = (r, len(prompts[r]) + j - 1)
        need(j > 0 and key in top_a and key in top_b,
             f"{what}: request {r} differs at token {j} with no logged row")
        need(top_a[key][:2] == (x[j], y[j]) and
             top_b[key][:2] == (y[j], x[j]),
             f"{what}: request {r} differs at token {j} beyond a swap of "
             f"the top two: {top_a[key]} vs {top_b[key]}")
        swaps.append(f"request {r} token {j}: top two swapped, gaps "
                     f"{top_a[key][2]:.4g} / {top_b[key][2]:.4g}")
    return swaps


def spec_matmul_launches(cfg, run, draft_len, draft_layers=None):
    """bramac_matmul launches of a speculative serve (decode_steps 1): 7
    per layer + 1 (unembed) for every forward — the verify window and each
    admission chunk on the serving model; with the model drafter, per tick
    `draft_len` propose steps and one observe, and per admission chunk two
    observes (the chunk, then the sampled first token), on a draft model
    of `draft_layers` layers (None: the n-gram drafter, no forward)."""
    main = (7 * cfg.num_layers + 1) * (run["ticks"] + run["admits"])
    if draft_layers is None:
        return main
    return main + (7 * draft_layers + 1) * (
        (draft_len + 1) * run["ticks"] + 2 * run["admits"])


def phase_serve(report):
    from repro_torch.configs import get_config
    from repro_torch.core.bramac_linear import QuantConfig, \
        tree_prepare_serving
    from repro_torch.models import model as M
    q8 = QuantConfig(enabled=True, bits_w=8, bits_a=8)
    cfg = get_config("granite-8b").replace(quant=q8)
    need((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
          cfg.d_ff, cfg.vocab_size, cfg.dtype) ==
         (36, 4096, 32, 8, 14336, 49152, "bfloat16"), "granite-8b config")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tree_prepare_serving(M.init_params(cfg, gen, "cuda"), q8)
    torch.cuda.synchronize()
    int8_bytes = sum(
        t.values.numel() for p in params["layers"].values()
        for t in p["mixer"].values()) + sum(
        t.values.numel() for p in params["layers"].values()
        for t in p["mlp"].values()) + params["embed"]["unembed"].values.numel()
    print(f"  granite-8b params built and quantized in "
          f"{time.perf_counter() - t0:.1f} s ({int8_bytes / 1e9:.2f} GB int8)")
    prompts = _phase5_prompts(cfg.vocab_size)
    counters = _counters()
    per_layer = 7 * cfg.num_layers + 1         # wq wk wv wo gate up down + unembed
    totals = {k: 0 for k in counters}
    streams5, launches5 = {}, {}
    for quant_kv in (False, True):
        c = cfg.replace(quant_kv=quant_kv)
        # warm-up: a short serve pays the first-use costs (module loads,
        # allocator growth) so the timed serve below measures steady state
        serve(c, params, prompts[:2], 2)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        run = serve(c, params, prompts, 16)
        got = {k: fn.launches for k, fn in counters.items()}
        for k in totals:
            totals[k] += got[k]
        attn = "paged_decode_q" if quant_kv else "paged_decode"
        other = "paged_decode" if quant_kv else "paged_decode_q"
        need(run["done"] == 8, f"only {run['done']}/8 requests done")
        need(all(len(s) == 16 and all(0 <= t < cfg.vocab_size for t in s)
                 for s in run["streams"]), "streams malformed")
        need(got[attn] == run["steps"] * cfg.num_layers and got[attn] > 0,
             f"{attn} launches {got[attn]} != {run['steps']} steps x "
             f"{cfg.num_layers}")
        need(got[other] == 0, f"{other} launched on the {attn} path")
        need(got["bramac_matmul"] == per_layer * run["forwards"],
             f"bramac_matmul launches {got['bramac_matmul']} != "
             f"{per_layer} x {run['forwards']} forwards")
        peak = torch.cuda.max_memory_allocated() / 1e9
        ttft = 1e3 * float(np.mean(run["ttft"]))
        print(f"phase 5 serve granite-8b {'int8' if quant_kv else 'bf16'} KV: "
              f"{run['done']}/8 requests done, {run['tokens']} tokens in "
              f"{run['wall']:.2f} s ({run['tokens'] / run['wall']:.1f} tok/s), "
              f"mean TTFT {ttft:.1f} ms, peak memory {peak:.2f} GB, "
              f"{run['steps']} decode steps, {run['forwards']} forwards, "
              f"launches {got}")
        # the same serve again: its spread from the run above is the
        # run-to-run noise of the tok/s and TTFT readings
        rep = serve(c, params, prompts, 16)
        need(rep["streams"] == run["streams"],
             "a repeated greedy serve gave other streams")
        streams5["int8" if quant_kv else "bf16"] = run["streams"]
        launches5["int8" if quant_kv else "bf16"] = got
        rep_ttft = 1e3 * float(np.mean(rep["ttft"]))
        print(f"  repeat: {rep['tokens'] / rep['wall']:.1f} tok/s, mean TTFT "
              f"{rep_ttft:.1f} ms, same streams")
        report.setdefault("serve", []).append(dict(
            kv="int8" if quant_kv else "bf16", tok_s=run["tokens"] / run["wall"],
            ttft_ms=ttft, wall_s=run["wall"], peak_gb=peak, launches=got,
            repeat_tok_s=rep["tokens"] / rep["wall"], repeat_ttft_ms=rep_ttft))
    for k, n in totals.items():
        need(n > 0, f"{k} was never launched on the main path")
        report[k]["launches"] = n
    report["granite_streams"] = streams5     # phase 15c's mesh Engine's
    report["profile"] = profile_serve(cfg, params, prompts[:4])
    report["profile_int8_kv"] = profile_serve(cfg.replace(quant_kv=True),
                                              params, prompts[:4])
    # phases 8-10 run at full width on the first 12 of the 36 layers (views
    # of phase 5's stacked leaves), against colocated serves of that cut
    cut, pcut = granite_cut(cfg, params, CUT_LAYERS)
    streams_c, launches_c = {}, {}
    for quant_kv in (False, True):
        c = cut.replace(quant_kv=quant_kv)
        kv = "int8" if quant_kv else "bf16"
        _zero_counts()
        run = serve(c, pcut, prompts, 16)
        got = _read_counts()
        need(run["done"] == 8 and got["bramac_matmul"] ==
             (7 * CUT_LAYERS + 1) * run["forwards"],
             f"granite-8b {CUT_LAYERS}-layer cut ({kv} KV): {run['done']}/8 "
             f"done, launches {got}")
        streams_c[kv], launches_c[kv] = run["streams"], got
        for k, n in got.items():
            report[k]["launches"] += n
    print(f"  granite-8b cut to {CUT_LAYERS} of 36 layers for phases 8-10: "
          f"colocated streams and launches taken as their reference "
          f"(bramac_matmul {7 * CUT_LAYERS + 1} per forward)")
    phase_engine(cut, pcut, prompts, report)
    phase_spec(cut, pcut, prompts, streams_c["bf16"], report)
    phase_disagg(cut, pcut, prompts, streams_c, launches_c, report)
    del params, pcut
    gc.collect()
    torch.cuda.empty_cache()


CUT_LAYERS = 12                    # granite-8b depth of phases 8-10


def granite_cut(cfg, params, n_layers):
    """granite-8b's config and serving tree cut to its first `n_layers`
    layers at full width: views of the stacked per-period leaves."""
    from repro_torch.tree import tree_map
    layers = {k: tree_map(lambda a: a[:n_layers], v)
              for k, v in params["layers"].items()}
    return cfg.replace(num_layers=n_layers), dict(params, layers=layers)


def profile_serve(cfg, params, prompts, new_tokens=8,
                  label="phase 5 profile", host_ops=True, **kw):
    """Where the time goes: one short serve (by default 4 requests x 8
    tokens) under torch.profiler; device-busy share of the wall time and
    device time by kernel name.  The profiler slows the host, so its wall
    time is not the serve's tok/s.  `host_ops=False` traces the device
    only, which keeps the event list of a long serve short to read back."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops
                                      else [])
    with profile(activities=acts) as prof:
        run = serve(cfg, params, prompts, new_tokens, **kw)
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    wall = run["wall"] * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    if not by_name:
        print(f"{label}: the profiler saw no device kernels; device time "
              f"not measured")
        return {"device_busy_ms": None, "wall_ms": wall}
    # the matmul's kernels under every template instantiation
    matmul = {k: sum(t for n, t in by_name.items() if k in n)
              for k in ("bramac_accumulate", "bramac_epilogue")}
    attn_name = "paged_decode_q_kernel" if cfg.quant_kv else \
        "paged_decode_kernel"
    attn = sum(t for n, t in by_name.items() if attn_name in n)
    print(f"{label} ({len(prompts)} requests x {new_tokens} tokens, "
          f"{'int8' if cfg.quant_kv else 'bf16'} KV): device busy "
          f"{busy:.1f} ms of {wall:.1f} ms wall ({100 * busy / wall:.1f}%); "
          f"bramac_matmul accumulate {matmul['bramac_accumulate']:.1f} ms + "
          f"epilogue {matmul['bramac_epilogue']:.1f} ms; {attn_name} "
          f"{attn:.1f} ms; top kernels (ms): "
          + "; ".join(f"{n[:60]}={t:.1f}" for n, t in top))
    return {"device_busy_ms": busy, "wall_ms": wall, "forwards":
            run["forwards"], "steps": run["steps"], "matmul_ms": matmul,
            "attention_ms": attn, "top_kernels_ms": dict(top)}


# ---------------------------------------------------------------------------
# phase 8: the rest of the single-device Engine at granite-8b full width,
# 12 of its 36 layers
# ---------------------------------------------------------------------------

SYS_LEN = 104                      # 6.5 pages: 6 shared + 1 copy-on-write


def _zero_counts():
    for fn in _counters().values():
        fn.launches = 0


def _read_counts():
    return {k: fn.launches for k, fn in _counters().items()}


def _check_launches(cfg, eng, got, what):
    """The decode kernel of the run's KV dtype launches once per layer per
    decode step (none on a dense serve), the other never; bramac_matmul
    7 x layers + 1 times per forward."""
    steps = eng.n_ticks * eng.decode_steps
    forwards = steps + eng.n_admit_calls
    attn = "paged_decode_q" if cfg.quant_kv else "paged_decode"
    other = "paged_decode" if cfg.quant_kv else "paged_decode_q"
    want = steps * cfg.num_layers if eng.kv_layout == "paged" else 0
    need(got[attn] == want and got[other] == 0,
         f"{what}: decode kernel launches {got} for {steps} steps x "
         f"{cfg.num_layers} layers ({eng.kv_layout})")
    need(got["bramac_matmul"] == (7 * cfg.num_layers + 1) * forwards,
         f"{what}: bramac_matmul launches {got['bramac_matmul']} != "
         f"{7 * cfg.num_layers + 1} x {forwards} forwards")
    return steps, forwards


def prefix_serve(cfg, params, prompts, *, prefix_cache=True, abort=False,
                 device="cuda"):
    """The producer (prompts[0]) runs to completion, then the other
    prompts arrive in one wave; with `abort`, one running request (after
    the wave's first tick) and the last queued one are aborted.  Returns
    the run's readings."""
    from repro_torch.runtime.serve import Engine
    with Engine(cfg, params, num_slots=4, max_seq=256, prefix_chunk=8,
                prefix_cache=prefix_cache, check_invariants=True,
                decode_kernel=True, device=device) as eng:
        _zero_counts()
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = eng.submit(prompts[0], 16)
        eng.run()
        wave = [eng.submit(p, 16) for p in prompts[1:]]
        aborted = None
        if abort:
            eng.step()
            # a running request whose decode rows need a page no cached
            # chain covers, so its abort frees a page at once
            running = next(i for i, r in enumerate(wave)
                           if any(r is s for s in eng.slot_req)
                           and len(r.prompt) % 16 != 1)
            held = eng.pages_in_use
            need(eng.abort(wave[running]), "abort of a running request")
            freed = eng.pages_in_use
            need(freed < held, f"abort did not free pages at once: "
                 f"{held} -> {freed}")
            queued = len(wave) - 1
            need(any(wave[queued] is r for r in eng.sched.queue)
                 and eng.abort(wave[queued]), "abort of a queued request")
            aborted = (running + 1, queued + 1, held, freed)
        eng.run()
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _read_counts()
        reqs = [first] + wave
        steps, forwards = _check_launches(cfg, eng, got, "prefix serve")
        return dict(reqs=reqs, streams=[list(r.out_tokens) for r in reqs],
                    wall=wall, steps=steps, forwards=forwards, launches=got,
                    stats=eng.prefix_stats(), checks=eng.n_invariant_checks,
                    aborted=aborted,
                    tokens=sum(len(r.out_tokens) for r in reqs),
                    ttft_warm=float(np.mean([r.result.ttft for r in wave
                                             if r.result.ttft is not None])))


def sampled_serve(cfg, params, prompts, seeds, order, decode_steps=1):
    from repro_torch.runtime.serve import Engine
    with Engine(cfg, params, num_slots=4, max_seq=256, sampling="top_p",
                top_p=0.9, temperature=0.8, decode_steps=decode_steps,
                decode_kernel=True, device="cuda") as eng:
        _zero_counts()
        reqs = {i: eng.submit(prompts[i], 16, seed=seeds[i]) for i in order}
        eng.run()
        _check_launches(cfg, eng, _read_counts(), "sampled serve")
        need(all(r.done for r in reqs.values()), "sampled serve unfinished")
        return {seeds[i]: list(r.out_tokens) for i, r in reqs.items()}


def phase_engine(cfg, params, prompts5, report):
    """Phase 8: (a) the prefix cache with copy-on-write, bf16 and int8 KV,
    on vs off; (b) abort of a running and a queued request; (c) per-request
    sampling streams across order, slots and decode_steps."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(8)
    sysp = rng.integers(0, cfg.vocab_size, size=SYS_LEN)
    prompts = [np.concatenate([sysp, rng.integers(0, cfg.vocab_size,
                                                  size=int(n))])
               for n in rng.integers(9, 41, size=8)]
    totals = {}
    bf16_on = None
    for quant_kv in (False, True):
        c = cfg.replace(quant_kv=quant_kv)
        kv = "int8" if quant_kv else "bf16"
        torch.cuda.reset_peak_memory_stats()
        on = prefix_serve(c, params, prompts)
        peak = torch.cuda.max_memory_allocated() / 1e9
        off = prefix_serve(c, params, prompts, prefix_cache=False)
        for k, n in on["launches"].items():
            totals[k] = totals.get(k, 0) + n
        st = on["stats"]
        need((st["hits"], st["misses"], st["tokens_skipped"]) ==
             (7, 1, 7 * SYS_LEN), f"prefix stats ({kv} KV): {st}")
        warm = on["reqs"][1:]
        need(all(r.result.pages_shared == SYS_LEN // 16 and
                 r.result.prefill_tokens == len(r.prompt) - SYS_LEN
                 for r in warm), "warm requests' pages_shared / "
             "prefill_tokens")
        need(on["forwards"] < off["forwards"],
             f"prefix cache on: {on['forwards']} forwards, off: "
             f"{off['forwards']}")
        need(on["streams"] == off["streams"],
             f"prefix on != off streams ({kv} KV)")
        need(all(len(s) == 16 and all(0 <= t < cfg.vocab_size for t in s)
                 for s in on["streams"]), "prefix serve streams malformed")
        if not quant_kv:
            bf16_on = on
        # every hit matched all 104 tokens (728 = 7 x 104), which end 8
        # rows into page 7: one copy-on-write split per warm admission
        cow = st["hits"] if SYS_LEN % cfg.page_size else 0
        print(f"phase 8a prefix serve granite-8b {kv} KV: hits "
              f"{st['hits']}, misses {st['misses']}, tokens skipped "
              f"{st['tokens_skipped']} ({st['chunks_skipped']} chunks), "
              f"evictions {st['evictions']}, {cow} copy-on-write splits; "
              f"{on['tokens'] / on['wall']:.1f} tok/s on vs "
              f"{off['tokens'] / off['wall']:.1f} off; warm mean TTFT "
              f"{1e3 * on['ttft_warm']:.1f} ms on vs "
              f"{1e3 * off['ttft_warm']:.1f} ms off; forwards "
              f"{on['forwards']} on vs {off['forwards']} off; "
              f"{on['steps']} decode steps; peak memory {peak:.2f} GB; "
              f"{on['checks']} + {off['checks']} invariant checks passed; "
              f"launches on {on['launches']}, off {off['launches']}")
        report.setdefault("engine", []).append(dict(
            kv=kv, tok_s_on=on["tokens"] / on["wall"],
            tok_s_off=off["tokens"] / off["wall"],
            ttft_warm_ms_on=1e3 * on["ttft_warm"],
            ttft_warm_ms_off=1e3 * off["ttft_warm"],
            forwards_on=on["forwards"], forwards_off=off["forwards"],
            launches=on["launches"], peak_gb=peak, checks=on["checks"]))

    ab = prefix_serve(cfg, params, prompts, abort=True)
    running, queued, held, freed = ab["aborted"]
    for i in (running, queued):
        need(ab["reqs"][i].result.finish_reason == "aborted",
             f"request {i} not aborted")
    kept = ab["streams"][running]
    need(len(kept) >= 1 and kept == bf16_on["streams"][running][:len(kept)]
         and not ab["streams"][queued], "aborted requests' tokens")
    others = [i for i in range(8) if i not in (running, queued)]
    need(all(ab["streams"][i] == bf16_on["streams"][i] for i in others),
         "streams beside the aborted requests changed")
    print(f"phase 8b abort: running request {running} (kept {len(kept)} "
          f"tokens) and queued request {queued} aborted; pages in use "
          f"{held} -> {freed} at once; the other {len(others)} streams "
          f"equal 8a's; {ab['checks']} invariant checks passed; launches "
          f"{ab['launches']}")

    seeds = list(range(8))
    fwd = sampled_serve(cfg, params, prompts5, seeds, range(8))
    rev = sampled_serve(cfg, params, prompts5, seeds, range(7, -1, -1))
    fused = sampled_serve(cfg, params, prompts5, seeds, range(8),
                          decode_steps=4)
    need(fwd == rev == fused, "sampled streams depend on order, slot or "
         "decode_steps")
    other = sampled_serve(cfg, params, prompts5, [s + 100 for s in seeds],
                          range(8))
    changed = sum(other[s + 100] != fwd[s] for s in seeds)
    need(changed >= 6, f"seeds + 100 changed only {changed} of 8 streams")
    need(all(len(t) == 16 and all(0 <= x < cfg.vocab_size for x in t)
             for t in fwd.values()), "sampled streams malformed")
    print(f"phase 8c sampled serve (top_p 0.9, temperature 0.8, seeds "
          f"0-7): streams identical in order, in reverse order and at "
          f"decode_steps 4; seeds + 100 change {changed} of 8; phase 8 "
          f"took {time.perf_counter() - t_phase:.1f} s")
    for k, n in totals.items():
        need(n > 0, f"{k} was never launched on the prefix serves")
        report[k]["launches"] += n


# ---------------------------------------------------------------------------
# phase 9: speculative decoding at granite-8b full width, 12 of 36 layers
# ---------------------------------------------------------------------------

def structured_params(cfg, params, q8):
    """Integer-exact weights in the shape of the serving tree `params`:
    every layer weight zero (8-bit zeros; the residual passes the embedding
    through), embedding[t] = onehot(t % d), unembed[i, (i+1) % d] = 1,
    final norm ones.  The greedy stream is t -> t+1 (mod d) at 8 and at 2
    bits alike: one-hot activations and {0, 1} weights quantize exactly."""
    from repro_torch.core.bramac_linear import prepare_serving
    from repro_torch.tree import tree_map
    layers = tree_map(torch.zeros_like, params["layers"])
    D, V = cfg.d_model, cfg.vocab_size
    emb = torch.zeros((V, D), dtype=cfg.compute_dtype, device="cuda")
    rows = torch.arange(V, device="cuda")
    emb[rows, rows % D] = 1
    unemb = torch.zeros((D, V), dtype=cfg.compute_dtype, device="cuda")
    unemb[rows[:D], (rows[:D] + 1) % D] = 1
    return {"embed": {"embedding": emb, "unembed": prepare_serving(unemb, q8)},
            "final_norm": {"scale": torch.ones((D,), dtype=cfg.compute_dtype,
                                               device="cuda")},
            "layers": layers}


def phase_spec(cfg, params, prompts, streams5, report):
    """Phase 9: (a) the structured stream at full width, exact, served
    without speculation, with the n-gram drafter and with the 2-bit model
    drafter (all of the cut's layers); (b) phase 5's random weights and
    prompts (the cut's layers) with
    the n-gram drafter (prefix cache and invariant checks on) and the 2-bit
    model drafter cut to 4 layers."""
    from repro_torch.core.bramac_linear import QuantConfig
    from repro_torch.runtime.serve import Engine
    t_phase = time.perf_counter()
    q8 = QuantConfig(enabled=True, bits_w=8, bits_a=8)
    sparams = structured_params(cfg, params, q8)
    prompt, n_new, d = [1, 2, 3], 32, 4
    expect = [(prompt[-1] + 1 + i) % cfg.d_model for i in range(n_new)]
    runs, totals = {}, {}
    for kind in ("none", "ngram", "model"):
        kw = {} if kind == "none" else dict(draft_len=d, drafter=kind,
                                            draft_bits=2)
        _zero_counts()
        run = serve(cfg, sparams, [prompt], n_new, num_slots=1, max_seq=64,
                    **kw)
        got = _read_counts()
        need(run["streams"] == [expect],
             f"phase 9a ({kind}): stream {run['streams']} != t+1")
        if kind == "none":
            derived = (7 * cfg.num_layers + 1) * run["forwards"]
            need(got["paged_decode"] == run["steps"] * cfg.num_layers,
                 f"phase 9a (none): decode launches {got}")
        else:
            derived = spec_matmul_launches(
                cfg, run, d, cfg.num_layers if kind == "model" else None)
            need(got["paged_decode"] == got["paged_decode_q"] == 0,
                 f"phase 9a ({kind}): decode kernel launched {got}")
        need(got["bramac_matmul"] == derived,
             f"phase 9a ({kind}): bramac_matmul launches "
             f"{got['bramac_matmul']} != derived {derived}")
        for k, v in got.items():
            totals[k] = totals.get(k, 0) + v
        runs[kind] = run
        st = run["spec"]
        # forwards through either model: the serving model's, plus the
        # draft model's (propose, observe) — per emitted token
        draft_fwd = (d + 1) * run["ticks"] + 2 * run["admits"] \
            if kind == "model" else 0
        draft_launches = (7 * cfg.num_layers + 1) * draft_fwd
        print(f"phase 9a structured stream granite-8b ({kind}): exact "
              f"{n_new}-token stream t -> t+1; {run['ticks']} ticks, "
              f"{run['forwards']} serving forwards + {draft_fwd} draft "
              f"forwards = {(run['forwards'] + draft_fwd) / n_new:.2f} "
              f"forwards/token; {run['tokens'] / run['wall']:.1f} tok/s; "
              f"accepted {st['accepted']}/{st['drafted']}; matmul launches "
              f"{got['bramac_matmul']} (= derived; {draft_launches} of them "
              f"2-bit draft-model calls)")
    ng, md = runs["ngram"]["spec"], runs["model"]["spec"]
    need(ng["accepted"] == 0, f"phase 9a: n-gram accepted {ng}")
    need(md["accepted"] >= md["drafted"] - d and md["drafted"] > 0,
         f"phase 9a: model drafter accepted {md}")
    need(runs["model"]["ticks"] < runs["ngram"]["ticks"],
         "phase 9a: the model drafter did not save ticks")
    report["spec_structured"] = {
        k: dict(ticks=r["ticks"], forwards=r["forwards"],
                tok_s=r["tokens"] / r["wall"], spec=r["spec"])
        for k, r in runs.items()}
    # where the model drafter's time goes: its 2-bit weights unpacked at
    # every call, beside the kernels (one admission and one full window)
    report["profile_spec_model"] = profile_serve(
        cfg, sparams, [prompt], d + 2, label="phase 9a profile, model drafter",
        host_ops=False, num_slots=1, max_seq=64, draft_len=d,
        drafter="model", draft_bits=2)
    del sparams
    torch.cuda.empty_cache()

    rows = {}
    for kind, kw, layers in (
            ("ngram", dict(prefix_cache=True), None),
            ("model", dict(draft_bits=2, draft_layers=4), 4)):
        with Engine(cfg, params, num_slots=4, max_seq=256, draft_len=d,
                    drafter=kind, check_invariants=True, device="cuda",
                    **kw) as eng:
            windows = [0]
            tick = eng.decode.tick

            def counted(*a, _tick=tick, _eng=eng):
                # every occupied slot is active when a tick starts: the
                # engine retires inactive ones at each sync
                windows[0] += sum(r is not None for r in _eng.slot_req)
                return _tick(*a)

            eng.decode.tick = counted
            _zero_counts()
            reqs = [eng.submit(p, 16) for p in prompts]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = _read_counts()
            run = dict(ticks=eng.n_ticks, admits=eng.n_admit_calls)
            st = eng.spec_stats()
            checks = eng.n_invariant_checks
        streams = [list(r.out_tokens) for r in reqs]
        need(all(r.done and r.result.finish_reason in ("budget", "eos")
                 for r in reqs), "phase 9b: a request ended otherwise")
        need(all(len(x) == 16 and all(0 <= t < cfg.vocab_size for t in x)
                 for x in streams), "phase 9b: streams malformed")
        need(checks > 0, "phase 9b: no invariant check ran")
        need(st["drafted"] == d * windows[0],
             f"phase 9b ({kind}): drafted {st['drafted']} != {d} x "
             f"{windows[0]} active windows")
        derived = spec_matmul_launches(cfg, run, d, layers)
        need(got["bramac_matmul"] == derived,
             f"phase 9b ({kind}): bramac_matmul launches "
             f"{got['bramac_matmul']} != derived {derived}")
        need(got["paged_decode"] == got["paged_decode_q"] == 0,
             f"phase 9b ({kind}): decode kernel launched {got}")
        for k, v in got.items():
            totals[k] = totals.get(k, 0) + v
        common = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b),
                       min(len(x), len(y))) for x, y in zip(streams, streams5)]
        ttft = 1e3 * float(np.mean([r.result.ttft for r in reqs]))
        tokens = sum(len(x) for x in streams)
        forwards = run["ticks"] + run["admits"]
        rows[kind] = dict(acceptance=st["acceptance_rate"],
                          drafted=st["drafted"], accepted=st["accepted"],
                          tok_s=tokens / wall, ttft_ms=ttft,
                          forwards=forwards, ticks=run["ticks"],
                          windows=windows[0], common_prefix=common,
                          launches=got["bramac_matmul"], checks=checks)
        print(f"phase 9b granite-8b random weights ({kind}"
              f"{', 4 draft layers' if layers else ', prefix cache on'}): "
              f"8/8 requests done; accepted {st['accepted']}/{st['drafted']} "
              f"({100 * st['acceptance_rate']:.1f}%) over {windows[0]} active "
              f"windows; {tokens / wall:.1f} tok/s; mean TTFT {ttft:.1f} ms; "
              f"{forwards} serving forwards ({run['ticks']} ticks + "
              f"{run['admits']} admission chunks); {checks} invariant checks "
              f"passed; matmul launches {got['bramac_matmul']} (= derived; "
              f"{got['bramac_matmul'] - (7 * cfg.num_layers + 1) * forwards} "
              f"2-bit draft-model calls); common prefix with phase 5's "
              f"streams {common}")
    report["spec_serve"] = rows
    for k, n in totals.items():
        report[k]["launches"] += n
    print(f"phase 9 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 10: prefill/decode disaggregation at granite-8b full width (12 of
# its 36 layers), and
# minicpm3-4b (MLA) at full size
# ---------------------------------------------------------------------------

def transfer_bytes(cfg, n_pages):
    """Bytes a transfer of `n_pages` pages moves: every pool row of every
    layer (K, V and, for int8 KV, their row scales), `kv_row_bytes` per
    token row."""
    from repro_torch.kernels import paged_attention as pa
    return n_pages * cfg.page_size * pa.kv_row_bytes(cfg)


def timed_transfers(cfg, params, prompts, new_tokens=16):
    """A disaggregated serve whose transfer rounds are timed with CUDA
    events.  A device spin ahead of each round's start event keeps the
    card busy while the host enqueues the round, so the interval is device
    time.  Returns ([(device ms, pages, host ms)], streams)."""
    from repro_torch.runtime.serve import Engine
    spin = int(5.0 * spin_cycles_per_ms())
    rounds = []
    with Engine(cfg, params, num_slots=4, max_seq=256, disagg=True,
                prefix_cache=False, device="cuda") as eng:
        plain = eng._transfer

        def timed():
            if not eng.sched.ready:
                return plain()
            n0 = eng.pages_transferred
            torch.cuda._sleep(spin)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            plain()
            b.record()
            host = (time.perf_counter() - t0) * 1e3
            if eng.pages_transferred > n0:
                rounds.append((a, b, eng.pages_transferred - n0, host))

        eng._transfer = timed
        reqs = [eng.submit(p, new_tokens) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        streams = [list(r.out_tokens) for r in reqs]
    return [(a.elapsed_time(b), n, host) for a, b, n, host in rounds], streams


def phase_disagg(cfg, params, prompts, streams5, launches5, report):
    """Phase 10 at granite-8b full width, phase 5's weights (the cut's
    layers) and prompts: (a) disaggregated serves, bf16 and int8 KV, decode
    kernels and invariant checks on — streams and launch counts equal to
    the cut's colocated serves, an I7 content check after every transfer round, both
    pools drained; (b) a decode pool of 9 pages, too small for two of the
    larger requests: the transfer backpressures, streams stay equal and
    nothing leaks; (c) the transfer round of the first wave (4 requests,
    4 tokens) timed beside its byte bound."""
    t_phase = time.perf_counter()
    totals = {}
    rows = []
    for quant_kv in (False, True):
        c = cfg.replace(quant_kv=quant_kv)
        kv = "int8" if quant_kv else "bf16"
        _zero_counts()
        torch.cuda.reset_peak_memory_stats()
        run = serve(c, params, prompts, 16, disagg=True,
                    check_invariants=True)
        got = _read_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        for k, n in got.items():
            totals[k] = totals.get(k, 0) + n
        dg = run["disagg"]
        need(run["streams"] == streams5[kv],
             f"phase 10a ({kv} KV): disaggregated streams != the cut's "
             f"colocated streams")
        need(got == launches5[kv], f"phase 10a ({kv} KV): launches {got} "
             f"!= the colocated serve's {launches5[kv]}")
        need(dg["pages_transferred"] >= 8 and dg["transfer_rounds"] > 0,
             f"phase 10a ({kv} KV): {dg}")
        need(run["transfer_checks"] == dg["transfer_rounds"],
             f"phase 10a ({kv} KV): {run['transfer_checks']} I7 checks for "
             f"{dg['transfer_rounds']} transfer rounds")
        need(run["drained"], f"phase 10a ({kv} KV): a pool kept pages")
        need(all(r == "budget" for r in run["reasons"]),
             f"phase 10a ({kv} KV): finish reasons {run['reasons']}")
        ttft = 1e3 * float(np.mean(run["ttft"]))
        print(f"phase 10a disagg serve granite-8b ({cfg.num_layers} layers) "
              f"{kv} KV: streams == colocated streams; {dg['pages_transferred']} pages in "
              f"{dg['transfer_rounds']} rounds "
              f"({dg['transfers_backpressured']} backpressured), decode "
              f"pool {dg['decode_pages_high_water']}/{dg['decode_pages']} "
              f"high-water, prefill pool {dg['prefill_pages_high_water']}/"
              f"{dg['prefill_pages']}; {run['checks']} invariant checks, "
              f"{run['transfer_checks']} I7 content checks; "
              f"{run['tokens'] / run['wall']:.1f} tok/s with the checks on, "
              f"mean TTFT {ttft:.1f} ms, peak memory {peak:.2f} GB; "
              f"launches {got} (= colocated)")
    for k, n in totals.items():
        report[k]["launches"] += n
    small = serve(cfg, params, prompts, 16, disagg=True,
                  check_invariants=True, num_pages=9)
    dg = small["disagg"]
    need(small["streams"] == streams5["bf16"],
         "phase 10b: streams under decode-pool pressure != colocated")
    need(dg["transfers_backpressured"] > 0 and
         dg["decode_pages_high_water"] <= 9, f"phase 10b: {dg}")
    need(small["drained"] and small["transfer_checks"] ==
         dg["transfer_rounds"], "phase 10b: a pool leaked or a round went "
         "unchecked")
    print(f"phase 10b decode pool of 9 pages (bf16 KV): streams == "
          f"colocated; {dg['transfers_backpressured']} transfers backpressured, "
          f"decode high-water {dg['decode_pages_high_water']}/9, "
          f"{dg['transfer_rounds']} rounds, {small['ticks']} ticks, both "
          f"pools drained")
    for quant_kv in (False, True):
        c = cfg.replace(quant_kv=quant_kv)
        kv = "int8" if quant_kv else "bf16"
        # the first wave only, 4 tokens each: one round of 4 transfers
        timed, streams = timed_transfers(c, params, prompts[:4], 4)
        need(streams == [x[:4] for x in streams5[kv][:4]],
             f"phase 10c ({kv} KV): streams")
        need(timed, f"phase 10c ({kv} KV): no transfer round timed")
        for ms, n, host in timed:
            nbytes = transfer_bytes(c, n)
            bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
            rows.append(dict(kv=kv, pages=n, bytes=nbytes, ms=ms,
                             bound_ms=bound, host_ms=host))
        print(f"phase 10c transfer rounds ({kv} KV, "
              f"{transfer_bytes(c, 1) / 1e6:.3f} MB a page): "
              + "; ".join(f"{n} pages {ms:.4f} ms (bound {2 * transfer_bytes(c, n) / HBM_BYTES_PER_S * 1e3:.4f} ms, host enqueue {host:.3f} ms)"
                          for ms, n, host in timed))
    report["disagg"] = dict(transfers=rows)
    spent = time.perf_counter() - t_phase
    print(f"phase 10 (a-c) took {spent:.1f} s")
    report["phase10_s"] = spent


def phase_minicpm(report):
    """Phase 10d: minicpm3-4b at full size (62 layers, d=2560, 40 heads,
    MLA with q_lora 768 / kv_lora 256, vocab 73448; bf16, 8-bit weights,
    random from a seed), phase 5's serve colocated and disaggregated: equal
    streams, bramac_matmul launches = (10 x 62 + 1) per forward, no decode
    kernel (MLA reads through the gather); then a device-only profile."""
    from repro_torch.configs import get_config
    from repro_torch.core.bramac_linear import QuantConfig, \
        tree_prepare_serving
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    q8 = QuantConfig(enabled=True, bits_w=8, bits_a=8)
    cfg = get_config("minicpm3-4b").replace(quant=q8)
    need((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
          cfg.d_ff, cfg.vocab_size) == (62, 2560, 40, 40, 6400, 73448),
         "minicpm3-4b config")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tree_prepare_serving(M.init_params(cfg, gen, "cuda"), q8)
    torch.cuda.synchronize()
    print(f"  minicpm3-4b params built and quantized in "
          f"{time.perf_counter() - t_phase:.1f} s; {held:.2f} GB still held "
          f"after granite-8b was freed, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB now")
    prompts = _phase5_prompts(cfg.vocab_size)
    per_fwd = 10 * cfg.num_layers + 1
    serve(cfg, params, prompts[:1], 2)                  # warm-up
    runs = {}
    for disagg in (False, True):
        what = "disaggregated" if disagg else "colocated"
        _zero_counts()
        torch.cuda.reset_peak_memory_stats()
        run = serve(cfg, params, prompts, 16, disagg=disagg)
        got = _read_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        need(run["done"] == 8 and all(
            len(x) == 16 and all(0 <= t < cfg.vocab_size for t in x)
            for x in run["streams"]), f"phase 10d ({what}): streams")
        need(got["bramac_matmul"] == per_fwd * run["forwards"],
             f"phase 10d ({what}): bramac_matmul launches "
             f"{got['bramac_matmul']} != {per_fwd} x {run['forwards']}")
        need(got["paged_decode"] == got["paged_decode_q"] == 0,
             f"phase 10d ({what}): a decode kernel launched: {got}")
        need(run["drained"], f"phase 10d ({what}): a pool kept pages")
        report["bramac_matmul"]["launches"] += got["bramac_matmul"]
        ttft = 1e3 * float(np.mean(run["ttft"]))
        runs[what] = dict(tok_s=run["tokens"] / run["wall"], ttft_ms=ttft,
                          peak_gb=peak, forwards=run["forwards"],
                          launches=got["bramac_matmul"], disagg=run["disagg"])
        print(f"phase 10d serve minicpm3-4b {what}: {run['done']}/8 "
              f"requests, {run['tokens']} tokens, "
              f"{run['tokens'] / run['wall']:.1f} tok/s, mean TTFT "
              f"{ttft:.1f} ms, peak memory {peak:.2f} GB, "
              f"{run['forwards']} forwards, bramac_matmul launches "
              f"{got['bramac_matmul']} (= {per_fwd} x forwards), no decode "
              f"kernel" + (f"; {run['disagg']['pages_transferred']} pages "
                           f"transferred" if disagg else ""))
        runs[what]["streams"] = run["streams"]
    need(runs["colocated"]["streams"] == runs["disaggregated"]["streams"],
         "phase 10d: minicpm3-4b disaggregated streams != colocated")
    prof = profile_serve(cfg, params, prompts[:4], new_tokens=4,
                         label="phase 10d profile minicpm3-4b",
                         host_ops=False)
    for r in runs.values():
        del r["streams"]
    report["minicpm3"] = dict(runs, profile=prof)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    spent = time.perf_counter() - t_phase
    print(f"phase 10d took {spent:.1f} s; phase 10 in all "
          f"{report['phase10_s'] + spent:.1f} s")


# ---------------------------------------------------------------------------
# phase 11: the MoE feed-forward, and qwen3-moe-30b-a3b at full width
# ---------------------------------------------------------------------------

# qwen3-moe-30b-a3b's expert einsums, (K, N) per expert, and the rows C an
# expert's buffer has in its serve: a 4-slot decode step (T = 4: C = 1), a
# 64-token admission chunk (C = round(64 x 8 / 128 x 1.25) = 5), and the
# no-drop capacity E / k at 64 tokens (C = 64)
QWEN3_EINSUMS = {"w_gate/w_up": (2048, 768), "w_down": (768, 2048)}


def _qwen3_cfg(**over):
    from repro_torch.configs import get_config
    from repro_torch.core.bramac_linear import QuantConfig
    q8 = QuantConfig(enabled=True, bits_w=8, bits_a=8)
    cfg = get_config("qwen3-moe-30b-a3b").replace(quant=q8, **over)
    need((cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.num_experts,
          cfg.experts_per_token, cfg.expert_d_ff, cfg.vocab_size,
          cfg.layer_pattern) == (2048, 32, 4, 128, 8, 768, 151936,
                                 ("attn+moe",)), "qwen3-moe-30b-a3b config")
    return cfg, q8


MOE_CUT_LAYERS = 16                # qwen3-moe-30b-a3b depth of phase 11c


def _moe_matmul_launches(cfg) -> int:
    """bramac_matmul launches of one forward: wq wk wv wo and the three
    expert einsums of E calls each per layer, and the unembed."""
    return (4 + 3 * cfg.num_experts) * cfg.num_layers + 1


def phase_moe(report):
    """Phase 11: (a) the expert einsum at qwen3-moe-30b-a3b's shapes, (b)
    one MoE layer at full width, (c) qwen3-moe-30b-a3b served at full
    width, (d) its stream identities at 2 layers, f32."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg, q8 = _qwen3_cfg()
    need(cfg.num_layers == 48 and cfg.dtype == "bfloat16",
         "qwen3-moe-30b-a3b config")
    gen = torch.Generator(device="cuda").manual_seed(0)
    report["moe_einsum"] = phase_moe_einsum(gen, cfg)
    report["moe_layer"] = phase_moe_layer(gen, cfg, q8)
    phase_moe_serve(cfg, q8, report)
    report["moe_streams"] = phase_moe_streams()
    spent = time.perf_counter() - t_phase
    report["phase11_s"] = spent
    print(f"phase 11 took {spent:.1f} s")


def phase_moe_einsum(gen, cfg):
    """11a: `serve_einsum_edf` (one `bramac_matmul` per expert, all E
    calls) bit-exact against `serve_einsum_edf_plain`, timed beside its
    bound and one bf16 `torch.bmm` over the same (E, C, K) x (E, K, N)."""
    from repro_torch.core.bramac_linear import (QuantConfig, prepare_serving,
                                                serve_einsum_edf,
                                                serve_einsum_edf_plain)
    E = cfg.num_experts
    cases = [(name, K, N, C, 8) for name, (K, N) in QWEN3_EINSUMS.items()
             for C in (1, 5, 64)]
    cases += [("w_gate/w_up",) + QWEN3_EINSUMS["w_gate/w_up"] + (5, bits)
              for bits in (4, 2)]
    rows = []
    for name, K, N, C, bits in cases:
        x = torch.randn((E, C, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = (torch.randn((E, K, N), generator=gen, device="cuda")
             / K ** 0.5).to(torch.bfloat16)
        qw = prepare_serving(w, QuantConfig(enabled=True, bits_w=bits,
                                            bits_a=8))
        got = serve_einsum_edf(x, qw, False)
        want = serve_einsum_edf_plain(x, qw, False)
        torch.cuda.synchronize()
        need(torch.equal(got, want), f"phase 11a: serve_einsum_edf != plain "
             f"at {name} C={C} {bits}-bit")
        # 128 calls of Python enqueue ~10x longer than the device runs
        # them: a long spin keeps host hiccups out of the device interval
        ms = time_cold(lambda: serve_einsum_edf(x, qw, False),
                       spin_factor=10)
        # the plain loop takes ~1 s of host time a call: one warm-up, one
        # timed call
        plain_ms = time_cold(lambda: serve_einsum_edf_plain(x, qw, False),
                             iters=1, spin_factor=10, warmup=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            serve_einsum_edf(x, qw, False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 5
        wb = qw.dequantize().to(torch.bfloat16)
        lib_ms = time_cold(lambda: torch.bmm(x, wb))
        # x in, weights as stored, both scales, the bf16 out; one int8
        # product per expert
        nbytes = E * (2 * C * K + K * N * bits // 8 + 4 * (C + N)
                      + 2 * C * N)
        ops = 2 * E * C * K * N
        bound = max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / INT8_OPS_PER_S \
            else "operations"
        rows.append(dict(shape=name, C=C, K=K, N=N, bits=bits, calls=E,
                         ms=ms, wall_ms=wall_ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by, library="bf16 torch.bmm",
                         library_ms=lib_ms))
        print(f"  expert einsum {name} E={E} C={C} K={K} N={N} {bits}-bit "
              f"({E} bramac_matmul calls): {ms:.4f} ms on the device, "
              f"{wall_ms:.2f} ms wall (bound {bound:.4f} ms by {by}, plain "
              f"{plain_ms:.4f} ms, bf16 torch.bmm {lib_ms:.4f} ms)")
        del x, w, qw, wb, got, want
    print(f"phase 11a expert einsum: {len(rows)} cases bit-exact vs plain "
          f"(qwen3-moe-30b-a3b gate/up and down over all {E} experts, C = "
          f"1 / 5 / 64, 8-bit; 4- and 2-bit at C = 5)")
    return rows


def phase_moe_layer(gen, cfg, q8):
    """11b: one MoE layer at full width (bf16, 8-bit weights, 64 tokens of
    random input).  At no-drop capacity `moe` is within MOE_LAYER_RTOL of
    `moe_reference` on the dequantized weights (f32); at the default
    capacity the keep mask and drop count equal those of the same routing
    on the CPU."""
    from repro_torch.core.bramac_linear import tree_prepare_serving
    from repro_torch.models import moe as moe_mod
    p = moe_mod.init_moe(gen, cfg, "cuda")
    qp = tree_prepare_serving(p, q8)
    del p
    x = torch.randn((1, 64, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    E, k = cfg.num_experts, cfg.experts_per_token
    out, aux = moe_mod.moe(qp, x, cfg, capacity_factor=E / k)
    deq = {n: (v if n == "router" else v.dequantize()) for n, v in qp.items()}
    ref = moe_mod.moe_reference(deq, x.float(), cfg)
    err = (out.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    need(bool(torch.isfinite(out).all()) and err <= MOE_LAYER_RTOL * scale,
         f"phase 11b: moe vs moe_reference max abs err {err} > "
         f"{MOE_LAYER_RTOL} x {scale}")
    xf = x.reshape(-1, cfg.d_model)
    r = moe_mod.route(qp, xf, cfg, cfg.moe_capacity_factor)
    rc = moe_mod.route({"router": qp["router"].cpu()}, xf.cpu(), cfg,
                       cfg.moe_capacity_factor)
    drops = int((~r.keep).sum())
    need(r.C == rc.C and torch.equal(r.keep.cpu(), rc.keep),
         "phase 11b: keep mask on the card != on the CPU")
    need(drops == int((~rc.keep).sum()) and drops > 0,
         f"phase 11b: drops {drops}")
    print(f"phase 11b MoE layer at full width (d={cfg.d_model}, E={E}, "
          f"top-{k}, ff={cfg.expert_d_ff}, bf16, 8-bit, 64 tokens): no-drop "
          f"capacity vs moe_reference on the dequantized weights max abs "
          f"err {err:.4g} (max |ref| {scale:.4g}, tolerance "
          f"{MOE_LAYER_RTOL} x that), aux {aux.item():.4f}; capacity "
          f"{cfg.moe_capacity_factor}: C = {r.C}, {drops} of {r.keep.numel()} "
          f"assignments dropped, keep mask equal to the CPU's")
    return dict(err=err, ref_max=scale, drops=drops, C=r.C,
                assignments=r.keep.numel())


# 8-bit activations of the buffer and of silu(g) * u (a step of 1/127 of
# each row's max) and bf16 buffers: a few percent of the output's scale
# (0.031 of it on a 32-expert layer of the same widths, on the CPU)
MOE_LAYER_RTOL = 0.08


def phase_moe_serve(cfg, q8, report):
    """11c: qwen3-moe-30b-a3b at full width (128 experts top-8, bf16, 8-bit
    weights, random from a seed), cut to 16 of its 48 layers, through the
    Engine: phase 5's traffic cut to 4 requests x 8 new tokens, bf16 and
    int8 KV.  bramac_matmul launches (4 + 3 x 128) x 16 + 1 per forward,
    the decode kernel 16 per decode step, the pools drained; then a
    device-only profile of one short request."""
    from repro_torch.core.quant import QuantizedTensor
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    # the first 16 of the 48 layers at full width (the same draws as the
    # full model's first 16 periods)
    cfg = cfg.replace(num_layers=MOE_CUT_LAYERS)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda", serving=q8)
    torch.cuda.synchronize()
    moe = params["layers"]["pos0"]["moe"]
    expert_b = sum(moe[n].values.numel() for n in ("w_gate", "w_up",
                                                    "w_down"))
    attn_b = sum(t.values.numel() for t in
                 params["layers"]["pos0"]["mixer"].values()
                 if isinstance(t, QuantizedTensor))
    print(f"  qwen3-moe-30b-a3b params built and quantized one period at a "
          f"time in {time.perf_counter() - t0:.1f} s: experts "
          f"{expert_b / 1e9:.2f} GB int8, attention {attn_b / 1e9:.2f} GB, "
          f"unembed {params['embed']['unembed'].values.numel() / 1e9:.2f} "
          f"GB, bf16 embedding "
          f"{2 * params['embed']['embedding'].numel() / 1e9:.2f} GB; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    prompts = _phase5_prompts(cfg.vocab_size)[:4]
    per_fwd = _moe_matmul_launches(cfg)
    need(per_fwd == 6209, f"qwen3 launches per forward {per_fwd}")
    serve(cfg, params, [prompts[0][:5]], 2)                 # warm-up
    runs = {}
    for quant_kv in (False, True):
        c = cfg.replace(quant_kv=quant_kv)
        kv = "int8" if quant_kv else "bf16"
        attn = "paged_decode_q" if quant_kv else "paged_decode"
        other = "paged_decode" if quant_kv else "paged_decode_q"
        _zero_counts()
        torch.cuda.reset_peak_memory_stats()
        run = serve(c, params, prompts, 8)
        got = _read_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        need(run["done"] == 4 and all(
            len(s) == 8 and all(0 <= t < cfg.vocab_size for t in s)
            for s in run["streams"]), f"phase 11c ({kv} KV): streams")
        need(got["bramac_matmul"] == per_fwd * run["forwards"],
             f"phase 11c ({kv} KV): bramac_matmul launches "
             f"{got['bramac_matmul']} != {per_fwd} x {run['forwards']}")
        need(got[attn] == cfg.num_layers * run["steps"] > 0
             and got[other] == 0, f"phase 11c ({kv} KV): decode kernel "
             f"launches {got} for {run['steps']} steps")
        need(run["drained"], f"phase 11c ({kv} KV): a pool kept pages")
        if not quant_kv:
            streams = run["streams"]
        for k, n in got.items():
            report[k]["launches"] += n
        ttft = 1e3 * float(np.mean(run["ttft"]))
        runs[kv] = dict(tok_s=run["tokens"] / run["wall"], ttft_ms=ttft,
                        wall_s=run["wall"], peak_gb=peak,
                        forwards=run["forwards"], steps=run["steps"],
                        launches=got,
                        s_per_forward=run["wall"] / run["forwards"])
        print(f"phase 11c serve qwen3-moe-30b-a3b ({cfg.num_layers} of 48 "
              f"layers) {kv} KV: {run['done']}/4 "
              f"requests, {run['tokens']} tokens in {run['wall']:.2f} s "
              f"({run['tokens'] / run['wall']:.2f} tok/s), mean TTFT "
              f"{ttft:.1f} ms, peak memory {peak:.2f} GB, "
              f"{run['forwards']} forwards ({run['wall'] / run['forwards']:.3f}"
              f" s each), launches {got} (= {per_fwd} x forwards and "
              f"{cfg.num_layers} x {run['steps']} steps)")
    report["qwen3_streams"] = streams       # phase 15d's mesh Engine's
    prof = profile_serve(cfg, params, [prompts[0][:16]], new_tokens=2,
                         label="phase 11c profile qwen3-moe-30b-a3b",
                         host_ops=False)
    report["qwen3_moe"] = dict(runs, profile=prof,
                               expert_gb=expert_b / 1e9)
    del params, moe
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 11c took {time.perf_counter() - t0:.1f} s")


def phase_moe_streams(seed=3):
    """11d: qwen3-moe-30b-a3b's width at 2 layers, f32, at capacity_factor
    E / k, where no token is dropped and a row's output does not depend on
    the other rows of its call.  With 8-bit weights, greedy streams are
    equal across the Engine's modes within one attention route: with the
    decode kernel, paged == disaggregated == prefix cache on == off ==
    draft_len 4 (MoE opts out of speculation: no drafter); through the
    gather oracle, paged == dense layout.  Across the two routes a
    last-bit difference between the decode kernel's attention and the
    gather oracle's moves a value across an 8-bit activation rounding now
    and then.  In a dense model that changes a token only at a near tie of
    the top two logits; a MoE layer also turns it into another expert
    wherever the router's k-th and (k+1)-th probabilities nearly tie.  So
    the decode kernel on == off == dense identity is held on f32 weights,
    where no activation is requantized (there the two routes' router
    log-probabilities agree within F32_ROUTE_EPS and pick the same
    experts).  At 8 bits the routes' router probabilities are logged at
    every decode tick (`expert_switches`): they agree within
    ROUTE_MOVE_EPS, so an expert switch needs a k-th/(k+1)-th gap below
    twice that, and every stream that parts must part at or after a
    switch in its own row, or by a swap of its top two tokens."""
    from repro_torch.core.bramac_linear import FP32, tree_prepare_serving
    from repro_torch.models import model as M
    cfg, q8 = _qwen3_cfg(num_layers=2, dtype="float32")
    cfg = cfg.replace(moe_capacity_factor=cfg.num_experts
                      / cfg.experts_per_token)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = tree_prepare_serving(M.init_params(cfg, gen, "cuda"), q8)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n))
               for n in (15, 16, 17, 33, 5, 48)]
    stem = rng.integers(0, cfg.vocab_size, size=44)
    tail = lambda n: rng.integers(0, cfg.vocab_size, size=n)  # noqa: E731
    stag = [np.concatenate([stem, tail(5)]), np.concatenate([stem, tail(9)]),
            np.concatenate([stem[:30], tail(7)]),
            np.concatenate([stem, tail(3)])]
    kw = dict(num_slots=3, max_seq=96)
    per_fwd = _moe_matmul_launches(cfg)

    def run_checked(c, p, what, **extra):
        _zero_counts()
        run = serve(c, p, prompts, 12, **kw, **extra)
        got = _read_counts()
        kernel = c.quant.enabled
        need(got["bramac_matmul"] == (per_fwd * run["forwards"] if kernel
                                      else 0),
             f"phase 11d ({what}): bramac_matmul launches {got}")
        want = c.num_layers * run["steps"] if run["decode_kernel"] else 0
        need(got["paged_decode"] == want and got["paged_decode_q"] == 0,
             f"phase 11d ({what}): decode kernel launches {got}")
        return run

    logs = {r: ({}, []) for r in ("on", "off")}
    on = run_checked(cfg, params, "8-bit, kernel on", top2=logs["on"][0],
                     routes=logs["on"][1])
    out = {}
    for what, extra in {"disaggregated": dict(disagg=True,
                                              check_invariants=True),
                        "draft_len 4": dict(draft_len=4, drafter="ngram")
                        }.items():
        run = run_checked(cfg, params, f"8-bit, {what}", **extra)
        need(run["streams"] == on["streams"], f"phase 11d: 8-bit {what} != "
             f"kernel-on streams: {run['streams']} vs {on['streams']}")
        if what == "disaggregated":
            need(run["drained"] and run["transfer_checks"] ==
                 run["disagg"]["transfer_rounds"] > 0,
                 f"phase 11d disaggregated: {run['disagg']}")
        else:
            need(run["spec"]["drafter"] is None and
                 run["spec"]["drafted"] == 0,
                 f"phase 11d: speculation did not opt out: {run['spec']}")
        out[what] = "equal"
    warm = staggered(cfg, params, stag, prefix_cache=True)
    cold = staggered(cfg, params, stag, prefix_cache=False)
    st = warm["stats"]
    need((st["hits"], st["tokens_skipped"]) == (3, 40 + 24 + 40),
         f"phase 11d staggered prefix stats: {st}")
    need(warm["streams"] == cold["streams"], "phase 11d: prefix on != off")
    out["prefix on == off"] = f"{st['hits']} hits"
    off = run_checked(cfg, params, "8-bit, kernel off", decode_kernel=False,
                      top2=logs["off"][0], routes=logs["off"][1])
    dense = run_checked(cfg, params, "8-bit, dense", kv_layout="dense")
    need(dense["streams"] == off["streams"], f"phase 11d: 8-bit dense != "
         f"kernel-off streams: {dense['streams']} vs {off['streams']}")
    same = sum(a == b for a, b in zip(on["streams"], off["streams"]))
    k = cfg.experts_per_token

    def routes_of(x, y, tag):
        return expert_switches(prompts, x["streams"], y["streams"],
                               logs[f"{tag}on"][0], logs[f"{tag}off"][0],
                               logs[f"{tag}on"][1], logs[f"{tag}off"][1], k)
    q_routes = routes_of(on, off, "")
    del params
    torch.cuda.empty_cache()
    fcfg = cfg.replace(quant=FP32)
    fparams = M.init_params(fcfg, torch.Generator(device="cuda").manual_seed(
        seed), "cuda")
    logs.update({r: ({}, []) for r in ("f32on", "f32off")})
    fon = run_checked(fcfg, fparams, "f32 weights, kernel on",
                      top2=logs["f32on"][0], routes=logs["f32on"][1])
    for what, extra in {"kernel off": dict(decode_kernel=False,
                                           top2=logs["f32off"][0],
                                           routes=logs["f32off"][1]),
                        "dense layout": dict(kv_layout="dense")}.items():
        run = run_checked(fcfg, fparams, f"f32 weights, {what}", **extra)
        need(run["streams"] == fon["streams"], f"phase 11d: f32-weight "
             f"{what} != kernel-on streams: {run['streams']} vs "
             f"{fon['streams']}")
        if what == "kernel off":
            f_routes = routes_of(fon, run, "f32")
    need(f_routes["d_max"] < F32_ROUTE_EPS and not f_routes["switches"],
         f"phase 11d: f32-weight routes: {f_routes}")
    del fparams
    torch.cuda.empty_cache()
    print(f"phase 11d qwen3-moe-30b-a3b streams (full width, 2 layers, f32, "
          f"capacity_factor {cfg.moe_capacity_factor}: no drops): 8-bit "
          f"weights with the decode kernel: paged == "
          + "; ".join(f"{k}: {v}" for k, v in out.items())
          + f"; through the gather oracle: paged == dense layout; f32 "
          f"weights: decode kernel on == off == dense layout; 8-bit "
          f"kernel on vs off: {same} of {len(prompts)} streams equal; "
          f"router log-probabilities of the two routes within "
          f"{f_routes['d_max']:.3g} at f32 weights and "
          f"{q_routes['d_max']:.3g} at 8 bits (limits {F32_ROUTE_EPS}, "
          f"{ROUTE_MOVE_EPS}; {q_routes['rows']} rows); "
          f"{len(q_routes['switches'])} top-{k} expert switches at 8 bits"
          + "".join(f"; {w}" for w in q_routes["switches"]
                    + q_routes["partings"]))
    return dict(out, routes_equal=same, requests=len(prompts),
                f32_routes=f_routes, routes=q_routes)



# ---------------------------------------------------------------------------
# phase 12: the recurrent mixers; xlstm-1.3b at full width, and
# jamba-1.5-large-398b at full width for one period
# ---------------------------------------------------------------------------

# 12b: a bf16 block with 8-bit weights against its plain f32 version (the
# same 8-bit weights, f32 activations, run on the CPU, where every linear
# takes bramac_matmul's plain version).  bf16 rounds every activation, and
# each rounding that moves an input of a linear across an 8-bit
# quantization edge (a step of 1/127 of its row's max) moves the output by
# a whole step; mLSTM's normalizer max(|q.n|, exp(-m)) amplifies that.  On
# the CPU (seeds 0-3 and 12-14, d = 512 and 2048) the max abs difference
# was 2-9% of the max |output| (17% once at d = 256) and the mean 2.5-5%
# of the mean |output|
BLOCK_RTOL_MAX, BLOCK_RTOL_MEAN = 0.2, 0.08


def _mixers():
    """name -> (arch, init, sequence, step, init_state, linears per call)"""
    from repro_torch.models import mamba as mb
    from repro_torch.models import xlstm as xl
    return {
        "mLSTM": ("xlstm-1.3b", xl.init_mlstm, xl.mlstm_sequence,
                  xl.mlstm_step, lambda c, B: xl.init_mlstm_state(c, B,
                                                                  "cuda"), 5),
        "sLSTM": ("xlstm-1.3b", xl.init_slstm, xl.slstm_sequence,
                  xl.slstm_step, lambda c, B: xl.init_slstm_state(c, B,
                                                                  "cuda"), 3),
        "mamba": ("jamba-1.5-large-398b", mb.init_mamba, mb.mamba_sequence,
                  mb.mamba_step, lambda c, B: mb.init_mamba_state(
                      c, B, c.compute_dtype, "cuda"), 2)}


def block_check(name, cfg, seed=12, S=32, chunk=8):
    """12b for one mixer at `cfg`'s width: (1) at f32 on float weights,
    `*_sequence` in chunks of `chunk` equals `*_step` taken S times, output
    and final state within the reference's rtol = atol = 2e-4
    (tests/test_model_invariants.py); (2) in bf16 with 8-bit weights (every
    servable linear through `bramac_matmul`, its launches counted), the
    sequence is within BLOCK_RTOL_MAX of the max and BLOCK_RTOL_MEAN of
    the mean output of its plain f32 version: the same 8-bit weights and
    f32 activations on the CPU, where no kernel runs.  The difference from
    f32 on the dequantized weights (no activation rounding) is printed
    beside it."""
    from repro_torch.core.bramac_linear import FP32, QuantConfig, \
        tree_prepare_serving
    from repro_torch.core.quant import QuantizedTensor
    from repro_torch.tree import tree_leaves, tree_map
    _, init, seq, step, state0, n_lin = _mixers()[name]
    q8 = QuantConfig(enabled=True, bits_w=8, bits_a=8)
    f32 = cfg.replace(dtype="float32", quant=FP32, chunk_size=chunk)
    p32 = init(torch.Generator(device="cuda").manual_seed(seed), f32, "cuda")
    x = torch.randn((2, S, cfg.d_model),
                    generator=torch.Generator(device="cuda").manual_seed(seed),
                    device="cuda")
    a, sa = seq(p32, x, f32)
    st, outs = state0(f32, 2), []
    for t in range(S):
        o, st = step(p32, x[:, t:t + 1], f32, st)
        outs.append(o)
    pairs = [(a, torch.cat(outs, dim=1))] + list(zip(tree_leaves(sa),
                                                     tree_leaves(st)))
    seq_err = max((u - v).abs().max().item() for u, v in pairs)
    need(all(bool(torch.allclose(u, v, rtol=2e-4, atol=2e-4))
             for u, v in pairs),
         f"phase 12b {name}: sequence != steps (max abs diff {seq_err})")
    del p32
    bf = cfg.replace(quant=q8)
    q = tree_prepare_serving(init(torch.Generator(device="cuda").manual_seed(
        seed), bf, "cuda"), q8)
    on_cpu = {k: v.map(lambda t: t.cpu()) if isinstance(v, QuantizedTensor)
              else tree_map(lambda t: t.float().cpu(), v)
              for k, v in q.items()}
    deq = {k: (v.dequantize() if isinstance(v, QuantizedTensor)
               else tree_map(lambda t: t.float(), v)) for k, v in q.items()}
    xb = x[:, :16].to(torch.bfloat16)
    _zero_counts()
    y, _ = seq(q, xb, bf)
    torch.cuda.synchronize()
    launches = _read_counts()["bramac_matmul"]
    f32 = f32.replace(chunk_size=cfg.chunk_size)
    _zero_counts()
    ref, _ = seq(on_cpu, xb.float().cpu(), f32.replace(quant=q8))
    need(_read_counts()["bramac_matmul"] == 0,
         f"phase 12b {name}: the plain reference launched the kernel")
    ref = ref.cuda()
    deq_ref, _ = seq(deq, xb.float(), f32)
    diff = (y.float() - ref).abs()
    err, mean_err = diff.max().item(), diff.mean().item()
    scale, mean = ref.abs().max().item(), ref.abs().mean().item()
    need(launches == n_lin, f"phase 12b {name}: {launches} bramac_matmul "
         f"launches, not {n_lin}")
    need(bool(torch.isfinite(y).all()) and err <= BLOCK_RTOL_MAX * scale
         and mean_err <= BLOCK_RTOL_MEAN * mean,
         f"phase 12b {name}: bf16 8-bit vs f32 max abs err {err} (max |ref| "
         f"{scale}), mean {mean_err} (mean |ref| {mean})")
    return dict(seq_vs_step=seq_err, err=err, ref_max=scale,
                mean_err=mean_err, ref_mean=mean,
                deq_err=(y.float() - deq_ref).abs().max().item(),
                launches=launches)


def phase_recurrent(report):
    """Phase 12: (a) bramac_matmul at the recurrent mixers' shapes (run in
    phase 2), (b) one full-width block of each mixer, (c) xlstm-1.3b served
    at full width, (d) jamba-1.5-large-398b at full width for one period,
    (e) stream identities and slot reuse at 2 periods of the smoke widths."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    for name, (arch, *_rest) in _mixers().items():
        r = out[name] = block_check(name, get_config(arch))
        print(f"phase 12b {name} block at full width ({arch}, d="
              f"{get_config(arch).d_model}): sequence (chunks of 8) vs 32 "
              f"steps at f32 max abs diff {r['seq_vs_step']:.3g} (rtol = "
              f"atol = 2e-4); bf16 with 8-bit weights ({r['launches']} "
              f"bramac_matmul launches) vs its plain f32 version (the CPU, "
              f"no kernel): max abs "
              f"err {r['err']:.4g} of max |ref| {r['ref_max']:.4g} (limit "
              f"{BLOCK_RTOL_MAX} x), mean {r['mean_err']:.4g} of "
              f"{r['ref_mean']:.4g} (limit {BLOCK_RTOL_MEAN} x); vs f32 on "
              f"the dequantized weights max abs {r['deq_err']:.4g}")
        gc.collect()
        torch.cuda.empty_cache()
    report["recurrent_blocks"] = out
    phase_xlstm_serve(report)
    phase_jamba_serve(report)
    report["recurrent_streams"] = phase_recurrent_streams()
    spent = time.perf_counter() - t_phase
    report["phase12_s"] = spent
    print(f"phase 12 took {spent:.1f} s")


def _recurrent_launches(cfg) -> int:
    """bramac_matmul launches of one forward: 5 per mLSTM layer (w_up, wq,
    wk, wv, w_down), 3 per sLSTM (w_gates, w_up, w_down), 2 per mamba
    (w_in, w_out), 4 per attention layer, 3 per dense FF, 3 x E per MoE
    FF, and the unembed."""
    per = {"mlstm": 5, "slstm": 3, "mamba": 2, "attn": 4, "dense": 3,
           "moe": 3 * cfg.num_experts, "none": 0}
    return cfg.n_periods * sum(per[m] + per[f] for m, f in (
        spec.split("+") for spec in cfg.layer_pattern)) + 1


def phase_xlstm_serve(report):
    """12c: xlstm-1.3b at full width (48 layers, d=2048, bf16, 8-bit
    weights quantized period by period as drawn, random from seed 0) on
    phase 5's traffic: 8 requests of 17-120 tokens, 16 new tokens, 4
    slots, max_seq 256, greedy, paged.  Prompts prefill one token per
    forward; bramac_matmul launches 229 times per forward and no decode
    kernel launches (no attention layer).  Streams are equal under the
    dense layout, and with the prefix cache and speculation requested
    (both opt out); then a device-only profile."""
    from repro_torch.configs import get_config
    from repro_torch.core.bramac_linear import QuantConfig
    from repro_torch.core.quant import QuantizedTensor
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    q8 = QuantConfig(enabled=True, bits_w=8, bits_a=8)
    cfg = get_config("xlstm-1.3b").replace(quant=q8)
    need((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.vocab_size,
          cfg.layer_pattern, cfg.dtype) ==
         (48, 2048, 4, 50304, ("mlstm+none",) * 7 + ("slstm+none",),
          "bfloat16"), "xlstm-1.3b config")
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda", serving=q8)
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated() / 1e9
    leaves = tree_leaves(params)
    int8_b = sum(t.values.numel() for t in leaves
                 if isinstance(t, QuantizedTensor))
    float_b = sum(t.numel() * t.element_size() for t in leaves
                  if isinstance(t, torch.Tensor))
    n_params = sum(t.values.numel() * (2 if t.packed else 1)
                   if isinstance(t, QuantizedTensor) else t.numel()
                   for t in leaves)
    print(f"  xlstm-1.3b params built and quantized one period at a time in "
          f"{time.perf_counter() - t0:.1f} s: {n_params / 1e9:.3f} B "
          f"parameters ({cfg.param_count() / 1e9:.3f} B by param_count()), "
          f"{int8_b / 1e9:.2f} GB int8 + {float_b / 1e9:.2f} GB float "
          f"(embedding, norms, gates, sLSTM r_gates); build peak "
          f"{build_peak:.2f} GB")
    prompts = _phase5_prompts(cfg.vocab_size)
    per_fwd = _recurrent_launches(cfg)
    need(per_fwd == 229, f"xlstm launches per forward {per_fwd}")
    serve(cfg, params, [prompts[0][:5]], 2)                 # warm-up
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    run = serve(cfg, params, prompts, 16)
    got = _read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    need(run["done"] == 8 and all(
        len(s) == 16 and all(0 <= t < cfg.vocab_size for t in s)
        for s in run["streams"]), "phase 12c: streams")
    need(run["prefill_chunk"] == 1 and
         run["admits"] >= max(len(p) for p in prompts),
         f"phase 12c: prefill chunk {run['prefill_chunk']}, {run['admits']} "
         f"admission forwards")
    need(got["bramac_matmul"] == per_fwd * run["forwards"] and
         got["paged_decode"] == got["paged_decode_q"] == 0,
         f"phase 12c: launches {got} for {run['forwards']} forwards")
    need(run["drained"], "phase 12c: the pool kept pages")
    report["bramac_matmul"]["launches"] += got["bramac_matmul"]
    ttft = 1e3 * float(np.mean(run["ttft"]))
    print(f"phase 12c serve xlstm-1.3b (full width, 48 layers): "
          f"{run['done']}/8 requests, {run['tokens']} tokens in "
          f"{run['wall']:.2f} s ({run['tokens'] / run['wall']:.2f} tok/s), "
          f"mean TTFT {ttft:.1f} ms, peak memory {peak:.2f} GB, "
          f"{run['forwards']} forwards ({run['admits']} one-token admission "
          f"forwards, {run['steps']} decode steps; "
          f"{run['wall'] / run['forwards'] * 1e3:.1f} ms each), launches "
          f"{got} (= {per_fwd} x forwards)")
    same = {}
    for what, extra in {"dense layout": dict(kv_layout="dense"),
                        "prefix cache and speculation requested": dict(
                            prefix_cache=True, draft_len=4)}.items():
        other = serve(cfg, params, prompts, 16, **extra)
        need(other["streams"] == run["streams"],
             f"phase 12c: {what} streams != paged: {other['streams']} vs "
             f"{run['streams']}")
        need(not other["prefix_on"] and other["spec"]["drafted"] == 0
             and other["spec"]["drafter"] is None,
             f"phase 12c ({what}): prefix {other['prefix_on']}, "
             f"{other['spec']}")
        same[what] = other["tokens"] / other["wall"]
    print(f"  streams equal: paged == " + " == ".join(same) + " (tok/s "
          + ", ".join(f"{v:.2f}" for v in same.values()) + ")")
    prof = profile_serve(cfg, params, [prompts[0][:16]], new_tokens=4,
                         label="phase 12c profile xlstm-1.3b", host_ops=False)
    report["xlstm"] = dict(tok_s=run["tokens"] / run["wall"], ttft_ms=ttft,
                           wall_s=run["wall"], peak_gb=peak,
                           build_peak_gb=build_peak,
                           forwards=run["forwards"], admits=run["admits"],
                           steps=run["steps"], launches=got,
                           launches_per_forward=per_fwd,
                           params_b=n_params / 1e9, int8_gb=int8_b / 1e9,
                           other_tok_s=same, profile=prof)
    del params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 12c took {time.perf_counter() - t0:.1f} s")


def phase_jamba_serve(report):
    """12d: jamba-1.5-large-398b at full width (d=8192, 64/8 heads, mamba
    d_inner 16384, 16 experts top-2 of d_ff 24576), cut to one period (8 of
    its 72 layers: 7 mamba + 1 attention, 4 MoE + 4 dense FFs), 8-bit
    weights quantized as drawn, random from seed 0.  Phase 5's first 4
    prompts x 8 new tokens, bf16 and int8 KV: the decode kernel of the
    KV dtype once per decode step (one attention layer), bramac_matmul 223
    times per forward."""
    from repro_torch.configs import get_config
    from repro_torch.core.bramac_linear import QuantConfig
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    q8 = QuantConfig(enabled=True, bits_w=8, bits_a=8)
    full = get_config("jamba-1.5-large-398b")
    cfg = full.replace(num_layers=8, quant=q8)
    need((full.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
          cfg.num_experts, cfg.experts_per_token, cfg.expert_d_ff, cfg.d_ff,
          cfg.mamba_expand * cfg.d_model, cfg.vocab_size, cfg.dtype) ==
         (72, 8192, 64, 8, 16, 2, 24576, 24576, 16384, 65536, "bfloat16"),
         "jamba-1.5-large-398b config")
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda", serving=q8)
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated() / 1e9 - base
    resident = torch.cuda.memory_allocated() / 1e9 - base
    print(f"  jamba-1.5-large-398b one period (8 of 72 layers) built and "
          f"quantized block by block in {time.perf_counter() - t0:.1f} s: "
          f"{resident:.2f} GB resident, {build_peak:.2f} GB peak during the "
          f"draw")
    prompts = _phase5_prompts(cfg.vocab_size)[:4]
    per_fwd = _recurrent_launches(cfg)
    need(per_fwd == 223, f"jamba launches per forward {per_fwd}")
    serve(cfg, params, [prompts[0][:5]], 2)                 # warm-up
    runs = {}
    for quant_kv in (False, True):
        c = cfg.replace(quant_kv=quant_kv)
        kv = "int8" if quant_kv else "bf16"
        attn = "paged_decode_q" if quant_kv else "paged_decode"
        other = "paged_decode" if quant_kv else "paged_decode_q"
        _zero_counts()
        torch.cuda.reset_peak_memory_stats()
        run = serve(c, params, prompts, 8)
        got = _read_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        need(run["done"] == 4 and all(
            len(s) == 8 and all(0 <= t < cfg.vocab_size for t in s)
            for s in run["streams"]), f"phase 12d ({kv} KV): streams")
        need(run["prefill_chunk"] == 1, "phase 12d: prefill chunk")
        need(got["bramac_matmul"] == per_fwd * run["forwards"],
             f"phase 12d ({kv} KV): bramac_matmul launches "
             f"{got['bramac_matmul']} != {per_fwd} x {run['forwards']}")
        need(got[attn] == run["steps"] > 0 and got[other] == 0,
             f"phase 12d ({kv} KV): decode kernel launches {got} for "
             f"{run['steps']} steps")
        need(run["drained"], f"phase 12d ({kv} KV): a pool kept pages")
        for k, n in got.items():
            report[k]["launches"] += n
        ttft = 1e3 * float(np.mean(run["ttft"]))
        runs[kv] = dict(tok_s=run["tokens"] / run["wall"], ttft_ms=ttft,
                        wall_s=run["wall"], peak_gb=peak,
                        forwards=run["forwards"], steps=run["steps"],
                        launches=got)
        print(f"phase 12d serve jamba-1.5-large-398b (full width, one period:"
              f" 8 of 72 layers) {kv} KV: {run['done']}/4 requests, "
              f"{run['tokens']} tokens in {run['wall']:.2f} s "
              f"({run['tokens'] / run['wall']:.2f} tok/s), mean TTFT "
              f"{ttft:.1f} ms, peak memory {peak:.2f} GB, {run['forwards']} "
              f"forwards ({run['wall'] / run['forwards'] * 1e3:.1f} ms each), "
              f"launches {got} (= {per_fwd} x forwards and 1 x "
              f"{run['steps']} steps)")
    report["jamba"] = dict(runs, resident_gb=resident, build_peak_gb=build_peak,
                           launches_per_forward=per_fwd)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 12d took {time.perf_counter() - t0:.1f} s")


def phase_recurrent_streams(seed=5):
    """12e at 2 periods of the smoke widths, f32.  jamba-1.5-large-398b on
    f32 weights: greedy streams with the decode kernel == through the
    gather oracle == the dense layout; on 8-bit weights: kernel off ==
    dense (one attention route), and kernel on == off, where a stream may
    part only as phase 11d allows across the two routes (`expert_switches`:
    after an expert switch in its own row, or by a swap of its top two
    tokens).  A reused slot starts from the init state:
    a request served after another in the engine's only slot streams as on
    a fresh engine (jamba and xlstm-1.3b, 8-bit, decode kernel on)."""
    from repro_torch.configs import get_config
    from repro_torch.core.bramac_linear import QuantConfig, \
        tree_prepare_serving
    from repro_torch.models import model as M
    q8 = QuantConfig(enabled=True, bits_w=8, bits_a=8)
    rng = np.random.default_rng(seed)
    out = {}
    cfg = get_config("jamba-1.5-large-398b", smoke=True).replace(
        num_layers=16)
    need(cfg.dtype == "float32", "jamba smoke config")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), "cuda")
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n))
               for n in (15, 16, 17, 33, 5, 48)]
    kw = dict(num_slots=3, max_seq=96)
    _zero_counts()
    on = serve(cfg, params, prompts, 12, **kw)
    got = _read_counts()
    need(got["paged_decode"] == cfg.n_periods * on["steps"] > 0,
         f"phase 12e: decode kernel launches {got}")
    for what, extra in {"kernel off": dict(decode_kernel=False),
                        "dense": dict(kv_layout="dense")}.items():
        run = serve(cfg, params, prompts, 12, **kw, **extra)
        need(run["streams"] == on["streams"], f"phase 12e: jamba f32 {what} "
             f"!= kernel on: {run['streams']} vs {on['streams']}")
    out["jamba f32"] = "kernel on == off == dense"
    cq = cfg.replace(quant=q8)
    qp = tree_prepare_serving(params, q8)
    logs = {r: ({}, []) for r in ("on", "off")}
    off = serve(cq, qp, prompts, 12, decode_kernel=False, top2=logs["off"][0],
                routes=logs["off"][1], **kw)
    dense = serve(cq, qp, prompts, 12, kv_layout="dense", **kw)
    need(off["streams"] == dense["streams"],
         f"phase 12e: jamba 8-bit dense != kernel off")
    qon = serve(cq, qp, prompts, 12, top2=logs["on"][0],
                routes=logs["on"][1], **kw)
    n_eq = sum(a == b for a, b in zip(qon["streams"], off["streams"]))
    routes = expert_switches(prompts, qon["streams"], off["streams"],
                             logs["on"][0], logs["off"][0], logs["on"][1],
                             logs["off"][1], cq.experts_per_token, "12e")
    out["jamba 8-bit"] = (
        f"kernel off == dense; kernel on == off in {n_eq} of {len(prompts)} "
        f"streams (router log-probabilities within {routes['d_max']:.3g}, "
        f"limit {ROUTE_MOVE_EPS}, {routes['rows']} rows; "
        f"{len(routes['switches'])} expert switches"
        + "".join(f"; {w}" for w in routes["switches"] + routes["partings"])
        + ")")
    out["jamba 8-bit routes"] = routes
    del params
    xcfg = get_config("xlstm-1.3b", smoke=True).replace(num_layers=16,
                                                         quant=q8)
    xp = tree_prepare_serving(M.init_params(
        xcfg, torch.Generator(device="cuda").manual_seed(seed), "cuda"), q8)
    for name, c, p in (("jamba", cq, qp), ("xlstm", xcfg, xp)):
        first, second = prompts[5], prompts[3]
        reuse = serve(c, p, [first, second], 12, num_slots=1, max_seq=96)
        fresh = serve(c, p, [second], 12, num_slots=1, max_seq=96)
        need(reuse["streams"][1] == fresh["streams"][0],
             f"phase 12e {name}: the slot's second occupant streams "
             f"{reuse['streams'][1]}, a fresh engine {fresh['streams'][0]}")
        out[f"{name} slot reuse"] = "second occupant == fresh engine"
    print("phase 12e recurrent streams (2 periods of the smoke widths, f32): "
          + "; ".join(f"{k}: {v}" for k, v in out.items()
                      if isinstance(v, str)))
    return out


# ---------------------------------------------------------------------------
# phase 6: kernel-on == kernel-off greedy streams (f32, full width)
# ---------------------------------------------------------------------------

def phase_streams():
    from repro_torch.configs import get_config
    from repro_torch.core.bramac_linear import QuantConfig, \
        tree_prepare_serving
    from repro_torch.models import model as M
    # f32 is the dtype the reference holds this contract in: at bf16 the
    # gather oracle's attention rounds scores and probabilities to bf16
    # (repro/models/attention.py:164,171) while the kernels stay in fp32,
    # so bf16 stream identity is not a contract
    t_phase = time.perf_counter()
    q8 = QuantConfig(enabled=True, bits_w=8, bits_a=8)
    cfg = get_config("granite-8b").replace(num_layers=2, dtype="float32",
                                           quant=q8)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = tree_prepare_serving(M.init_params(cfg, gen, "cuda"), q8)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n))
               for n in (15, 16, 17, 33, 5, 48)]
    # staggered prompts sharing a 44-token stem: at prefix_chunk 8 a warm
    # match ends at 40 rows, mid-page (2 shared pages + a copy-on-write
    # page); the third leaves the stem after 30 tokens (match 24: 1 shared
    # page + a copy-on-write page)
    stem = rng.integers(0, cfg.vocab_size, size=44)
    tail = lambda n: rng.integers(0, cfg.vocab_size, size=n)  # noqa: E731
    staggered_prompts = [np.concatenate([stem, tail(5)]),
                         np.concatenate([stem, tail(9)]),
                         np.concatenate([stem[:30], tail(7)]),
                         np.concatenate([stem, tail(3)])]
    for quant_kv in (False, True):
        c = cfg.replace(quant_kv=quant_kv)
        kv = "int8" if quant_kv else "fp"
        _zero_counts()
        run = serve(c, params, prompts, 12, decode_kernel=True, num_slots=3,
                    max_seq=96)
        on, got = run["streams"], _read_counts()
        attn = "paged_decode_q" if quant_kv else "paged_decode"
        need(got[attn] == run["steps"] * cfg.num_layers,
             f"paged serve ({kv} KV): decode launches {got}")
        off = serve(c, params, prompts, 12, decode_kernel=False, num_slots=3,
                    max_seq=96)["streams"]
        need(on == off, f"kernel-on != kernel-off streams ({kv} KV): {on} "
             f"vs {off}")
        _zero_counts()
        dense = serve(c, params, prompts, 12, num_slots=3, max_seq=96,
                      kv_layout="dense")["streams"]
        got = _read_counts()
        need(got["paged_decode"] == got["paged_decode_q"] == 0,
             f"dense serve ({kv} KV) launched a decode kernel: {got}")
        need(dense == on, f"dense != paged kernel-on streams ({kv} KV): "
             f"{dense} vs {on}")
        warm = staggered(c, params, staggered_prompts, prefix_cache=True)
        cold = staggered(c, params, staggered_prompts, prefix_cache=False)
        st = warm["stats"]
        need((st["hits"], st["tokens_skipped"]) == (3, 40 + 24 + 40),
             f"staggered prefix stats ({kv} KV): {st}")
        need(warm["launches"][attn] == warm["steps"] * cfg.num_layers,
             f"prefix serve ({kv} KV): decode launches {warm['launches']}")
        need(warm["streams"] == cold["streams"],
             f"prefix on != off streams ({kv} KV): {warm['streams']} vs "
             f"{cold['streams']}")
        _zero_counts()
        dis = serve(c, params, prompts, 12, decode_kernel=True, num_slots=3,
                    max_seq=96, disagg=True, check_invariants=True)
        got = _read_counts()
        need(dis["streams"] == on, f"disaggregated != colocated kernel-on "
             f"streams ({kv} KV): {dis['streams']} vs {on}")
        need(got[attn] == dis["steps"] * cfg.num_layers and dis["drained"]
             and dis["transfer_checks"] == dis["disagg"]["transfer_rounds"]
             > 0, f"disaggregated serve ({kv} KV): launches {got}, "
             f"{dis['disagg']}")
        spec = spec_streams(c, params, prompts, off)
        print(f"  phase 6 speculation ({kv} KV, draft_len 4): streams equal "
              f"the non-speculative ones in {len(spec)} serves; "
              + "; ".join(f"{k}: {v['accepted']}/{v['drafted']} accepted, "
                          f"{v['ticks']} ticks, {v['launches']} matmul "
                          f"launches" for k, v in spec.items()))
    rej = spec_page_boundary(cfg, params)
    print(f"  phase 6 mid-window rejection across a page boundary (fp KV): "
          + "; ".join(f"{k}: {v}" for k, v in rej.items()))
    del params
    mla = streams_mla(prompt_lens=[len(p) for p in prompts])
    print(f"  phase 6 minicpm3-4b (MLA, full width, 2 layers, f32): {mla}")
    print("phase 6 streams: kernel-on == kernel-off == dense-layout greedy "
          "streams at full width, 2 layers, f32 (fp KV and int8 KV; 6 "
          "requests, 3 slots; no decode kernel launch on the dense serves); "
          "prefix cache on == off over 4 staggered prompts (3 hits, 2 "
          "shared pages + copy-on-write mid-page, invariants checked after "
          "every sync); speculation (draft_len 4, n-gram and 2-bit model "
          "drafters, paged with the prefix cache on and off, dense) == "
          "no speculation, a rejected window across a page boundary rolled "
          "back; disaggregated == colocated with the decode kernels on; "
          "minicpm3-4b paged == dense, prefix on == off, n-gram "
          "speculation == off, disaggregated == colocated; "
          f"{time.perf_counter() - t_phase:.1f} s")


def streams_mla(prompt_lens):
    """Phase 6 for MLA: minicpm3-4b at full width, 2 layers, f32, 8-bit
    weights.  Greedy streams paged (decode kernels requested, never
    launched) == dense == paged with n-gram speculation == disaggregated
    (invariant and I7 checks on); staggered prompts with the prefix cache
    on == off (3 hits, copy-on-write mid-page)."""
    from repro_torch.configs import get_config
    from repro_torch.core.bramac_linear import QuantConfig, \
        tree_prepare_serving
    from repro_torch.models import model as M
    q8 = QuantConfig(enabled=True, bits_w=8, bits_a=8)
    cfg = get_config("minicpm3-4b").replace(num_layers=2, dtype="float32",
                                            quant=q8)
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = tree_prepare_serving(M.init_params(cfg, gen, "cuda"), q8)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in prompt_lens]
    stem = rng.integers(0, cfg.vocab_size, size=44)
    tail = lambda n: rng.integers(0, cfg.vocab_size, size=n)  # noqa: E731
    stag = [np.concatenate([stem, tail(5)]), np.concatenate([stem, tail(9)]),
            np.concatenate([stem[:30], tail(7)]),
            np.concatenate([stem, tail(3)])]
    kw = dict(num_slots=3, max_seq=96)
    def no_decode_kernel(what):
        got = _read_counts()
        need(got["paged_decode"] == got["paged_decode_q"] == 0
             and got["bramac_matmul"] > 0,
             f"minicpm3-4b {what}: launches {got}")

    _zero_counts()
    top_paged = {}
    paged = serve(cfg, params, prompts, 12, decode_kernel=True,
                  top2=top_paged, **kw)
    no_decode_kernel("paged")
    runs = {"dense": dict(kv_layout="dense"),
            "n-gram speculation": dict(draft_len=4, drafter="ngram",
                                       prefix_cache=True,
                                       check_invariants=True),
            "disaggregated": dict(disagg=True, check_invariants=True)}
    out = {}
    for what, extra in runs.items():
        _zero_counts()
        top = {}
        run = serve(cfg, params, prompts, 12, top2=top, **kw, **extra)
        no_decode_kernel(what)
        if what == "n-gram speculation":
            # the verify window (Sq = 5) against the decode step (Sq = 1):
            # equal streams, or a swap of a near tie's top two (see
            # same_or_near_tie)
            swaps = same_or_near_tie(prompts, paged["streams"],
                                     run["streams"], top_paged, top,
                                     f"minicpm3-4b {what}")
        else:
            swaps = []
            need(run["streams"] == paged["streams"], f"minicpm3-4b {what} "
                 f"!= paged streams: {run['streams']} vs {paged['streams']}")
        if what == "disaggregated":
            need(run["drained"] and run["transfer_checks"] ==
                 run["disagg"]["transfer_rounds"] > 0,
                 f"minicpm3-4b disaggregated: {run['disagg']}")
            out[what] = f"{run['disagg']['pages_transferred']} pages moved"
        elif what == "n-gram speculation":
            need(run["spec"]["drafted"] > 0, "minicpm3-4b: nothing drafted")
            out[what] = (f"{run['spec']['accepted']}/"
                         f"{run['spec']['drafted']} accepted, streams "
                         f"equal" + (f" up to {len(swaps)} near-tie "
                                     f"swap(s) ({', '.join(swaps)})"
                                     if swaps else ""))
        else:
            out[what] = "equal"
    warm = staggered(cfg, params, stag, prefix_cache=True)
    cold = staggered(cfg, params, stag, prefix_cache=False)
    st = warm["stats"]
    need((st["hits"], st["tokens_skipped"]) == (3, 40 + 24 + 40),
         f"minicpm3-4b staggered prefix stats: {st}")
    need(warm["streams"] == cold["streams"], "minicpm3-4b prefix on != off")
    for run in (warm, cold):
        need(run["launches"]["paged_decode"] ==
             run["launches"]["paged_decode_q"] == 0,
             f"minicpm3-4b prefix serve launches {run['launches']}")
    out["prefix on == off"] = f"{st['hits']} hits"
    out["structured weights"] = mla_structured_spec(cfg, params, q8)
    del params
    torch.cuda.empty_cache()
    return "; ".join(f"{k}: {v}" for k, v in out.items())


def mla_structured_spec(cfg, params, q8):
    """The exact check beside the near-tie-tolerant one above: minicpm3-4b
    on integer-exact structured weights (`structured_params`), where the
    greedy stream is t -> t+1, served without speculation and with the
    n-gram and the 2-bit model drafters; the streams must be equal."""
    sparams = structured_params(cfg, params, q8)
    prompts = [[1, 2, 3], [700, 5, 9, 11, 40], list(range(100, 120))]
    expect = [[(p[-1] + 1 + i) % cfg.d_model for i in range(16)]
              for p in prompts]
    out = []
    for kind in ("none", "ngram", "model"):
        kw = {} if kind == "none" else dict(draft_len=4, drafter=kind,
                                            draft_bits=2)
        run = serve(cfg, sparams, prompts, 16, num_slots=3, max_seq=64, **kw)
        need(run["streams"] == expect, f"minicpm3-4b structured ({kind}): "
             f"streams {run['streams']} != t+1")
        if kind != "none":
            need(run["spec"]["drafted"] > 0,
                 f"minicpm3-4b structured ({kind}): nothing drafted")
            out.append(f"{kind} {run['spec']['accepted']}/"
                       f"{run['spec']['drafted']} accepted")
    del sparams
    return ("speculation on == off exactly, t -> t+1 (" + ", ".join(out)
            + ")")


def spec_streams(cfg, params, prompts, want):
    """Speculation on == off (phase 6): draft_len 4 with the n-gram drafter
    (paged with the prefix cache on and off, dense) and the 2-bit model
    drafter (paged, which turns the prefix cache off, and dense); greedy
    streams must equal `want`, the non-speculative streams read through
    the gather oracle as the verify window reads (the reference's contract:
    it turns the decode kernel off under speculation), no decode kernel may
    launch, and bramac_matmul must launch exactly the derived count."""
    out = {}
    for drafter in ("ngram", "model"):
        layouts = (("paged", True), ("paged", False), ("dense", False)) \
            if drafter == "ngram" else (("paged", False), ("dense", False))
        for layout, prefix in layouts:
            what = f"{drafter} {layout}{' prefix' if prefix else ''}"
            _zero_counts()
            run = serve(cfg, params, prompts, 12, num_slots=3, max_seq=96,
                        kv_layout=layout, prefix_cache=prefix, draft_len=4,
                        drafter=drafter, draft_bits=2)
            got = _read_counts()
            need(run["streams"] == want, f"speculation ({what}) != off "
                 f"streams: {run['streams']} vs {want}")
            need(got["paged_decode"] == got["paged_decode_q"] == 0,
                 f"speculation ({what}) launched a decode kernel: {got}")
            derived = spec_matmul_launches(
                cfg, run, 4, cfg.num_layers if drafter == "model" else None)
            need(got["bramac_matmul"] == derived,
                 f"speculation ({what}): bramac_matmul launches "
                 f"{got['bramac_matmul']} != derived {derived}")
            need(run["spec"]["drafted"] > 0, f"{what}: nothing drafted")
            out[what] = dict(run["spec"], ticks=run["ticks"],
                             launches=got["bramac_matmul"])
    return out


def spec_page_boundary(cfg, params):
    """A prompt of page_size - 2 tokens: the first window [ps-2 .. ps+2]
    crosses the page-0/page-1 boundary.  With random weights the verify
    rejects mid-window; after the serve the paged pool must equal a
    non-speculative engine's (reading through the gather oracle, as the
    verify window does) within 4e-3 (f32: rows written by the window
    forward and by decode steps may differ where an 8-bit activation
    rounds the other way), and every row the non-speculative pool never
    wrote must be exactly zero (the rejected rows rolled back)."""
    from repro_torch.runtime.serve import Engine
    ps = cfg.page_size
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, ps - 2)
    out = {}
    for drafter in ("ngram", "model"):
        engines = []
        for kw in ({"decode_kernel": False},
                   {"draft_len": 5, "drafter": drafter}):
            eng = Engine(cfg, params, num_slots=1, max_seq=4 * ps,
                         prefix_cache=False, check_invariants=True,
                         device="cuda", **kw)
            r = eng.submit(prompt, ps + 4)
            eng.run()
            engines.append((eng, list(r.out_tokens)))
        (e0, s0), (e1, s1) = engines
        st = e1.spec_stats()
        need(s0 == s1, f"page-boundary serve ({drafter}): streams differ")
        need(st["accepted"] < st["drafted"],
             f"page-boundary serve ({drafter}): no draft rejected")
        err = 0.0
        for i in e0.caches:
            for k in e0.caches[i]:
                a, b = e0.caches[i][k], e1.caches[i][k]
                err = max(err, (a.float() - b.float()).abs().max().item())
                need(bool((b[a == 0] == 0).all()),
                     f"page-boundary serve ({drafter}): a row the "
                     f"non-speculative pool never wrote is not zero ({k})")
        need(err <= 4e-3, f"page-boundary serve ({drafter}): pools differ "
             f"by {err}")
        out[drafter] = (f"{st['accepted']}/{st['drafted']} accepted, pool max "
                        f"abs diff {err:.3g}")
        e0.close()
        e1.close()
    return out


def staggered(cfg, params, prompts, **kw):
    """Prompts submitted one at a time, each served to completion before
    the next arrives (its producer registers before a consumer looks)."""
    from repro_torch.runtime.serve import Engine
    with Engine(cfg, params, num_slots=3, max_seq=96, prefix_chunk=8,
                check_invariants=True, decode_kernel=True, device="cuda",
                **kw) as eng:
        _zero_counts()
        streams = []
        for p in prompts:
            r = eng.submit(p, 12)
            eng.run()
            streams.append(list(r.out_tokens))
        return dict(streams=streams, stats=eng.prefix_stats(),
                    steps=eng.n_ticks * eng.decode_steps,
                    launches=_read_counts())


# ---------------------------------------------------------------------------
# phase 13: training on the card
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 4, 64           # the training launcher's defaults


@contextlib.contextmanager
def plain_matmul():
    """Every quantized matmul of the model through `bramac_matmul_plain` on
    the card (the kernel's launch count does not move)."""
    from repro_torch.kernels import bramac_matmul as bm
    from repro_torch.kernels import ops
    ops.bramac_matmul = bm.bramac_matmul_plain
    try:
        yield
    finally:
        ops.bramac_matmul = bm.bramac_matmul


def _add_launches(report, got):
    for k, n in got.items():
        report.setdefault(k, {}).setdefault("launches", 0)
        report[k]["launches"] += n


def phase_train(report):
    """Phase 13: (a) the QAT `bramac_dense` at granite-8b's training rows,
    (b) granite-8b trained at full width, (c) failure recovery and the
    checkpoint round trip at the smoke widths."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(13)
    report["train_dense"] = phase_train_dense(gen)
    report["train"] = phase_train_granite(report)
    report["train_recovery"] = phase_train_recovery(report)
    spent = time.perf_counter() - t_phase
    report["phase13_s"] = spent
    print(f"phase 13 took {spent:.1f} s")


def phase_train_dense(gen):
    """13a: `ops.bramac_dense` at every granite-8b linear at M = B x S =
    256 rows, 8/8 bits, bf16: the forward equal bit for bit on the kernel
    and on the plain digit-pass version, the straight-through gradients
    equal to the plain products g @ w^T and x^T @ g; the forward timed
    beside its bound (bf16 x and w read once, bf16 y written once; the
    2·M·N·K operations of one int8 product) and bf16 `torch.matmul`."""
    from repro_torch.kernels import ops
    M = TRAIN_B * TRAIN_S
    rows = []
    for name, (K, N) in GRANITE_SHAPES.items():
        x = torch.randn((M, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = (torch.randn((K, N), generator=gen, device="cuda")
             / K ** 0.5).to(torch.bfloat16)
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = ops.bramac_dense(xg, wg, 8, 8)
        with plain_matmul(), torch.no_grad():
            want = ops.bramac_dense(x, w, 8, 8)
        need(torch.equal(y.detach(), want),
             f"13a bramac_dense {name}: kernel forward != plain")
        g = torch.randn((M, N), generator=gen, device="cuda").to(
            torch.bfloat16)
        y.backward(g)
        need(torch.equal(xg.grad, g @ w.T) and torch.equal(wg.grad, x.T @ g),
             f"13a bramac_dense {name}: STE grads != g @ w^T, x^T @ g")
        with torch.no_grad():
            ms = time_cold(lambda: ops.bramac_dense(x, w, 8, 8))
            with plain_matmul():
                plain_ms = time_cold(lambda: ops.bramac_dense(x, w, 8, 8),
                                     iters=5)
            lib_ms = time_cold(lambda: torch.matmul(x, w))
        # bf16 x, w and y each once; one int8 product
        nbytes = 2 * (M * K + K * N + M * N)
        flops = 2 * M * N * K
        bound = max(nbytes / HBM_BYTES_PER_S, flops / INT8_OPS_PER_S) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / INT8_OPS_PER_S \
            else "operations"
        rows.append(dict(shape=name, M=M, K=K, N=N, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by,
                         library="bf16 torch.matmul", library_ms=lib_ms))
        print(f"  bramac_dense {name} M={M} K={K} N={N}: forward {ms:.4f} ms "
              f"(bound {bound:.4f} ms by {by}, plain {plain_ms:.4f} ms, bf16 "
              f"torch.matmul {lib_ms:.4f} ms)")
    print(f"phase 13a bramac_dense: {len(rows)} granite-8b shapes at M={M}, "
          f"forward bit-exact vs plain, STE grads == the plain products")
    return rows


def phase_train_granite(report):
    """13b: granite-8b at full width (36 layers, d=4096, bf16 params, QAT
    8/8 bits, int8 m / bf16 v) takes 4 `Trainer.run_step`s on SyntheticLM
    batches of the launcher's B=4, S=64.  Every loss and grad norm finite,
    bramac_matmul 7 x 36 + 1 = 253 launches per step (the forward; the
    backward's products are plain), and step 1's loss equal bit for bit to
    the same forward through the plain version.  `train` is not called: it
    ends with a checkpoint of the whole state (~40 GB)."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.core.bramac_linear import QuantConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    q8 = QuantConfig(enabled=True, bits_w=8, bits_a=8)
    cfg = get_config("granite-8b").replace(quant=q8)
    need((cfg.num_layers, cfg.d_model, cfg.vocab_size, cfg.dtype) ==
         (36, 4096, 49152, "bfloat16"), "granite-8b config")
    per_step = 7 * cfg.num_layers + 1
    need(per_step == 253, f"granite launches per step {per_step}")
    residue = torch.cuda.memory_allocated()   # earlier phases' leftovers
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"  granite-8b float params drawn in {time.perf_counter() - t0:.1f} "
          f"s ({n_params / 1e9:.2f} B, {2 * n_params / 1e9:.2f} GB bf16)")
    pipe = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B))
    with torch.no_grad(), plain_matmul():
        plain_loss = float(M.loss_fn(params, pipe.batch(0, "cuda"), cfg)[0])
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as d:
        trainer = Trainer(cfg, TrainerConfig(
            ckpt_dir=d, opt=adamw.AdamWConfig(lr=1e-3)), params)
        state_gb = torch.cuda.memory_allocated() / 1e9
        hist, times, launches = [], [], []
        for step in range(4):
            batch = pipe.batch(step, "cuda")
            _zero_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            hist.append(trainer.run_step(batch))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            launches.append(_read_counts())
        parts = train_step_parts(trainer, pipe.batch(4, "cuda"))
    peak = torch.cuda.max_memory_allocated() / 1e9
    for h in hist:
        need(all(np.isfinite(h[k]) for k in ("loss", "ce", "grad_norm")),
             f"13b: a non-finite metric {h}")
    for got in launches:
        need(got["bramac_matmul"] == per_step and got["paged_decode"] == 0
             == got["paged_decode_q"], f"13b: launches {got} per step")
        _add_launches(report, got)
    need(hist[0]["loss"] == plain_loss,
         f"13b: step 1's loss {hist[0]['loss']!r} on the kernel != "
         f"{plain_loss!r} on the plain version")
    step_ms = 1e3 * float(np.mean(times[1:]))
    tok_s = TRAIN_B * TRAIN_S / (step_ms / 1e3)
    print(f"phase 13b train granite-8b full width (36 layers, QAT 8/8, int8 m "
          f"/ bf16 v, B={TRAIN_B} S={TRAIN_S}): losses "
          f"{[round(h['loss'], 4) for h in hist]}, grad norms "
          f"{[round(h['grad_norm'], 3) for h in hist]}; step 1's loss == the "
          f"plain version's ({plain_loss!r}); {step_ms:.1f} ms per step "
          f"(steps 2-4; step 1 {1e3 * times[0]:.1f} ms), {tok_s:.1f} training "
          f"tokens/s; params + grads-free optimizer state {state_gb:.2f} GB, "
          f"peak memory {peak:.2f} GB; bramac_matmul {per_step} launches per "
          f"step; a fifth step split: {parts}")
    del trainer, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=[h["loss"] for h in hist],
                grad_norms=[h["grad_norm"] for h in hist], step_ms=step_ms,
                first_step_ms=1e3 * times[0], tok_s=tok_s, peak_gb=peak,
                residue_gb=residue / 1e9, state_gb=state_gb,
                launches_per_step=per_step, parts_ms=parts)


def train_step_parts(trainer, batch) -> dict:
    """Where a training step's time goes: one more step through the
    Trainer's own parts (the loss forward, autograd's backward, the AdamW
    update with the gradients' release), each ended by a device sync;
    host ms of each."""
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import grads, release_grads
    marks = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    loss, _ = M.loss_fn(trainer.params, batch, trainer.cfg)
    mark()
    loss.backward()
    mark()
    adamw.apply(trainer.params, trainer.opt_state, grads(trainer.params),
                trainer.tcfg.opt)
    release_grads(trainer.params)
    mark()
    ms = [round(1e3 * (b - a), 1) for a, b in zip(marks, marks[1:])]
    return dict(zip(("forward_ms", "backward_ms", "adamw_ms"), ms))


def phase_train_recovery(report):
    """13c: granite-8b at the smoke widths, QAT 8/8 on the card, deterministic
    algorithms on: `train` for 8 steps (checkpoints every 2, async, keep 3)
    with a failure injected at step 5 rolls back to step 4 and replays; the
    recovered history and final state equal an uninterrupted run's bit for
    bit.  Then an async save, prune and restore of the final state equal
    the saved tree bit for bit."""
    import tempfile
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.core.bramac_linear import QuantConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    q8 = QuantConfig(enabled=True, bits_w=8, bits_a=8)
    cfg = get_config("granite-8b", smoke=True).replace(quant=q8)
    pipe = SyntheticLM(DataConfig(cfg.vocab_size, 16, 2))

    def run(d, hook):
        params = M.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        tr = Trainer(cfg, TrainerConfig(ckpt_dir=d, ckpt_every=2,
                                        opt=adamw.AdamWConfig(lr=1e-3)),
                     params)
        return tr, tr.train(pipe, 8, failure_hook=hook)

    crashed = []

    def hook(step):
        if step == 5 and not crashed:
            crashed.append(step)
            raise RuntimeError("injected node failure")

    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as d0, \
                tempfile.TemporaryDirectory() as d1:
            _zero_counts()
            tr0, h0 = run(d0, None)
            tr1, h1 = run(d1, hook)
            got = _read_counts()
            need(crashed == [5] and tr1.step == 8 and len(h1) == 9,
                 f"13c: crashed {crashed}, step {tr1.step}, {len(h1)} steps")
            need(h1[:5] == h0[:5] and h1[5:] == h0[4:],
                 f"13c: recovered history != uninterrupted:\n{h0}\n{h1}")
            need(_trees_equal(tr0.state_tree(), tr1.state_tree()),
                 "13c: final state after recovery != uninterrupted")
            need(ckpt.latest_step(d1) == 8 and len(os.listdir(d1)) == 3,
                 f"13c: checkpoints {sorted(os.listdir(d1))}")
            back = ckpt.restore(d1, 8, tr1.state_tree())
            need(_trees_equal(tr1.state_tree(), back),
                 "13c: restore of the final checkpoint != the state")
            for s in (9, 10, 11):
                ckpt.save(d1, s, tr1.state_tree(), blocking=False).join()
            ckpt.prune(d1, keep=2)
            need(sorted(os.listdir(d1)) == ["step_00000010",
                                             "step_00000011"],
                 f"13c: after prune {sorted(os.listdir(d1))}")
            back = ckpt.restore(d1, 11, tr1.state_tree())
            need(_trees_equal(tr1.state_tree(), back),
                 "13c: async save + restore != the saved tree")
    finally:
        torch.use_deterministic_algorithms(False)
    _add_launches(report, got)
    print(f"phase 13c recovery (granite-8b smoke widths, QAT 8/8, "
          f"deterministic algorithms): failure at step 5 rolled back to the "
          f"step-4 checkpoint and replayed; history ({len(h1)} steps) and "
          f"final state == the uninterrupted run bit for bit; losses "
          f"{[round(h['loss'], 4) for h in h0]}; async save, prune (keep 2) "
          f"and restore bit-exact; launches {got}")
    return dict(losses=[h["loss"] for h in h0], launches=got)


def _trees_equal(a, b) -> bool:
    """Whether two trees hold the same tensors at the same paths, bit for
    bit."""
    from repro_torch.tree import tree_items
    ia, ib = tree_items(a), tree_items(b)
    return [k for k, _ in ia] == [k for k, _ in ib] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(ia, ib))


# ---------------------------------------------------------------------------
# phase 14: cross-attention and the stub frontends
# ---------------------------------------------------------------------------

def phase_xattn(report):
    """Phase 14: (b) llama-3.2-vision-11b at full width, forward-level, and
    (c) musicgen-large at full width through the Engine (14a is in phases
    2-4)."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    report["vision"] = phase_vision(report)
    report["musicgen"] = phase_musicgen(report)
    spent = time.perf_counter() - t_phase
    report["phase14_s"] = spent
    print(f"phase 14 took {spent:.1f} s")


def _top2(logits):
    top = torch.topk(logits.float(), 2, dim=-1)
    return top.indices.tolist(), (top.values[..., 0]
                                  - top.values[..., 1]).tolist()


def phase_vision(report):
    """14b: llama-3.2-vision-11b at full width (40 layers, 8 of them xattn,
    d=4096, 32/8 heads, vocab 128256, 1600 vision tokens), 8-bit weights
    quantized as drawn: `model.prefill` of 4 prompts of 64 tokens with
    vision embeddings drawn from a seed, then 16 greedy `decode_step`s on
    dense caches.  The xattn K/V caches stay the same bit for bit across
    the decode steps; each decoded token equals the argmax of one full
    forward over the same prefix, or the two runs swap a near tie of the
    top two.  bramac_matmul: 7 per layer + 1 at prefill (xattn projects
    its K/V there), 7 per attn layer, 5 per xattn layer (wq, wo, FF) + 1
    per decode step.  The Engine is not used: it feeds no vision inputs
    (as in the reference)."""
    from repro_torch.configs import get_config
    from repro_torch.core.bramac_linear import QuantConfig
    from repro_torch.models import model as M
    q8 = QuantConfig(enabled=True, bits_w=8, bits_a=8)
    cfg = get_config("llama-3.2-vision-11b").replace(quant=q8)
    need((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
          cfg.d_ff, cfg.vocab_size, cfg.vision_tokens, cfg.layer_pattern[0],
          cfg.dtype) == (40, 4096, 32, 8, 14336, 128256, 1600, "xattn+dense",
                         "bfloat16"), "llama-3.2-vision-11b config")
    n_x = cfg.n_periods                          # one xattn layer a period
    prefill_launches = 7 * cfg.num_layers + 1
    step_launches = 7 * (cfg.num_layers - n_x) + 5 * n_x + 1
    need((n_x, prefill_launches, step_launches) == (8, 281, 265),
         "llama-3.2-vision launch derivation")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, gen, "cuda", serving=q8)
    torch.cuda.synchronize()
    print(f"  llama-3.2-vision-11b params built and quantized one period at "
          f"a time in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    B, S, new = 4, 64, 16
    rng = np.random.default_rng(14)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)).cuda()
    ve = torch.randn((B, cfg.vision_tokens, cfg.d_model), generator=gen,
                     device="cuda").to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        caches = M.init_cache(cfg, B, S + new, device="cuda")
        _zero_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, caches = M.prefill(params, {"tokens": toks,
                                            "vision_embeds": ve}, cfg, caches)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t)
        got_p = _read_counts()
        need(got_p["bramac_matmul"] == prefill_launches,
             f"14b: prefill launches {got_p}")
        xkv = {k: caches["pos0"][k].clone() for k in ("k", "v")}
        need(all(bool(xkv[k].abs().amax() > 0) for k in xkv),
             "14b: prefill left the xattn caches empty")
        out, top_dec = [logits.argmax(-1)], [_top2(logits)]
        step_ms = []
        _zero_counts()
        for i in range(new):
            pos = torch.full((B,), S + i, dtype=torch.int32, device="cuda")
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, caches = M.decode_step(params, out[-1][:, None].to(
                torch.int32), cfg, caches, pos)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t))
            out.append(logits.argmax(-1))
            top_dec.append(_top2(logits))
        got_d = _read_counts()
        need(got_d["bramac_matmul"] == step_launches * new,
             f"14b: decode launches {got_d} != {step_launches} x {new}")
        need(all(torch.equal(caches["pos0"][k], xkv[k]) for k in xkv),
             "14b: the xattn K/V caches moved during decode")
        stream = torch.stack(out, 1)                     # (B, new + 1)
        full = torch.cat([toks, stream[:, :-1].to(torch.int32)], 1)
        flog, _, _ = M.forward(params, {"tokens": full, "vision_embeds": ve},
                               cfg)
        flog = flog[:, S - 1:]                           # (B, new + 1, V)
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the streams must agree, except that a request may leave the full
    # forward's argmax where both rank the same two tokens first and differ
    # only in their order (a near tie resolved otherwise by the cached
    # decode); after such a swap the contexts differ and nothing more is
    # compared
    a, b = stream.tolist(), flog.argmax(-1).tolist()
    swaps = []
    for r in range(B):
        j = next((j for j in range(new + 1) if a[r][j] != b[r][j]), None)
        if j is None:
            continue
        (da, gap_a), (fa, gap_b) = top_dec[j], _top2(flog[:, j])
        need(da[r] == [a[r][j], b[r][j]] and fa[r] == [b[r][j], a[r][j]],
             f"14b: request {r} token {j}: decoded {a[r][j]} vs full "
             f"forward {b[r][j]}, beyond a swap of the top two "
             f"({da[r]} vs {fa[r]})")
        swaps.append(f"request {r} token {j}: top two swapped, gaps "
                     f"{gap_a[r]:.4g} / {gap_b[r]:.4g}")
    dec_ms = float(np.mean(step_ms[1:]))
    print(f"phase 14b llama-3.2-vision-11b full width (40 layers, 8 xattn, "
          f"1600 vision tokens, 8-bit): prefill 4 x {S} tokens "
          f"{prefill_ms:.1f} ms ({prefill_launches} bramac_matmul launches), "
          f"{new} decode steps {dec_ms:.2f} ms each ({step_launches} "
          f"launches per step), peak memory {peak:.2f} GB; xattn K/V caches "
          f"unchanged across decode; decoded tokens == full-forward argmax"
          + (f" except near-tie swaps: {swaps}" if swaps else ""))
    _add_launches(report, got_p)
    _add_launches(report, got_d)
    del params, caches
    gc.collect()
    torch.cuda.empty_cache()
    return dict(prefill_ms=prefill_ms, decode_ms=dec_ms, peak_gb=peak,
                prefill_launches=prefill_launches,
                step_launches=step_launches, swaps=swaps)


def phase_musicgen(report):
    """14c: musicgen-large at full width (48 layers, d=2048, MHA 32/32,
    8-bit weights quantized as drawn) through the Engine on phase 11c's
    traffic (4 requests x 8 tokens), bf16 and int8 KV: bramac_matmul 7 x 48
    + 1 launches per forward, the decode kernel 48 per step.  Then one
    full-width forward from `frame_embeds` = the embedding of 64 tokens
    equals the token forward bit for bit (the audio stub frontend)."""
    from repro_torch.configs import get_config
    from repro_torch.core.bramac_linear import QuantConfig
    from repro_torch.models import model as M
    from repro_torch.models.layers import embed
    q8 = QuantConfig(enabled=True, bits_w=8, bits_a=8)
    cfg = get_config("musicgen-large").replace(quant=q8)
    need((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
          cfg.d_ff, cfg.vocab_size, cfg.audio_frontend, cfg.dtype) ==
         (48, 2048, 32, 32, 8192, 2048, True, "bfloat16"),
         "musicgen-large config")
    per_fwd = 7 * cfg.num_layers + 1
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda", serving=q8)
    torch.cuda.synchronize()
    print(f"  musicgen-large params built and quantized in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    prompts = _phase5_prompts(cfg.vocab_size)[:4]
    serve(cfg, params, [prompts[0][:5]], 2)                 # warm-up
    runs = {}
    for quant_kv in (False, True):
        c = cfg.replace(quant_kv=quant_kv)
        kv = "int8" if quant_kv else "bf16"
        attn = "paged_decode_q" if quant_kv else "paged_decode"
        other = "paged_decode" if quant_kv else "paged_decode_q"
        _zero_counts()
        torch.cuda.reset_peak_memory_stats()
        run = serve(c, params, prompts, 8)
        got = _read_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        need(run["done"] == 4 and all(
            len(s) == 8 and all(0 <= t < cfg.vocab_size for t in s)
            for s in run["streams"]), f"14c ({kv} KV): streams")
        need(got["bramac_matmul"] == per_fwd * run["forwards"],
             f"14c ({kv} KV): bramac_matmul launches {got['bramac_matmul']} "
             f"!= {per_fwd} x {run['forwards']}")
        need(got[attn] == cfg.num_layers * run["steps"] > 0
             and got[other] == 0, f"14c ({kv} KV): decode kernel launches "
             f"{got} for {run['steps']} steps")
        need(run["drained"], f"14c ({kv} KV): a pool kept pages")
        _add_launches(report, got)
        ttft = 1e3 * float(np.mean(run["ttft"]))
        runs[kv] = dict(tok_s=run["tokens"] / run["wall"], ttft_ms=ttft,
                        peak_gb=peak, forwards=run["forwards"],
                        steps=run["steps"], launches=got)
        print(f"phase 14c serve musicgen-large {kv} KV: {run['done']}/4 "
              f"requests, {run['tokens']} tokens in {run['wall']:.2f} s "
              f"({run['tokens'] / run['wall']:.2f} tok/s), mean TTFT "
              f"{ttft:.1f} ms, peak memory {peak:.2f} GB, {run['forwards']} "
              f"forwards, launches {got} (= {per_fwd} x forwards and "
              f"{cfg.num_layers} x {run['steps']} steps)")
    with torch.no_grad():
        toks = torch.from_numpy(prompts[0][:64].astype(np.int32))[None].cuda()
        by_tok = M.forward(params, {"tokens": toks}, cfg)[0]
        frames = embed(params["embed"], toks)
        by_frame = M.forward(params, {"frame_embeds": frames}, cfg)[0]
    need(torch.equal(by_tok, by_frame),
         "14c: the frame_embeds forward != the token forward")
    print("phase 14c musicgen-large full width: forward from frame_embeds "
          "(64 frames) == the token forward bit for bit")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------------------
# phase 15: the parallel family, on ranks that share the card
# ---------------------------------------------------------------------------

PAR_RANKS = 2                      # mesh "model=2": both ranks on cuda:0
# granite-8b's row-parallel shards at TP-2: K/2 rows of wo and w_down
ROW_SHARDS = {"wo": (2048, 4096), "w_down": (7168, 4096)}


def _int32_bound(M, K, N):
    """-> (ms, by): x and w (int8) read once, the int32 output written
    once, two unit scales; the 2·M·N·K operations of one int8 product."""
    nbytes = M * K + K * N + 4 * M * N + 8
    ops = 2 * M * N * K
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / INT8_OPS_PER_S \
        else "operations"
    return max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3, by


def phase_int32(gen):
    """15a: `bramac_matmul(..., out_dtype=torch.int32)` with unit scales
    (the row-parallel mode) bit-exact vs plain at granite's TP-2 row
    shards, M = 4 and 64, and where |acc| > 2^24 (8-bit values all +-127
    at K = 2048, odd sums that round in the f32 round trip, as the TPU
    kernel's int32 output does); timed beside its bound and one
    `torch._int_mm` at 32 rows (the same weights, read once)."""
    from repro_torch.kernels import bramac_matmul as bm
    from repro_torch.kernels import ref
    one = torch.ones((1, 1), device="cuda")
    kw = dict(bits_a=8, bits_w=8, out_dtype=torch.int32)
    rows = []
    for name, (K, N) in ROW_SHARDS.items():
        for M in (4, 64):
            x, w = rand_q(gen, 8, (M, K)), rand_q(gen, 8, (K, N))
            got = bm.bramac_matmul(x, w, one, one, **kw)
            want = bm.bramac_matmul_plain(x, w, one, one, **kw)
            torch.cuda.synchronize()
            need(got.dtype == torch.int32 and torch.equal(got, want),
                 f"15a int32 mode != plain at {name} M={M}")
            ms = time_cold(lambda: bm.bramac_matmul(x, w, one, one, **kw))
            plain_ms = time_cold(
                lambda: bm.bramac_matmul_plain(x, w, one, one, **kw),
                iters=5)
            bound, by = _int32_bound(M, K, N)
            xr = x.repeat(-(-32 // M), 1)[:32].contiguous()
            lib_ms = time_cold(lambda: torch._int_mm(xr, w))
            rows.append(dict(shape=name, M=M, K=K, N=N, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                             library="torch._int_mm (32 rows)",
                             library_ms=lib_ms))
            print(f"  bramac_matmul int32 {name} TP-2 shard M={M} K={K} "
                  f"N={N}: {ms:.4f} ms (bound {bound:.4f} ms by {by}, "
                  f"plain {plain_ms:.4f} ms, torch._int_mm at 32 rows "
                  f"{lib_ms:.4f} ms)")
    x = torch.full((4, 2048), 127, dtype=torch.int8)
    x[1, :9] = -127
    x[:, 5] = 126
    w = torch.full((2048, 128), 127, dtype=torch.int8)
    for c in range(128):
        w[:c % 17, c] = -127
    x, w = x.cuda(), w.cuda()
    got = bm.bramac_matmul(x, w, one, one, **kw)
    want = bm.bramac_matmul_plain(x, w, one, one, **kw)
    raw = ref.int_dot(x, w)
    torch.cuda.synchronize()
    need(torch.equal(got, want), "15a int32 mode != plain at |acc| > 2^24")
    need(int(raw.abs().max()) > 2 ** 24 and bool((raw != got).any()),
         "15a: the |acc| > 2^24 case does not round")
    print(f"phase 15a bramac_matmul int32 mode: {len(rows) + 1} cases "
          f"bit-exact vs plain (granite wo / w_down TP-2 shards at M = 4 "
          f"and 64; |acc| up to {int(raw.abs().max())} > 2^24, "
          f"{int((raw != got).sum())} of {raw.numel()} outputs rounded in "
          f"the f32 round trip, as the TPU kernel's)")
    return rows


def _rank_primitives(mesh):
    """15b on one rank (every rank draws the same inputs): the sharded
    functions against their single-rank counterparts, bit for bit."""
    from repro_torch.core.bramac_linear import prepare_serving, \
        serve_einsum_edf, tree_prepare_serving
    from repro_torch.kernels import ops
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel import ep, tp
    from repro_torch.runtime import dp_trainer as dp
    gen = torch.Generator(device="cuda").manual_seed(151)
    for name in ("wq/wo", "w_gate/w_up"):
        K, N = GRANITE_SHAPES[name]
        x, w = rand_q(gen, 8, (4, K)), rand_q(gen, 8, (K, N))
        xs = torch.rand((4, 1), generator=gen, device="cuda") + 0.5
        ws = torch.rand((1, N), generator=gen, device="cuda") + 0.5
        want = ops.quant_matmul(x, w, xs, ws, bits_a=8, bits_w=8,
                                out_dtype=torch.bfloat16)
        for part in ("k", "n"):
            got = tp.tp_quant_matmul(x, w, xs, ws, mesh=mesh, bits_a=8,
                                     bits_w=8, partition=part,
                                     out_dtype=torch.bfloat16)
            need(torch.equal(got, want),
                 f"15b tp_quant_matmul {part} at granite {name} != "
                 f"quant_matmul")
    cfg, q8 = _qwen3_cfg()
    E, d, f = cfg.num_experts, cfg.d_model, cfg.expert_d_ff
    w = (torch.randn((E, d, f), generator=gen, device="cuda")
         / d ** 0.5).to(torch.bfloat16)
    qw = prepare_serving(w, q8)
    x = torch.randn((E, 5, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    want = serve_einsum_edf(x, qw, False)
    for part in ("e", "d"):
        got = ep.ep_quant_einsum_edf(x, qw, mesh=mesh, partition=part)
        need(torch.equal(got, want),
             f"15b ep_quant_einsum_edf {part} at qwen3's (128, 5, 2048) x "
             f"(128, 2048, 768) != serve_einsum_edf")
    del w, qw
    qp = tree_prepare_serving(moe_mod.init_moe(gen, cfg, "cuda"), q8)
    x = torch.randn((2, 32, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    want, aux_want = moe_mod.moe(qp, x, cfg)
    got, aux = ep.ep_moe(qp, x, cfg, mesh=mesh)
    need(torch.equal(got, want) and abs(float(aux) - float(aux_want))
         <= 1e-5 * abs(float(aux_want)), "15b ep_moe global != moe()")
    got, aux, keep = ep.ep_moe(qp, x, cfg, mesh=mesh, dispatch="per_source",
                               return_drops=True)
    want, aux_want, keep_want = ep.per_source_reference(
        qp, x, cfg, ep_size=mesh.shape["model"])
    need(torch.equal(got, want) and torch.equal(keep, keep_want)
         and abs(float(aux) - float(aux_want))
         <= 1e-5 * abs(float(aux_want)),
         "15b ep_moe per_source != per_source_reference")
    del qp
    # the DP step on a (16, 4) regression, a batch of 64 over model=2 used
    # as the data axis: compress on and off == the single-rank composition
    # of the same per-shard gradients (two terms: the mean is exact)
    params = {"w": torch.randn((16, 4), generator=gen, device="cuda")}
    target = torch.randn((16, 4), generator=gen, device="cuda")
    batch = torch.randn((64, 16), generator=gen, device="cuda")

    def loss_fn(p, b):
        return torch.mean((b @ p["w"] - b @ target) ** 2)
    n = mesh.shape["model"]
    grads = []
    for s in range(n):
        wl = params["w"].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss_fn({"w": wl}, batch.chunk(n)[s]), wl)
        grads.append(g)
    err = dp.init_error_feedback(params, mesh)
    for compress in (True, False):
        step = dp.make_dp_train_step(loss_fn, mesh, axis="model",
                                     compress=compress)
        got, _, _ = step(params, err, batch)
        parts = [dp.compress_decompress(g, torch.zeros_like(g))[0]
                 if compress else g for g in grads]
        need(torch.equal(got["w"], sum(parts) / n),
             f"15b make_dp_train_step (compress={compress}) != the "
             f"single-rank composition")
    return "ok"


def _rank_serve(cfg, params, prompts, new_tokens, mesh):
    """One mesh serve on this rank (after a short warm-up), with its
    launches, collectives and peak memory."""
    from repro_torch.parallel import comm
    serve(cfg, params, prompts[:2], 2, mesh=mesh)
    _zero_counts()
    comm.stats.reset()
    torch.cuda.reset_peak_memory_stats()
    run = serve(cfg, params, prompts, new_tokens, mesh=mesh)
    run["launches"] = _read_counts()
    run["comm"] = comm.stats.snapshot()
    run["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return run


def parallel_rank(rank, world, device):
    """Phases 15b-d on one rank of the mesh "model=2"."""
    from repro_torch.configs import get_config
    from repro_torch.core.bramac_linear import QuantConfig
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding
    for name in build.SOURCES:
        build.library(name)
    mesh = sharding.build_mesh("model=2")
    out = {"15b": _rank_primitives(mesh)}
    t0 = time.perf_counter()
    q8 = QuantConfig(enabled=True, bits_w=8, bits_a=8)
    cfg = get_config("granite-8b").replace(quant=q8)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda", serving=q8)
    torch.cuda.synchronize()
    prompts = _phase5_prompts(cfg.vocab_size)
    out["granite_draw_s"] = time.perf_counter() - t0
    out["granite_layers"] = cfg.num_layers
    for quant_kv in (False, True):
        out["granite_" + ("int8" if quant_kv else "bf16")] = _rank_serve(
            cfg.replace(quant_kv=quant_kv), params, prompts, 16, mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, q8 = _qwen3_cfg(num_layers=MOE_CUT_LAYERS)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda", serving=q8)
    torch.cuda.synchronize()
    out["qwen3_draw_s"] = time.perf_counter() - t0
    out["qwen3_layers"], out["qwen3_experts"] = cfg.num_layers, \
        cfg.num_experts
    out["qwen3"] = _rank_serve(cfg, params,
                               _phase5_prompts(cfg.vocab_size)[:4], 8, mesh)
    return out


def _check_mesh_serve(label, runs, want, layers, kv, per_fwd, calls_per_fwd,
                      report):
    """The ranks' serves of one configuration: every rank's streams the
    meshless Engine's (`want`), bramac_matmul launches, the `kv` KV's
    decode kernel once per layer and decode step (the other never) and
    collectives their derived counts."""
    r0 = runs[0]
    attn = "paged_decode_q" if kv == "int8" else "paged_decode"
    other = "paged_decode" if kv == "int8" else "paged_decode_q"
    for r, run in enumerate(runs):
        got = run["launches"]
        parted = [i for i, (a, b) in enumerate(zip(run["streams"], want))
                  if a != b]
        need(run["done"] == len(want) and not parted,
             f"{label}: rank {r} streams != the meshless Engine's: requests "
             f"{parted} part (first: {run['streams'][parted[0]] if parted else None}"
             f" vs {want[parted[0]] if parted else None})")
        need(got["bramac_matmul"] == per_fwd * run["forwards"],
             f"{label}: rank {r} bramac_matmul launches "
             f"{got['bramac_matmul']} != {per_fwd} x {run['forwards']} "
             f"forwards")
        need(got[attn] == layers * run["steps"] > 0 and got[other] == 0,
             f"{label}: rank {r} decode kernel launches {got} for "
             f"{run['steps']} steps x {layers} layers")
        need(run["comm"]["calls"] == calls_per_fwd * run["forwards"],
             f"{label}: rank {r} {run['comm']['calls']} collectives != "
             f"{calls_per_fwd} x {run['forwards']} forwards")
        for k in ("bramac_matmul", attn):
            report[k]["launches"] += got[k]
    c = r0["comm"]
    row = dict(tok_s=r0["tokens"] / r0["wall"],
               ttft_ms=1e3 * float(np.mean(r0["ttft"])),
               wall_s=r0["wall"], forwards=r0["forwards"],
               peak_gb=[run["peak_gb"] for run in runs],
               launches_per_rank=[run["launches"]["bramac_matmul"]
                                  for run in runs],
               decode_launches_per_rank=[run["launches"][attn]
                                         for run in runs],
               collectives_per_forward=calls_per_fwd,
               staged_mb_per_forward=c["staged_bytes"] / r0["forwards"] / 1e6,
               comm_ms=1e3 * c["seconds"],
               comm_ms_per_forward=1e3 * c["seconds"] / r0["forwards"])
    print(f"{label}: {r0['done']} requests, {r0['tokens']} tokens in "
          f"{r0['wall']:.2f} s ({row['tok_s']:.2f} tok/s), mean TTFT "
          f"{row['ttft_ms']:.1f} ms, peak memory per rank "
          f"{', '.join(f'{g:.2f}' for g in row['peak_gb'])} GB, "
          f"{r0['forwards']} forwards; per rank and forward {per_fwd} "
          f"bramac_matmul launches and {calls_per_fwd} collectives, {attn} "
          f"{layers} x {r0['steps']} decode steps (as derived), "
          f"{row['staged_mb_per_forward']:.3f} MB staged through "
          f"the host, {row['comm_ms_per_forward']:.2f} ms in collectives "
          f"({row['comm_ms']:.1f} ms of the serve); streams == the meshless "
          f"Engine's on every rank")
    return row


def phase_parallel_launchers():
    """15e: `launch/serve.py --shard 2` and `launch/train.py --data 2` on
    the card, each in a subprocess that spawns its 2 ranks."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = {}
    with tempfile.TemporaryDirectory() as ckpt:
        for name, args, want in (
                ("serve", ["repro_torch.launch.serve", "--arch",
                           "granite-8b", "--smoke", "--shard", "2"],
                 r"^8/8 requests done, .*mesh=\{'data': 1, 'model': 2\}\)$"),
                ("train", ["repro_torch.launch.train", "--arch",
                           "granite-8b", "--smoke", "--steps", "4", "--data",
                           "2", "--ckpt-dir", ckpt],
                 r"^loss \d+\.\d{4} -> \d+\.\d{4} over 4 steps; straggler "
                 r"events: \d+$")):
            t0 = time.perf_counter()
            run = subprocess.run([sys.executable, "-m", *args], env=env,
                                 cwd=ROOT, capture_output=True, text=True,
                                 timeout=300)
            wall = time.perf_counter() - t0
            lines = run.stdout.strip().splitlines()
            line = lines[0 if name == "serve" else -1] if lines else ""
            need(run.returncode == 0 and re.match(want, line),
                 f"15e launcher {name}: rc {run.returncode}, "
                 f"{line!r}\n{run.stderr[-2000:]}")
            out[name] = dict(wall_s=wall, line=line)
            print(f"  15e python -m {' '.join(args)}: exit 0 in "
                  f"{wall:.1f} s: {line}")
    return out


def phase_parallel(report):
    """Phase 15: (a) kernel 1's int32 mode; on 2 ranks sharing cuda:0
    (gloo, host staging): (b) the sharded primitives against their
    single-rank versions, (c) granite-8b at full width and depth and (d)
    qwen3-moe-30b-a3b at full width, 16 of 48 layers, through
    `Engine(mesh="model=2")`, the decode kernels on each rank's KV heads,
    against the meshless streams of phases 5 and 11c; (e) both launchers'
    mesh flags."""
    from repro_torch.parallel import comm
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(15)
    report["int32_mode"] = phase_int32(gen)
    t0 = time.perf_counter()
    outs = comm.spawn(parallel_rank, PAR_RANKS)
    draws = {k: ", ".join("%.1f" % o[k] for o in outs)
             for k in ("granite_draw_s", "qwen3_draw_s")}
    print(f"  phase 15b-d: {PAR_RANKS} ranks on "
          f"{torch.cuda.get_device_name(0)} in {time.perf_counter() - t0:.1f}"
          f" s (granite-8b drawn in {draws['granite_draw_s']} s, qwen3-moe "
          f"in {draws['qwen3_draw_s']} s per rank)")
    need(all(o["15b"] == "ok" for o in outs), "15b failed on a rank")
    print("phase 15b on 2 ranks: tp_quant_matmul k and n at granite wq/wo "
          "and w_gate (M=4) == quant_matmul; ep_quant_einsum_edf e and d at "
          "qwen3's 128 x 2048 x 768 == serve_einsum_edf; ep_moe global == "
          "moe() (values, aux), per_source == per_source_reference (values, "
          "aux, keep) on one full-width MoE layer; make_dp_train_step with "
          "compress on and off == the single-rank composition; bit for bit")
    # per rank and forward: each of the 7 linears of a layer on its shard
    # and the unembed; a max and a sum for each row-parallel wo and w_down,
    # one gather of the logits
    L = outs[0]["granite_layers"]
    par = {}
    for kv in ("bf16", "int8"):
        par["granite_" + kv] = _check_mesh_serve(
            f"phase 15c granite-8b ({L} layers) model=2, {kv} KV",
            [o["granite_" + kv] for o in outs], report["granite_streams"][kv],
            L, kv, 7 * L + 1, L * 2 * 2 + 1, report)
    # qwen3: wq wk wv wo and E/2 local experts of each expert einsum a
    # layer, the unembed; wo's max and sum, a gather per expert einsum,
    # the logits' gather
    L, E = outs[0]["qwen3_layers"], outs[0]["qwen3_experts"]
    par["qwen3"] = _check_mesh_serve(
        f"phase 15d qwen3-moe-30b-a3b ({L} of 48 layers) model=2, bf16 KV",
        [o["qwen3"] for o in outs], report["qwen3_streams"], L, "bf16",
        (4 + 3 * E // PAR_RANKS) * L + 1, L * (2 + 3) + 1, report)
    par["launchers"] = phase_parallel_launchers()
    report["parallel"] = par
    spent = time.perf_counter() - t_phase
    report["phase15_s"] = spent
    print(f"phase 15 took {spent:.1f} s")


def _gb(x) -> float:
    return x / 1e9


def _dry_line(label, rec) -> str:
    """The dry run's prediction for one step, in words."""
    r, m = rec["roofline"], rec["memory"]
    return (f"{label}: predicted peak {_gb(m['peak_est_bytes_per_dev']):.2f} "
            f"GB (args {_gb(m['args_bytes_per_dev']):.2f} GB), roofline "
            f"compute {1e3 * r['compute_s']:.3f} ms / memory "
            f"{1e3 * r['memory_s']:.3f} ms ({r['dominant']}-bound), "
            f"{rec['kernel_calls_per_dev']['bramac_matmul']} bramac_matmul "
            f"calls, counted by {rec['cost_probe']} in {rec['count_s']} s")


def dry_record(cfg, info, quant_bits=0, mesh=None):
    """`launch.dryrun`'s record of one step of `cfg` at `info`, counted on
    the CPU's meta device."""
    from repro_torch.launch import dryrun
    return dryrun.predict(cfg, info, quant_bits, mesh)


def within(measured: float, predicted: float, rel: float,
           floor: float = 0.0) -> bool:
    return abs(measured - predicted) <= max(rel * measured, floor)


def live_step(step, args, repeats=3):
    """Run `step(*args)` on the card `repeats` times after a warm-up; the
    device peak above what was allocated before (the arguments included),
    the mean host ms of a synced step, and the kernel launches of one."""
    step(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    step(*args)
    torch.cuda.synchronize()
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    times = []
    for _ in range(repeats):
        t = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return peak, 1e3 * float(np.mean(times)), launches


def phase_dryrun(report):
    """Phase 16: the dry run (`launch.dryrun`, counted on the CPU's meta
    device) held to live runs of the same step functions.  (a) granite-8b
    training as phase 13b runs it: the predicted peak within 10% of 13b's
    measured one, its step ms beside the roofline terms; (b) granite-8b's
    decode step (B=8 over a 4096-row dense cache) and prefill step (B=1,
    S=4096) on q8 serving weights built as phase 5 builds them, live: each
    peak within 10% (or 0.5 GB) of the prediction, bramac_matmul launches
    equal to the counted kernel calls, ms beside the roofline terms, and
    the full decode_32k / prefill_32k cells' predictions (which do not fit
    one card); (c) the model=2 serve_tp_q8 decode cell's 145 collectives,
    beside phase 15c's staged bytes.  The meta count leaves out the cuBLAS
    workspace (CUBLAS_WORKSPACE_CONFIG :4096:8, 32 MiB) and the
    allocator's segments; it rounds each storage to the allocator's
    512-byte granule (`peak_rounded`)."""
    from repro_torch.configs import archs, get_config
    from repro_torch.core.bramac_linear import QuantConfig, \
        tree_prepare_serving
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    q8 = QuantConfig(enabled=True, bits_w=8, bits_a=8)
    cfg = get_config("granite-8b").replace(quant=q8)
    out = {}

    # (a) training: phase 13b's config and measured step
    tr = report["train"]
    info = {"kind": "train", "batch": TRAIN_B, "seq": TRAIN_S}
    rec = dry_record(cfg, info)
    print("  " + _dry_line(f"16a granite-8b train B={TRAIN_B} S={TRAIN_S}",
                           rec))
    pred = rec["memory"]["peak_rounded_bytes_per_dev"]
    meas = 1e9 * (tr["peak_gb"] - tr["residue_gb"])
    bound_ms = 1e3 * max(rec["roofline"]["compute_s"],
                         rec["roofline"]["memory_s"])
    need(within(meas, pred, 0.10),
         f"16a: predicted training peak {_gb(pred):.2f} GB is not within 10% "
         f"of 13b's measured {_gb(meas):.2f} GB")
    need(rec["kernel_calls_per_dev"]["bramac_matmul"] ==
         tr["launches_per_step"], f"16a: counted kernel calls "
         f"{rec['kernel_calls_per_dev']} != 13b's {tr['launches_per_step']}")
    out["train"] = dict(predicted_peak_gb=_gb(pred), measured_peak_gb=_gb(meas),
                        step_ms=tr["step_ms"], roofline=rec["roofline"],
                        bound_ms=bound_ms)
    print(f"phase 16a granite-8b train: predicted peak {_gb(pred):.2f} GB vs "
          f"13b's measured {_gb(meas):.2f} GB "
          f"({100 * (pred - meas) / meas:+.2f}%); step {tr['step_ms']:.1f} ms "
          f"vs roofline compute {1e3 * rec['roofline']['compute_s']:.2f} ms / "
          f"memory {1e3 * rec['roofline']['memory_s']:.2f} ms: "
          f"{tr['step_ms'] / bound_ms:.1f}x the bound")

    # (b) serving steps at cuts of decode_32k and prefill_32k, live
    residue = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tree_prepare_serving(M.init_params(cfg, gen, "cuda"), q8)
    torch.cuda.synchronize()
    g = torch.Generator(device="cuda").manual_seed(16)
    cuts = {"decode": ({"kind": "decode", "batch": 8, "seq": 4096},
                       "decode_32k"),
            "prefill": ({"kind": "prefill", "batch": 1, "seq": 4096},
                        "prefill_32k")}
    for kind, (info, full) in cuts.items():
        rec = dry_record(cfg, info, 8)
        full_rec = dry_record(cfg, archs.SHAPES[full], 8)
        B, S = info["batch"], info["seq"]
        caches = M.init_cache(cfg, B, S, device="cuda")
        if kind == "decode":
            tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=g,
                                   device="cuda", dtype=torch.int32)
            pos = torch.full((B,), S - 1, dtype=torch.int32, device="cuda")
            args = (params, tokens, caches, pos)
            step = dryrun.make_decode_step(cfg)
        else:
            tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                   device="cuda", dtype=torch.int32)
            args = (params, {"tokens": tokens}, caches)
            step = dryrun.make_prefill_step(cfg)
        with torch.no_grad():
            peak, ms, got = live_step(step, args)
        logits = step(*args)[0]
        need(tuple(logits.shape) == (B, cfg.vocab_size) and
             bool(torch.isfinite(logits).all()),
             f"16b {kind}: logits {tuple(logits.shape)} not finite")
        meas = peak - residue
        pred = rec["memory"]["peak_rounded_bytes_per_dev"]
        calls = rec["kernel_calls_per_dev"]["bramac_matmul"]
        bound_ms = 1e3 * max(rec["roofline"]["compute_s"],
                             rec["roofline"]["memory_s"])
        print("  " + _dry_line(f"16b {kind} B={B} S={S}", rec))
        print("  " + _dry_line(f"16b {full} (full cell, not run)", full_rec))
        need(within(meas, pred, 0.10, 0.5e9),
             f"16b {kind}: predicted peak {_gb(pred):.2f} GB is not within "
             f"10% (or 0.5 GB) of the measured {_gb(meas):.2f} GB")
        need(got["bramac_matmul"] == calls,
             f"16b {kind}: {got['bramac_matmul']} bramac_matmul launches != "
             f"the dry run's {calls} calls")
        _add_launches(report, got)
        out[kind] = dict(B=B, S=S, predicted_peak_gb=_gb(pred),
                         measured_peak_gb=_gb(meas), ms=ms,
                         roofline=rec["roofline"], bound_ms=bound_ms,
                         launches=got["bramac_matmul"],
                         full_cell=full, full_peak_gb=_gb(
                             full_rec["memory"]["peak_est_bytes_per_dev"]),
                         full_roofline=full_rec["roofline"])
        print(f"phase 16b granite-8b q8 {kind} B={B} S={S}: predicted peak "
              f"{_gb(pred):.2f} GB vs measured {_gb(meas):.2f} GB "
              f"({100 * (pred - meas) / meas:+.2f}%), {calls} bramac_matmul "
              f"launches as counted; {ms:.2f} ms a step vs roofline compute "
              f"{1e3 * rec['roofline']['compute_s']:.3f} ms / memory "
              f"{1e3 * rec['roofline']['memory_s']:.3f} ms: "
              f"{ms / bound_ms:.1f}x the bound; the full {full} cell: "
              f"{out[kind]['full_peak_gb']:.1f} GB predicted peak")
        del caches, args, logits
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the tensor-parallel decode cell's collectives, on the CPU
    rec = dry_record(get_config("granite-8b"), archs.SHAPES["decode_32k"], 8,
                     mesh="model=2")
    calls = rec["collective_calls_per_dev"]
    L = cfg.num_layers
    need(sum(calls.values()) == 145 == L * 2 * 2 + 1 and
         calls == {"all-reduce": 144, "all-gather": 1},
         f"16c: model=2 decode collectives {calls} != 36 x 2 x 2 + 1 = 145")
    staged = report["parallel"]["granite_bf16"]["staged_mb_per_forward"]
    out["tp_decode"] = dict(collectives=calls,
                            bytes=rec["collective_bytes_per_dev"],
                            staged_mb_15c=staged)
    print(f"phase 16c granite-8b serve_tp_q8 decode_32k on model=2 (dry): "
          f"{sum(calls.values())} collectives a forward per rank {calls}, "
          f"result bytes {rec['collective_bytes_per_dev']} "
          f"({rec['collective_bytes_total_per_dev'] / 1e6:.1f} MB at B=128); "
          f"phase 15c staged {staged:.3f} MB a forward through the host "
          f"(its own traffic, in and out, at its slots)")
    report["dryrun"] = out
    spent = time.perf_counter() - t_phase
    report["phase16_s"] = spent
    print(f"phase 16 took {spent:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    smi = smi_line()
    t0 = t_start = time.perf_counter()
    reports = build.build_all()
    for name in build.SOURCES:
        build.library(name)
    if reports:
        ptxas = " ".join(reports.values())
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", ptxas)]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill stores",
                                             ptxas)]
        built = (f"built {', '.join(sorted(reports))} (ptxas: up to "
                 f"{max(regs, default=0)} registers/thread, {sum(spills)} "
                 f"bytes spilled)")
    else:
        built = "cached build, nothing compiled"
    print(f"phase 1 device: {smi}; kernels ready in "
          f"{time.perf_counter() - t0:.1f} s, {built}")
    print(f"  bramac_accumulate: "
          f"{matmul_build(reports.get('bramac_matmul'))}")
    print(f"  mac2_mvm: {mac2_build(reports.get('mac2_kernel'))}")
    print(f"  paged_decode: {paged_fp_build()}")
    print(f"  paged_decode_q: {paged_q_build()}")
    report: dict = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    phase_matmul(gen, report)
    phase_paged(gen, report)
    phase_mac2(gen, report)
    phase_serve(report)
    phase_minicpm(report)
    phase_moe(report)
    phase_recurrent(report)
    phase_train(report)
    phase_xattn(report)
    phase_streams()
    phase_parallel(report)
    phase_dryrun(report)
    print(f"timing: {len(HOST_BOUND)} readings in which an enqueue outlasted "
          f"the device spin" + (f": {HOST_BOUND}" if HOST_BOUND else ""))
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: report[n][k] for k in keys}
               for n in ("bramac_matmul", "paged_decode", "paged_decode_q",
                         "mac2_mvm_kernel")]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
