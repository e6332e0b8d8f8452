"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/kernels/csrc`, holds
each against its plain PyTorch version at its path's shapes, runs the paper
path (`repro_torch.launch.paper`: the analytical models' rows, which must
equal `benchmarks/baseline.json`, and the Fig 11 GEMVs through the
dummy-array MAC2 kernel) and times that kernel on every granite-8b linear
as a GEMV, serves granite-8b at full size (36 layers, d=4096, bf16, 8-bit
BRAMAC weights, random weights from a seed) through the port's Engine with
fp and int8 KV caches, counts that each path went through its kernels, and
checks that greedy streams are identical with the decode kernels on and
off.  Imports torch, numpy and `repro_torch` only.  Exits non-zero,
printing no result, when any phase fails or no CUDA device is present.

Output: one line per phase; then a JSON line listing every kernel with its
check, times and bound; the card's name and power limit as nvidia-smi gives
them; and, last, {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import functools
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and int8 ops/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12
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


def time_cold(fn, iters: int = 20) -> float:
    """Mean ms of `fn()` on the device, the L2 flushed before each launch.
    A spin kernel ahead of the start event keeps the device busy while the
    host enqueues `fn`, so the interval holds device time, not the
    wrapper's Python time.  The spin lasts 4x the host's enqueue time of
    one call (at least 1 ms); a reading in which some call's enqueue still
    outlasted the spin may include host time, and is printed and kept in
    HOST_BOUND."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = max(1.0, 4 * enqueue_ms)
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
            nbytes = M * K + K * N + 4 * (M + N) + 2 * M * N
            ops = 2 * M * N * K * 4                  # 4 radix-4 digit passes
            bound = max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
            by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / INT8_OPS_PER_S \
                else "operations"
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
    print(f"phase 2 bramac_matmul: {n} cases bit-exact vs plain, max abs "
          f"err {worst:.3g} (bits 2/4/8, signed+unsigned, 4-bit packed, "
          f"f32+bf16 out, scalar and per-channel scales, ragged M/K/N at the "
          f"16/64-row, 128-byte and 128-column tile edges, split K, unaligned "
          f"views and granite shapes)")
    main = next(r for r in rows if r["shape"] == "w_gate/w_up" and r["M"] == 4)
    report["bramac_matmul"] = dict(
        name="bramac_matmul", route="cuda",
        source="src/repro_torch/kernels/csrc/bramac_matmul.cu",
        replaces="src/repro/kernels/bramac_matmul.py:47", max_abs_err=worst,
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"],
        shapes=rows)


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
# max_pages).  max_pages 256 splits a walk over 8 blocks of 32 pages, and
# lengths up to 4096 make all 8 active; H/Hkv = 16 and H = Hkv; max_pages
# 1024 at H/Hkv = 16 keeps the scores in the device scratch buffer
Q_CASES = {
    "long": ((4096, 3000, 1500, 4000), (256, 188, 94, 256), H, HKV, 256),
    "long_g16": ((4096, 2500, 1, 3333), (256, 160, 1, 209), 32, 2, 256),
    "g1": ((57, 104, 121, 136), (4, 7, 8, 9), 8, 8, MAXP),
    "scratch_g16": ((16384, 9000, 20, 12000), (1024, 563, 2, 750), 32, 2,
                    1024),
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
    **{name: Q_CASES[name] + (HD, PS) for name in ("long", "long_g16", "g1")},
    "hd100_ps12": ((450, 13, 0, 200), (38, 2, 0, 40), 8, 2, 40, 100, 12),
    "hd256": CASES["serve"] + (H, HKV, MAXP, 256, PS),
    "hd256_g16": Q_CASES["scratch_g16"] + (256, PS),
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
        if cname in ("serve", "long") and dt == torch.bfloat16:
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
            rows.append(dict(case=cname, B=B, H=H, Hkv=Hkv, max_pages=maxp,
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
          f"tiles) up to H/Hkv 16 at max_pages 1024")

    worst = 0.0
    timed = []

    def q_case(cname, lengths, n_pages, dt, H, Hkv, maxp):
        nonlocal worst
        B = len(lengths)
        tables, npg, lens, read = _pool_case(gen, lengths, n_pages, maxp)
        P = B * maxp
        k = torch.randint(-127, 128, (P, PS, Hkv, HD), generator=gen,
                          device="cuda").to(torch.int8)
        v = torch.randint(-127, 128, (P, PS, Hkv, HD), generator=gen,
                          device="cuda").to(torch.int8)
        ks = torch.rand(P, PS, Hkv, generator=gen, device="cuda") * 0.02
        vs = torch.rand(P, PS, Hkv, generator=gen, device="cuda") * 0.02
        qq = torch.randint(-127, 128, (B, H, HD), generator=gen,
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
        if cname in ("serve", "long") and dt == torch.bfloat16:
            rows, walked = _live_rows(lengths, n_pages)
            nbytes = 2 * rows * Hkv * (HD + 4) + B * H * (HD + 4) \
                + 2 * B * H * HD + 4 * (walked + 2 * B)
            ops = 4 * rows * H * HD
            bound = max(nbytes / HBM_BYTES_PER_S,
                        ops / INT8_OPS_PER_S) * 1e3
            by = "bytes" if nbytes / HBM_BYTES_PER_S >= \
                ops / INT8_OPS_PER_S else "operations"
            ms = time_cold(lambda: pa.paged_decode_q(*args, dt))
            plain_ms = time_cold(lambda: pa.paged_decode_q_plain(*args, dt))
            timed.append((cname, ms, plain_ms))
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
        for cname, (lengths, n_pages, H_, Hkv_, maxp) in Q_CASES.items():
            q_case(cname, lengths, n_pages, dt, H_, Hkv_, maxp)
            n += 1
    need(all(ms < plain_ms for _, ms, plain_ms in timed),
         f"paged_decode_q slower than its plain version: {timed}")
    report["paged_decode_q"]["max_abs_err"] = worst
    print(f"phase 4 paged_decode_q: {n} cases within tolerance (<= 2 "
          f"requantization flips), max abs err {worst:.3g}; poisoned unread "
          f"pages and rows ignored; cluster split up to 8 blocks at "
          f"max_pages 256 and 1024 (scratch), H/Hkv 16 and 1")


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


def serve(cfg, params, prompts, new_tokens, *, decode_kernel=True,
          num_slots=4, max_seq=256):
    from repro_torch.runtime.serve import Engine
    with Engine(cfg, params, num_slots=num_slots, max_seq=max_seq,
                decode_kernel=decode_kernel, prefix_cache=False,
                device="cuda") as eng:
        reqs = [eng.submit(p, new_tokens) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = eng.n_ticks * eng.decode_steps
        forwards = steps + eng.n_admit_calls
        streams = [list(r.out_tokens) for r in reqs]
        done = sum(r.done for r in reqs)
        ttft = [r.ttft for r in results if r.ttft is not None]
    return dict(streams=streams, done=done, wall=wall, steps=steps,
                forwards=forwards, ttft=ttft,
                tokens=sum(len(s) for s in streams))


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
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n))
               for n in rng.integers(17, 121, size=8)]
    counters = _counters()
    per_layer = 7 * cfg.num_layers + 1         # wq wk wv wo gate up down + unembed
    totals = {k: 0 for k in counters}
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
    report["profile"] = profile_serve(cfg, params, prompts[:4])
    report["profile_int8_kv"] = profile_serve(cfg.replace(quant_kv=True),
                                              params, prompts[:4])
    del params
    torch.cuda.empty_cache()


def profile_serve(cfg, params, prompts):
    """Where the time goes: one short serve (4 requests x 8 tokens) under
    torch.profiler; device-busy share of the wall time and device time by
    kernel name.  The profiler slows the host, so its wall time is not the
    serve's tok/s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run = serve(cfg, params, prompts, 8)
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    wall = run["wall"] * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    if not by_name:
        print("phase 5 profile: the profiler saw no device kernels; device "
              "time not measured")
        return {"device_busy_ms": None, "wall_ms": wall}
    # the matmul's kernels under every template instantiation
    matmul = {k: sum(t for n, t in by_name.items() if k in n)
              for k in ("bramac_accumulate", "bramac_epilogue")}
    attn_name = "paged_decode_q_kernel" if cfg.quant_kv else \
        "paged_decode_kernel"
    attn = sum(t for n, t in by_name.items() if attn_name in n)
    print(f"phase 5 profile (4 requests x 8 tokens, "
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
    q8 = QuantConfig(enabled=True, bits_w=8, bits_a=8)
    cfg = get_config("granite-8b").replace(num_layers=2, dtype="float32",
                                           quant=q8)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = tree_prepare_serving(M.init_params(cfg, gen, "cuda"), q8)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n))
               for n in (15, 16, 17, 33, 5, 48)]
    for quant_kv in (False, True):
        c = cfg.replace(quant_kv=quant_kv)
        on = serve(c, params, prompts, 12, decode_kernel=True, num_slots=3,
                   max_seq=96)["streams"]
        off = serve(c, params, prompts, 12, decode_kernel=False, num_slots=3,
                    max_seq=96)["streams"]
        need(on == off, f"kernel-on != kernel-off streams "
             f"({'int8' if quant_kv else 'fp'} KV): {on} vs {off}")
    print("phase 6 streams: kernel-on == kernel-off greedy streams at full "
          "width, 2 layers, f32 (fp KV and int8 KV; 6 requests, 3 slots)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    smi = smi_line()
    t0 = time.perf_counter()
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
    phase_streams()
    print(f"timing: {len(HOST_BOUND)} readings in which an enqueue outlasted "
          f"the device spin" + (f": {HOST_BOUND}" if HOST_BOUND else ""))
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
