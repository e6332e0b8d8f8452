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

def phase_matmul(gen, report):
    from repro_torch.core import quant
    from repro_torch.kernels import bramac_matmul as bm

    worst = 0.0

    def offset_view(t, off):
        # the same values in a contiguous view that starts `off` bytes into
        # its storage, so the base pointer is not 4-byte aligned
        buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
        v = buf[off:].view(t.shape)
        v.copy_(t)
        return v

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
            x, wq = offset_view(x, off), offset_view(wq, 4 - off)
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
    # multiples of 4, where the kernel would otherwise load 4-byte words)
    for off in (1, 2, 3):
        for packed in (False, True):
            case(8, 64, 128, 4, True, packed, torch.float32, True, off=off)
            n += 1
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
    print(f"phase 2 bramac_matmul: {n} cases bit-exact vs plain, max abs "
          f"err {worst:.3g} (bits 2/4/8, signed+unsigned, 4-bit packed, "
          f"f32+bf16 out, scalar and per-channel scales, ragged, unaligned "
          f"views and granite shapes)")
    main = next(r for r in rows if r["shape"] == "w_gate/w_up" and r["M"] == 4)
    report["bramac_matmul"] = dict(
        name="bramac_matmul", route="cuda",
        source="src/repro_torch/kernels/csrc/bramac_matmul.cu",
        replaces="src/repro/kernels/bramac_matmul.py:47", max_abs_err=worst,
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"],
        shapes=rows)


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


def _pool_case(gen, lengths, n_pages):
    """Block tables over a pool of B*MAXP pages, and the (P, ps) mask of
    the rows the reference reads: the first min(n_pages, ceil(len/ps))
    pages of each table, rows below the length.  Everything else (pages no
    table lists, owned pages past the length, rows past the length in the
    last page) is to be poisoned by the caller."""
    P = B * MAXP
    tables = torch.randperm(P, generator=gen, device="cuda")[:B * MAXP] \
        .reshape(B, MAXP).to(torch.int32)
    read = torch.zeros(P, PS, dtype=torch.bool, device="cuda")
    for b, (L, n) in enumerate(zip(lengths, n_pages)):
        for j in range(min(n, -(-L // PS))):
            read[tables[b, j].long(), :max(0, min(PS, L - j * PS))] = True
    return (tables, torch.tensor(n_pages, dtype=torch.int32, device="cuda"),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"), read)


def _live_rows(lengths, n_pages):
    return sum(min(n, -(-L // PS)) * PS for L, n in zip(lengths, n_pages))


def phase_paged(gen, report):
    from repro_torch.kernels import paged_attention as pa
    worst = 0.0
    for dt, atol in ((torch.float32, 2e-6), (torch.bfloat16, 8e-3)):
        # f32: fp32 reassociation (pages summed online vs one softmax), the
        # reference suite's own kernel-vs-oracle bound; bf16: the same
        # sums rounded once to bf16 (2^-8 relative on O(1) outputs)
        for cname, (lengths, n_pages) in CASES.items():
            tables, npg, lens, read = _pool_case(gen, lengths, n_pages)
            q = torch.randn(B, H, HD, generator=gen, device="cuda").to(dt)
            k = torch.randn(B * MAXP, PS, HKV, HD, generator=gen,
                            device="cuda").to(dt)
            v = torch.randn(B * MAXP, PS, HKV, HD, generator=gen,
                            device="cuda").to(dt)
            got = pa.paged_decode(q, k, v, tables, npg, lens)
            want = pa.paged_decode_plain(q, k, v, tables, npg, lens)
            # every row the reference does not read is poisoned: the output
            # must not move
            ok = read[:, :, None, None]
            got_p = pa.paged_decode(q, torch.where(ok, k, 1e9),
                                    torch.where(ok, v, 1e9), tables, npg,
                                    lens)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            worst = max(worst, err)
            need(err <= atol + atol * want.float().abs().max().item(),
                 f"paged_decode {cname} {dt}: max err {err} > {atol}")
            need(torch.equal(got, got_p),
                 f"paged_decode {cname} {dt}: poisoned pages changed output")
            if 0 in n_pages:
                need(bool((got[list(n_pages).index(0)] == 0).all()),
                     "paged_decode: a slot without pages must emit zeros")
            if cname == "serve" and dt == torch.bfloat16:
                rows = _live_rows(lengths, n_pages)
                nbytes = 2 * rows * HKV * HD * 2 + 2 * (2 * B * H * HD) \
                    + 4 * (B * MAXP + 2 * B)
                ops = 4 * rows * H * HD
                bound = max(nbytes / HBM_BYTES_PER_S,
                            ops / FP32_OPS_PER_S) * 1e3
                by = "bytes" if nbytes / HBM_BYTES_PER_S >= \
                    ops / FP32_OPS_PER_S else "operations"
                ms = time_cold(lambda: pa.paged_decode(q, k, v, tables, npg,
                                                       lens))
                plain_ms = time_cold(lambda: pa.paged_decode_plain(
                    q, k, v, tables, npg, lens))
                report["paged_decode"] = dict(
                    name="paged_decode", route="cuda",
                    source="src/repro_torch/kernels/csrc/paged_attention.cu",
                    replaces="src/repro/kernels/paged_attention.py:79",
                    ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                    library_ms=None)
                print(f"  paged_decode bf16 B={B} lengths={lengths}: "
                      f"{ms:.4f} ms (bound {bound:.5f} ms by {by}, plain "
                      f"{plain_ms:.4f} ms)")
    report["paged_decode"]["max_abs_err"] = worst
    print(f"phase 3 paged_decode: {2 * len(CASES)} cases within tolerance "
          f"(f32 atol 2e-6, bf16 8e-3), max abs err {worst:.3g}; poisoned "
          f"unread pages and rows ignored; free slot emits zeros")

    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        for cname, (lengths, n_pages) in CASES.items():
            tables, npg, lens, read = _pool_case(gen, lengths, n_pages)
            P = B * MAXP
            k = torch.randint(-127, 128, (P, PS, HKV, HD), generator=gen,
                              device="cuda").to(torch.int8)
            v = torch.randint(-127, 128, (P, PS, HKV, HD), generator=gen,
                              device="cuda").to(torch.int8)
            ks = torch.rand(P, PS, HKV, generator=gen, device="cuda") * 0.02
            vs = torch.rand(P, PS, HKV, generator=gen, device="cuda") * 0.02
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
            if cname == "serve" and dt == torch.bfloat16:
                rows = _live_rows(lengths, n_pages)
                nbytes = 2 * rows * HKV * (HD + 4) + B * H * (HD + 4) \
                    + 2 * B * H * HD + 4 * (B * MAXP + 2 * B)
                ops = 4 * rows * H * HD
                bound = max(nbytes / HBM_BYTES_PER_S,
                            ops / INT8_OPS_PER_S) * 1e3
                by = "bytes" if nbytes / HBM_BYTES_PER_S >= \
                    ops / INT8_OPS_PER_S else "operations"
                ms = time_cold(lambda: pa.paged_decode_q(*args, dt))
                plain_ms = time_cold(lambda: pa.paged_decode_q_plain(
                    *args, dt))
                report["paged_decode_q"] = dict(
                    name="paged_decode_q", route="cuda",
                    source="src/repro_torch/kernels/csrc/paged_attention.cu",
                    replaces="src/repro/kernels/paged_attention.py:111",
                    ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                    library_ms=None)
                print(f"  paged_decode_q bf16 B={B} lengths={lengths}: "
                      f"{ms:.4f} ms (bound {bound:.5f} ms by {by}, plain "
                      f"{plain_ms:.4f} ms)")
    report["paged_decode_q"]["max_abs_err"] = worst
    print(f"phase 4 paged_decode_q: {2 * len(CASES)} cases within "
          f"tolerance (<= 2 requantization flips), max abs err {worst:.3g}; "
          f"poisoned unread pages and rows ignored")


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
          f"and out of the bits range, the 105 Fig 11 shapes); odd C raises; "
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
    del params
    torch.cuda.empty_cache()


def profile_serve(cfg, params, prompts):
    """Where the time goes: one short bf16-KV serve (4 requests x 8 tokens)
    under torch.profiler; device-busy share of the wall time and device
    time by kernel name.  The profiler slows the host, so its wall time is
    not the serve's tok/s."""
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
    print(f"phase 5 profile (4 requests x 8 tokens, bf16 KV): device busy "
          f"{busy:.1f} ms of {wall:.1f} ms wall ({100 * busy / wall:.1f}%); "
          f"top kernels (ms): " + "; ".join(
              f"{n[:60]}={t:.1f}" for n, t in top))
    return {"device_busy_ms": busy, "wall_ms": wall, "forwards":
            run["forwards"], "steps": run["steps"],
            "top_kernels_ms": dict(top)}


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
