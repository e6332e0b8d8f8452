"""The port's kernel modules on the CPU (their plain versions) vs the JAX
package's Pallas kernels in interpret mode and its jnp oracles.

A CPU tensor takes the plain version and never launches a kernel: the
launch counters stay at 0.  The CUDA kernels themselves are held against
these plain versions on the card by chip_smoke.py."""
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import qrange
from repro.kernels import ops as jops
from repro.kernels import paged_attention as jpk
from repro.kernels import ref as jref
from repro.kernels.bramac_matmul import bramac_matmul as j_bramac_matmul
from repro.models import attention as JA
from repro_torch.kernels import bramac_matmul as tbm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpk
from repro_torch.kernels import ref as tref

jax.config.update("jax_platform_name", "cpu")

BITS = [2, 4, 8]


def rand_q(rng, bits, shape, signed=True):
    lo, hi = qrange(bits) if signed else (0, (1 << bits) - 1)
    return rng.integers(lo, hi + 1, size=shape, dtype=np.int8)


def _scales(rng, M, N, per_channel=True):
    if not per_channel:
        return np.ones((1, 1), np.float32) * 0.75, \
            np.ones((1, 1), np.float32) * 1.25
    return rng.uniform(0.5, 2.0, (M, 1)).astype(np.float32), \
        rng.uniform(0.5, 2.0, (1, N)).astype(np.float32)


def _both(xq, wq, xs, ws, **kw):
    """(JAX ops.quant_matmul — the Pallas kernel in interpret mode on the
    CPU —, JAX exact oracle, port quant_matmul) as numpy."""
    od = kw.pop("out_dtype", "float32")
    j = jops.quant_matmul(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(xs),
                          jnp.asarray(ws), out_dtype=jnp.dtype(od), **kw)
    e = jref.quant_matmul_exact(jnp.asarray(xq), jnp.asarray(wq),
                                jnp.asarray(xs), jnp.asarray(ws),
                                out_dtype=jnp.dtype(od))
    t = tops.quant_matmul(torch.from_numpy(xq), torch.from_numpy(wq),
                          torch.from_numpy(xs), torch.from_numpy(ws),
                          out_dtype=getattr(torch, od), **kw)
    return (np.asarray(j, np.float32), np.asarray(e, np.float32),
            t.to(torch.float32).numpy())


@pytest.mark.parametrize("bits_a", BITS)
@pytest.mark.parametrize("bits_w", BITS)
@pytest.mark.parametrize("shape", [(8, 16, 8), (16, 32, 24), (3, 100, 77)])
def test_quant_matmul_bit_exact(bits_a, bits_w, shape):
    """The plain digit-pass matmul equals the Pallas kernel (interpret) and
    the exact integer oracle bit for bit, ragged M/K/N included."""
    M, K, N = shape
    rng = np.random.default_rng(hash((bits_a, bits_w, shape)) % 2**31)
    xq, wq = rand_q(rng, bits_a, (M, K)), rand_q(rng, bits_w, (K, N))
    xs, ws = _scales(rng, M, N)
    j, e, t = _both(xq, wq, xs, ws, bits_a=bits_a, bits_w=bits_w)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, e)


@pytest.mark.parametrize("case", ["unsigned", "packed", "bf16", "scalar"])
def test_quant_matmul_variants_bit_exact(case):
    """Unsigned activations (-1 at 4 bits means 15), 4-bit pair-packed
    weights, bf16 output (one rounding of the same f32 epilogue) and (1,1)
    scales: bit-exact vs the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(11)
    M, K, N = 16, 64, 32
    xq = rand_q(rng, 4, (M, K), signed=case != "unsigned")
    wq = rand_q(rng, 4, (K, N))
    xs, ws = _scales(rng, M, N, per_channel=case != "scalar")
    kw = dict(bits_a=4, bits_w=4, signed=case != "unsigned",
              w_packed=case == "packed")
    if case == "bf16":
        kw["out_dtype"] = "bfloat16"
    j, e, t = _both(xq, wq, xs, ws, **kw)
    np.testing.assert_array_equal(t, j)
    if case != "unsigned":
        np.testing.assert_array_equal(t, e)


def test_bramac_matmul_wrapper_packed_and_block_independent():
    """The kernel wrapper takes (K/2, N) pair-packed storage directly, and
    its plain version matches the Pallas kernel at two block shapes."""
    rng = np.random.default_rng(7)
    M, K, N = 32, 64, 32
    xq, wq = rand_q(rng, 4, (M, K)), rand_q(rng, 4, (K, N))
    xs, ws = _scales(rng, M, N)
    from repro_torch.core import quant as tq
    wp = tq.pack_bits(torch.from_numpy(wq).T, 4).T.contiguous()
    t = tbm.bramac_matmul(torch.from_numpy(xq), wp, torch.from_numpy(xs),
                          torch.from_numpy(ws), bits_a=4, bits_w=4,
                          w_packed=True).numpy()
    for block in [(16, 16, 16), (8, 32, 16)]:
        j = j_bramac_matmul(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(xs),
                            jnp.asarray(ws), bits_a=4, bits_w=4, block=block,
                            interpret=True)
        np.testing.assert_array_equal(t, np.asarray(j))
    d = tref.quant_matmul_digit_ref(torch.from_numpy(xq), torch.from_numpy(wq),
                                    torch.from_numpy(xs), torch.from_numpy(ws),
                                    bits_a=4)
    np.testing.assert_array_equal(t, d.numpy())
    w = rand_q(rng, 8, (8, 6))
    x = rand_q(rng, 8, (6,))
    np.testing.assert_array_equal(
        tref.mac2_mvm_ref(torch.from_numpy(w), torch.from_numpy(x)).numpy(),
        np.asarray(jref.mac2_mvm_ref(jnp.asarray(w), jnp.asarray(x))))


GRANITE_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
              (4096, 49152)]


@pytest.mark.parametrize("sms", [132, 114, 8])
@pytest.mark.parametrize("M", [1, 4, 16, 17, 64])
@pytest.mark.parametrize("KN", GRANITE_KN + [(100, 77), (4100, 136), (0, 8)])
def test_bramac_matmul_launch_plan(KN, M, sms):
    """The CUDA kernel's launch plan: 16-row blocks up to M=16 and 64-row
    blocks above; the K ranges of the splits cover K exactly once, every
    one but the last a whole number of 64-byte K steps; the grid fills at
    least one wave of SMs wherever the K steps allow it."""
    K, N = KN
    bm, splits, kps = tbm._plan(M, K, N, sms)
    assert bm == (16 if M <= 16 else 64)
    assert kps > 0 and kps % tbm.BK == 0
    ranges = [(s * kps, min(K, (s + 1) * kps)) for s in range(splits)]
    assert all(b < e for b, e in ranges) or K == 0
    covered = [k for b, e in ranges for k in range(b, e)]
    assert covered == list(range(K))
    tiles = -(-N // tbm.BN) * -(-M // bm)
    steps = max(1, -(-K // tbm.BK))
    assert tiles * splits >= min(sms, tiles * steps)


# --- paged decode -----------------------------------------------------------

PS = 16


def _pool(seed, B, n_pages, max_pages=4, P=16, Hkv=2, hd=16, ps=PS):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(P, ps, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(P, ps, Hkv, hd)).astype(np.float32)
    tables = rng.permutation(P)[:B * max_pages].reshape(B, max_pages) \
        .astype(np.int32)
    return k, v, tables, np.asarray(n_pages, np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("lengths", [(15, 16, 17), (1, 32, 33), (48, 2, 31)])
def test_paged_decode_matches_jax(lengths):
    """Plain paged_decode vs the Pallas kernel (interpret): live lengths
    below / at / across page boundaries.  atol 2e-6: fp32 reassociation
    (the reference suite's own kernel-vs-oracle bound)."""
    B, H = 3, 4
    n_pages = [-(-n // PS) for n in lengths]
    k, v, tables, npg = _pool(0, B, n_pages)
    q = np.random.default_rng(9).normal(size=(B, H, 16)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    want = jpk.paged_decode(*map(jnp.asarray, (q, k, v, tables, npg, lens)))
    got = tpk.paged_decode(*_t(q, k, v, tables, npg, lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_paged_decode_free_slot_and_poisoned_pages():
    """n_pages=0 emits exact zeros; pages no sequence owns are poisoned
    with 1e9 and the output does not move (bit-identical)."""
    k, v, tables, npg = _pool(1, 3, [0, 1, 2])
    q = np.random.default_rng(3).normal(size=(3, 4, 16)).astype(np.float32)
    lens = np.asarray([1, PS, 2 * PS], np.int32)
    got = tpk.paged_decode(*_t(q, k, v, tables, npg, lens)).numpy()
    live = np.zeros(k.shape[0], bool)
    for b, n in enumerate(npg):
        live[tables[b, :n]] = True
    kb = np.where(live[:, None, None, None], k, 1e9).astype(np.float32)
    vb = np.where(live[:, None, None, None], v, 1e9).astype(np.float32)
    bad = tpk.paged_decode(*_t(q, kb, vb, tables, npg, lens)).numpy()
    np.testing.assert_array_equal(got, bad)
    assert (got[0] == 0).all() and np.isfinite(got).all()
    want = jpk.paged_decode(*map(jnp.asarray, (q, kb, vb, tables, npg, lens)))
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("lengths", [(15, 16, 17), (1, 33, 48)])
def test_paged_decode_q_matches_jax(lengths):
    """Plain int8 paged_decode_q vs the Pallas kernel (interpret) on the
    reference's own quantized rows; atol 1e-6 as the reference suite (only
    the normalizer's association order differs)."""
    B, H = 3, 4
    n_pages = [-(-n // PS) for n in lengths]
    k, v, tables, npg = _pool(7, B, n_pages)
    kq, kss = JA._quant_rows(jnp.asarray(k))
    vq, vss = JA._quant_rows(jnp.asarray(v))
    q = np.random.default_rng(11).normal(size=(B, 1, H, 16)).astype(np.float32)
    qq, qs = JA._quant_rows(jnp.asarray(q))
    lens = np.asarray(lengths, np.int32)
    args = [np.asarray(a) for a in (qq[:, 0], qs[:, 0], kq, kss, vq, vss)] \
        + [tables, npg, lens]
    want = jpk.paged_decode_q(*map(jnp.asarray, args), jnp.float32)
    got = tpk.paged_decode_q(*_t(*args), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _q_split_emulation(q, qs, k, ks, v, vs, tables, n_pages, lengths):
    """paged_decode_q as the CUDA kernel splits it, in f32 as the kernel
    computes: a cluster of S blocks per (sequence, KV head) from
    `_plan_q`, block s over pages [s*pps, (s+1)*pps) of the walked ones;
    per-block max, then the cluster max; per-block l = sum exp(s-m) and
    u = max exp(s-m)*vs, summed in rank order and maxed; pq per row; the
    blocks' int32 partial PVs summed exactly; rank 0's acc*pscale."""
    B, H, hd = q.shape
    P, ps, Hkv = k.shape[:3]
    g, mp = H // Hkv, tables.shape[1]
    S, pps, _ = tpk._plan_q(mp, ps, g, hd)
    f32 = torch.float32
    out = torch.zeros((B, H, hd), dtype=f32)
    for b in range(B):
        L = int(lengths[b])
        n_eff = min(int(n_pages[b]), -(-L // ps), mp)
        for h in range(Hkv):
            qh = q[b, h * g:(h + 1) * g].to(torch.int64)       # (g, hd)
            qsh = qs[b, h * g:(h + 1) * g].to(f32)
            blocks = []
            for s in range(S):
                pages = range(s * pps, min((s + 1) * pps, n_eff))
                if not pages:
                    blocks.append(None)
                    continue
                pids = [int(tables[b, j]) for j in pages]
                kr = k[pids, :, h].reshape(-1, hd).to(torch.int64)
                dot = (qh @ kr.T).to(f32)                       # exact
                sc = dot * qsh[:, None] * ks[pids, :, h].reshape(1, -1) \
                    / torch.tensor(math.sqrt(hd), dtype=f32)
                rows = torch.arange(len(pids) * ps) + pages[0] * ps
                live = rows < L
                sc = torch.where(live[None], sc, torch.tensor(-1e30, dtype=f32))
                vsr = torch.where(live, vs[pids, :, h].reshape(-1), 0.0)
                blocks.append((sc, vsr, v[pids, :, h].reshape(-1, hd)))
            neg = torch.full((g,), -math.inf, dtype=f32)
            m = torch.stack([neg if bl is None else bl[0].amax(1)
                             for bl in blocks]).amax(0)
            l, u = torch.zeros(g, dtype=f32), torch.zeros(g, dtype=f32)
            es = []
            for bl in blocks:                                   # rank order
                if bl is None:
                    es.append(None)
                    continue
                e = torch.exp(bl[0] - m[:, None])
                es.append(e)
                l = l + e.sum(1)
                u = torch.maximum(u, (e * bl[1][None]).amax(1))
            l = torch.where(l > 0, l, torch.ones_like(l))
            pscale = torch.clamp(u / l, min=1e-6) / 127.0
            acc = torch.zeros((g, hd), dtype=torch.int64)
            for bl, e in zip(blocks, es):
                if bl is None:
                    continue
                p = e / l[:, None] * bl[1][None]
                pq = torch.clamp(torch.round(p / pscale[:, None]), -127, 127)
                acc += pq.to(torch.int64) @ bl[2].to(torch.int64)
            out[b, h * g:(h + 1) * g] = acc.to(f32) * pscale[:, None]
    return out


def test_paged_decode_q_cluster_split_matches_jax():
    """The int8 kernel's S-way cluster split, emulated on the CPU, against
    the plain version and the Pallas kernel (interpret), atol 1e-6 as the
    existing int8 test: max_pages 16 gives 8 blocks of 2 pages, and the
    lengths walk 1, 3 and 8 of them, beside a free slot (n_pages = 0)."""
    B, H, mp = 4, 4, 16
    lengths, n_pages = (20, 90, 250, 5), [2, 6, 16, 0]
    assert tpk._plan_q(mp, PS, 2, 16)[:2] == (8, 2)
    pages = [-(-n // PS) for n in lengths[:3]]
    assert [-(-p // 2) for p in pages] == [1, 3, 8]        # blocks walked
    k, v, tables, npg = _pool(5, B, n_pages, max_pages=mp, P=64)
    kq, kss = JA._quant_rows(jnp.asarray(k))
    vq, vss = JA._quant_rows(jnp.asarray(v))
    q = np.random.default_rng(13).normal(size=(B, 1, H, 16)).astype(np.float32)
    qq, qs = JA._quant_rows(jnp.asarray(q))
    lens = np.asarray(lengths, np.int32)
    args = [np.asarray(a) for a in (qq[:, 0], qs[:, 0], kq, kss, vq, vss)] \
        + [tables, npg, lens]
    got = _q_split_emulation(*_t(*args))
    plain = tpk.paged_decode_q(*_t(*args), torch.float32)
    want = jpk.paged_decode_q(*map(jnp.asarray, args), jnp.float32)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert (got[3] == 0).all()


@pytest.mark.parametrize("max_pages", [0, 1, 3, 8, 16, 17, 100, 256, 1024])
@pytest.mark.parametrize("g,hd", [(1, 128), (4, 128), (16, 128), (4, 16),
                                  (16, 256), (2, 100)])
def test_paged_decode_q_split_plan(max_pages, g, hd):
    """The int8 kernel's cluster split comes from host-known sizes alone
    (no lengths argument): at most 8 blocks, each starting inside the
    table, whose page ranges cover the table exactly once; scores in
    shared memory up to the limit, else a device scratch buffer."""
    assert list(inspect.signature(tpk._plan_q).parameters) == \
        ["max_pages", "page_size", "g", "hd"]
    S, pps, scratch = tpk._plan_q(max_pages, PS, g, hd)
    assert 1 <= S <= tpk.MAX_SPLITS and pps >= 1
    assert (S - 1) * pps < max(1, max_pages) <= S * pps or max_pages == 0
    covered = [j for s in range(S)
               for j in range(s * pps, min((s + 1) * pps, max_pages))]
    assert covered == list(range(max_pages))
    assert scratch == (tpk._q_smem(g, hd, pps * PS, False) > tpk.Q_SMEM_LIMIT)
    assert tpk._q_smem(g, hd, pps * PS, scratch) <= tpk.Q_SMEM_LIMIT
    if max_pages == 16 and g == 4:                     # the serve shape
        assert (S, pps, scratch) == (8, 2, False)
    if max_pages == 1024 and g == 16:
        assert scratch


def _fp_split_emulation(q, k, v, tables, n_pages, lengths):
    """paged_decode as the CUDA kernel splits it, in f32 as the kernel
    computes: a cluster of S blocks per (sequence, KV head) from
    `_plan_fp`, block s over the live rows (below the length) of pages
    [s*pps, (s+1)*pps) of the walked ones, folded `tile` rows at a time
    (one ring stage) into a running (m, l, acc) with the reference's
    rescale; then the blocks' partials combined in rank order with weights
    exp(m_s - M) where l_s > 0 and 0 elsewhere, out = acc / l (l = 0: 1)."""
    B, H, hd = q.shape
    P, ps, Hkv = k.shape[:3]
    g, mp = H // Hkv, tables.shape[1]
    S, pps, tile = tpk._plan_fp(mp, hd, k.element_size())
    f32 = torch.float32
    div = torch.tensor(math.sqrt(hd), dtype=f32)
    out = torch.zeros((B, H, hd), dtype=f32)
    for b in range(B):
        L = int(lengths[b])
        n_eff = min(int(n_pages[b]), -(-L // ps), mp)
        for h in range(Hkv):
            qh = q[b, h * g:(h + 1) * g].to(f32)
            parts = []
            for s in range(S):
                j0, j1 = s * pps, min((s + 1) * pps, n_eff)
                rows = min((j1 - j0) * ps, L - j0 * ps) if j1 > j0 else 0
                pids = [int(tables[b, j]) for j in range(j0, j1)]
                kr = k[pids, :, h].reshape(-1, hd)[:rows].to(f32)
                vr = v[pids, :, h].reshape(-1, hd)[:rows].to(f32)
                m = torch.full((g,), -math.inf, dtype=f32)
                l, acc = torch.zeros(g), torch.zeros((g, hd))
                for r0 in range(0, rows, tile):
                    sc = (qh @ kr[r0:r0 + tile].T) / div
                    m_new = torch.maximum(m, sc.amax(1))
                    p = torch.exp(sc - m_new[:, None])
                    corr = torch.exp(m - m_new)
                    l = l * corr + p.sum(1)
                    acc = acc * corr[:, None] + p @ vr[r0:r0 + tile]
                    m = m_new
                parts.append((m, l, acc))
            M = torch.stack([m for m, _, _ in parts]).amax(0)
            l_tot, acc_tot = torch.zeros(g), torch.zeros((g, hd))
            for m, l, acc in parts:                             # rank order
                w = torch.where(l > 0, torch.exp(m - M), 0.0)
                l_tot = l_tot + w * l
                acc_tot = acc_tot + w[:, None] * acc
            out[b, h * g:(h + 1) * g] = \
                acc_tot / torch.where(l_tot > 0, l_tot, 1.0)[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("mp,ps,lengths,n_pages", [
    # 8 blocks of 2 pages: the lengths walk 1, 3, 8 and 2 blocks (the last
    # slot owns 6 pages past ceil(40/16) = 3); a free slot
    (16, 16, (20, 90, 250, 5, 40), (2, 6, 16, 0, 6)),
    # 8 blocks of 8 pages of 12 rows: three 32-row ring tiles a block,
    # two ending inside a page; a last block that ends inside its last
    # page; a free slot; n_pages past ceil(250/12) = 21
    (64, 12, (700, 250, 13, 40), (64, 30, 2, 0)),
])
def test_paged_decode_cluster_split_matches_jax(mp, ps, lengths, n_pages):
    """The fp kernel's S-way cluster split and ring tiles, emulated on the
    CPU, against the plain version and the Pallas kernel (interpret) at
    atol 2e-6, the bound of test_paged_decode_matches_jax: blocks that
    walk no page, and a free slot, weigh nothing and give zeros."""
    _check_fp_split(mp, ps, 16, 32, lengths, n_pages)


def test_paged_decode_cluster_split_tile16_matches_jax():
    """As above at hd 160 with f32 pools: 640-byte rows, so the ring takes
    16-row tiles, here ending inside 12-row pages.  8 blocks of 2 pages;
    the lengths walk 1, 4, 8 and 2 blocks (the last slot owns 2 pages past
    ceil(40/12) = 4); a free slot."""
    _check_fp_split(16, 12, 160, 16, (20, 90, 190, 5, 40), (2, 8, 16, 0, 6))


def _check_fp_split(mp, ps, hd, tile_want, lengths, n_pages):
    B, H = len(lengths), 4
    S, pps, tile = tpk._plan_fp(mp, hd, 4)
    assert (S, pps) == (8, mp // 8) and tile == tile_want
    k, v, tables, npg = _pool(17, B, n_pages, max_pages=mp, P=B * mp, hd=hd,
                              ps=ps)
    q = np.random.default_rng(19).normal(size=(B, H, hd)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    got = _fp_split_emulation(*_t(q, k, v, tables, npg, lens))
    plain = tpk.paged_decode(*_t(q, k, v, tables, npg, lens))
    want = jpk.paged_decode(*map(jnp.asarray, (q, k, v, tables, npg, lens)))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=2e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    free = list(n_pages).index(0)
    assert (got[free] == 0).all() and torch.isfinite(got).all()


@pytest.mark.parametrize("max_pages", [0, 1, 3, 8, 16, 17, 100, 256, 1024])
@pytest.mark.parametrize("g,hd", [(1, 128), (4, 128), (16, 128), (4, 16),
                                  (16, 256), (2, 100)])
def test_paged_decode_fp_split_plan(max_pages, g, hd):
    """The fp kernel's plan comes from host-known sizes alone (no lengths
    argument) and splits as the int8 kernel's does: at most 8 blocks, each
    starting inside the table, whose page ranges cover the table exactly
    once; ring tiles of 32 rows (16 where 32 rows of K would pass the
    K-tile budget) for f32 and bf16 pools.  Whether a plan's shared memory
    fits is the kernel's to say: chip_smoke.py phase 3 launches the largest
    plan (H/Hkv 16, hd 256, max_pages 1024)."""
    assert list(inspect.signature(tpk._plan_fp).parameters) == \
        ["max_pages", "hd", "kv_itemsize"]
    for itemsize in (4, 2):
        S, pps, tile = tpk._plan_fp(max_pages, hd, itemsize)
        assert (S, pps) == tpk._plan_q(max_pages, PS, g, hd)[:2]
        assert 1 <= S <= tpk.MAX_SPLITS and pps >= 1
        covered = [j for s in range(S)
                   for j in range(s * pps, min((s + 1) * pps, max_pages))]
        assert covered == list(range(max_pages))
        assert all(s * pps < max_pages for s in range(S)) or max_pages == 0
        row = -(-hd * itemsize // 16) * 16
        assert tile == (32 if 32 * row <= tpk.FP_TILE_BYTES else 16)
    if max_pages == 16 and hd == 128:                  # the serve shape
        assert tpk._plan_fp(max_pages, hd, 2) == (8, 2, 32)


def test_cpu_tensors_launch_no_kernel():
    """Every launch counter stays at 0 when the tensors live on the CPU."""
    before = (tbm.bramac_matmul.launches, tpk.paged_decode.launches,
              tpk.paged_decode_q.launches)
    test_paged_decode_free_slot_and_poisoned_pages()
    rng = np.random.default_rng(0)
    xq, wq = rand_q(rng, 8, (4, 8)), rand_q(rng, 8, (8, 4))
    xs, ws = _scales(rng, 4, 4)
    tops.quant_matmul(*_t(xq, wq, xs, ws), bits_a=8, bits_w=8)
    k, v, tables, npg = _pool(2, 2, [1, 1])
    kq = torch.from_numpy(k).to(torch.int8)
    sc = torch.ones(k.shape[:3])
    tpk.paged_decode_q(torch.zeros((2, 4, 16), dtype=torch.int8),
                       torch.ones((2, 4)), kq, sc, kq, sc,
                       *_t(tables, npg, np.asarray([3, 5], np.int32)),
                       torch.float32)
    assert before == (0, 0, 0)
    assert (tbm.bramac_matmul.launches, tpk.paged_decode.launches,
            tpk.paged_decode_q.launches) == (0, 0, 0)


def test_kv_accounting_matches_jax():
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    for arch in ("granite-8b", "minicpm3-4b"):
        for smoke in (True, False):
            for qkv in (False, True):
                jc = jget(arch, smoke=smoke).replace(quant_kv=qkv)
                tc = tget(arch, smoke=smoke).replace(quant_kv=qkv)
                assert tpk.kv_row_bytes(tc) == jpk.kv_row_bytes(jc)
    lens = [0, 5, 16, 17, 40]
    assert tpk.decode_read_rows(lens, 16) == jpk.decode_read_rows(lens, 16)
    assert tpk.oracle_read_rows(4, 64) == jpk.oracle_read_rows(4, 64)
