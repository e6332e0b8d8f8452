"""The port's Algorithm 1 (`repro_torch.core.mac2`) and dummy-array kernel
wrapper (`repro_torch.kernels.mac2_kernel`) on the CPU vs the JAX package:
`repro.core.mac2` and the Pallas kernel `mac2_mvm_kernel` in interpret mode.
Inputs come from numpy with a fixed seed; integer results must be equal.

A CPU tensor takes the wrapper's plain version and launches no kernel; the
CUDA kernel itself is held against the plain version on the card by
chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.core import mac2 as jm
from repro.core.quant import qrange
from repro.kernels import ref as jref
from repro.kernels.mac2_kernel import mac2_mvm_kernel as j_kernel
from repro_torch.core import mac2 as tm
from repro_torch.kernels import mac2_kernel as tk
from repro_torch.kernels import ref as tref

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # smoke sizes: one intra-op thread per worker

BITS = [2, 4, 8]


def rand_q(rng, bits, shape, signed=True, dtype=np.int8):
    lo, hi = qrange(bits) if signed else (0, (1 << bits) - 1)
    return rng.integers(lo, hi + 1, size=shape).astype(dtype)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- Algorithm 1 -------------------------------------------------------------

@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("signed", [True, False])
def test_mac2_matches_jax(bits, signed):
    """Exhaustive over every (w1, w2, i1, i2) for 2/4-bit, sampled for
    8-bit (as tests/test_mac2.py): equal to the JAX MAC2 and the oracle."""
    lo, hi = qrange(bits) if signed else (0, (1 << bits) - 1)
    if bits <= 4:
        vals = np.arange(lo, hi + 1, dtype=np.int32)
    else:
        vals = np.array([lo, lo + 1, -3, -1, 0, 1, 2, 77, hi - 1, hi] if signed
                        else [0, 1, 2, 77, 128, 200, hi], dtype=np.int32)
    W1, W2, I1, I2 = (a.ravel() for a in
                      np.meshgrid(vals, vals, vals, vals, indexing="ij"))
    got = tm.mac2(_t(W1), _t(W2), _t(I1), _t(I2), bits=bits,
                  signed_inputs=signed)
    want = jm.mac2(jnp.asarray(W1), jnp.asarray(W2), jnp.asarray(I1),
                   jnp.asarray(I2), bits=bits, signed_inputs=signed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), W1 * I1 + W2 * I2)
    np.testing.assert_array_equal(
        tm.mac2_reference(_t(W1), _t(W2), _t(I1), _t(I2)).numpy(),
        np.asarray(jm.mac2_reference(W1, W2, I1, I2)))


@pytest.mark.parametrize("bits", BITS)
def test_mac2_broadcast_and_out_of_range(bits):
    """Scalar inputs broadcast over the lanes, and inputs outside the bits
    range are read through their unsigned bits-bit view, as in JAX."""
    rng = np.random.default_rng(bits)
    w1, w2 = rand_q(rng, bits, (40,), dtype=np.int32), \
        rand_q(rng, bits, (40,), dtype=np.int32)
    for i1, i2 in ((3, -2), (127, -128), (7, 300), (-1, 255)):
        for signed in (True, False):
            got = tm.mac2(_t(w1), _t(w2), i1, i2, bits=bits,
                          signed_inputs=signed)
            want = jm.mac2(jnp.asarray(w1), jnp.asarray(w2), i1, i2,
                           bits=bits, signed_inputs=signed)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert [tm.lane_width(b) for b in BITS] == [jm.lane_width(b) for b in BITS]
    with pytest.raises(ValueError):
        tm.mac2(_t(w1), _t(w2), 1, 1, bits=3)


@settings(max_examples=12, deadline=None)
@given(bits=st.sampled_from(BITS), seed=st.integers(0, 2**31 - 1),
       rows=st.integers(1, 16), colpairs=st.integers(1, 32),
       signed=st.booleans())
def test_mac2_mvm_matches_jax(bits, seed, rows, colpairs, signed):
    """All column pairs at once as lanes, then a sum over the pairs: equal
    to the JAX pair-by-pair loop, in and out of the bits range."""
    rng = np.random.default_rng(seed)
    w = rand_q(rng, bits, (rows, 2 * colpairs), dtype=np.int32)
    x = rng.integers(-128, 128, size=(2 * colpairs,)).astype(np.int32)
    got = tm.mac2_mvm(_t(w), _t(x), bits, signed_inputs=signed)
    want = jm.mac2_mvm(jnp.asarray(w), jnp.asarray(x), bits=bits,
                       signed_inputs=signed)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- the dummy-array kernel wrapper (plain version on the CPU) -------------

def _kernel_pair(w, x, bits, signed, block=128):
    got = tk.mac2_mvm_kernel(_t(w), _t(x), bits=bits, signed=signed)
    want = j_kernel(jnp.asarray(w), jnp.asarray(x), bits=bits, signed=signed,
                    block=block, interpret=True)
    assert got.dtype == torch.int32 and got.shape == (w.shape[0],)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("shape", [(8, 6), (16, 10), (40, 8)])
def test_mac2_mvm_kernel_matches_jax_kernel(bits, signed, shape):
    """At the JAX kernel test's shapes: equal to the Pallas kernel
    (interpret mode) and to the integer oracle on the inputs as read
    (unsigned 8-bit values above 127 are stored as negative int8)."""
    R, C = shape
    rng = np.random.default_rng(hash((bits, signed, shape)) % 2**31)
    w = rand_q(rng, bits, (R, C))
    x = rand_q(rng, bits, (C,), signed=signed)
    got, want = _kernel_pair(w, x, bits, signed)
    np.testing.assert_array_equal(got, want)
    xr = x.astype(np.int32) if signed else x.astype(np.int32) & 0xFF
    np.testing.assert_array_equal(got, tref.mac2_mvm_ref(_t(w), _t(xr)).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jref.mac2_mvm_ref(jnp.asarray(w), jnp.asarray(xr))))


@pytest.mark.parametrize("case", ["rows5_block5", "x_out_of_range_2bit",
                                  "x_out_of_range_4bit",
                                  "unsigned_8bit_negative_int8"])
def test_mac2_mvm_kernel_masking_matches_jax_kernel(case):
    """Inputs are masked to their unsigned bits-bit view as the Pallas
    kernel masks them: with bits=2 an input of 7 reads as 3 (signed: -1),
    and unsigned 8-bit inputs stored as negative int8 read as x + 256.
    R=5 runs as one 5-lane block on the JAX side."""
    rng = np.random.default_rng(17)
    if case == "rows5_block5":
        w, x = rand_q(rng, 4, (5, 12)), rand_q(rng, 4, (12,))
        for signed in (True, False):
            got, want = _kernel_pair(w, x, 4, signed, block=5)
            np.testing.assert_array_equal(got, want)
        return
    bits = {"x_out_of_range_2bit": 2, "x_out_of_range_4bit": 4,
            "unsigned_8bit_negative_int8": 8}[case]
    w = rand_q(rng, bits, (16, 14))
    x = rng.integers(-128, 128, size=(14,)).astype(np.int8)
    if bits == 2:
        x[:2] = (7, -7)
    for signed in ((False,) if bits == 8 else (True, False)):
        got, want = _kernel_pair(w, x, bits, signed, block=16)
        np.testing.assert_array_equal(got, want)
        u = x.astype(np.int32) & ((1 << bits) - 1)
        if signed:
            u = np.where(u >= 1 << (bits - 1), u - (1 << bits), u)
        np.testing.assert_array_equal(got, w.astype(np.int32) @ u)


def test_mac2_mvm_kernel_rejects_what_the_kernel_does_not_take():
    w, x = torch.zeros((4, 5), dtype=torch.int8), torch.zeros(5, dtype=torch.int8)
    with pytest.raises(ValueError, match="columns must pair up for MAC2"):
        tk.mac2_mvm_kernel(w, x, bits=4)
    with pytest.raises(ValueError, match="columns must pair up for MAC2"):
        j_kernel(jnp.zeros((4, 5), jnp.int8), jnp.zeros(5, jnp.int8), bits=4,
                 interpret=True)
    w6, x6 = torch.zeros((4, 6), dtype=torch.int8), torch.zeros(6, dtype=torch.int8)
    with pytest.raises(ValueError):
        tk.mac2_mvm_kernel(w6, x6, bits=3)
    with pytest.raises(TypeError):
        tk.mac2_mvm_kernel(w6.to(torch.int32), x6, bits=4)
    with pytest.raises(ValueError):
        tk.mac2_mvm_kernel(w6, x6[:4], bits=4)
    with pytest.raises(ValueError):
        tk.mac2_mvm_kernel(w6[0], x6, bits=4)
    empty = tk.mac2_mvm_kernel(torch.zeros((0, 6), dtype=torch.int8), x6,
                               bits=8)
    assert empty.dtype == torch.int32 and empty.shape == (0,)


def test_cpu_call_launches_no_kernel():
    before = tk.mac2_mvm_kernel.launches
    rng = np.random.default_rng(3)
    out = tk.mac2_mvm_kernel(_t(rand_q(rng, 8, (9, 4))),
                             _t(rand_q(rng, 8, (4,))), bits=8)
    assert out.device.type == "cpu"
    assert before == 0 and tk.mac2_mvm_kernel.launches == 0


# --- the CUDA kernel's arithmetic, reconstructed on the CPU -------------------

def _planes(x, bits):
    """(8, C) s8 bit planes of the unsigned bits-bit view of x; planes at or
    past `bits` are zero (the MMA's unused columns)."""
    u = x.astype(np.int64) & ((1 << bits) - 1)
    return np.stack([(u >> i) & 1 if i < bits else np.zeros_like(u)
                     for i in range(8)])


def _mma_from_fragments(a, b):
    """mma.sync m16n8k32 s8 from per-lane registers, in PTX's fragment
    layout: a[lane] = 4 words of 4 bytes (rows g, g+8 x k 4t.., 16+4t..),
    b[lane] = 2 words (k 4t.., 16+4t.. x column g).  Returns the (16, 8)
    int64 product, and checks every element of A and B was set once."""
    A = np.full((16, 32), -999, np.int64)
    B = np.full((32, 8), -999, np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):
            A[g, 4 * t + i], A[g + 8, 4 * t + i] = a[lane][0][i], a[lane][1][i]
            A[g, 16 + 4 * t + i] = a[lane][2][i]
            A[g + 8, 16 + 4 * t + i] = a[lane][3][i]
            B[4 * t + i, g], B[16 + 4 * t + i, g] = b[lane][0][i], b[lane][1][i]
    assert (A != -999).all() and (B != -999).all()
    return A @ B


def _kernel_emulation(w, x, bits, signed, sms, chunk=tk.CHUNK):
    """mac2_mvm_kernel's arithmetic as the CUDA kernel does it: the launch
    plan's K ranges, each taken in chunks of at most `chunk` columns; per
    16-row tile and 64-byte window, lane (g, t) takes bytes [16t, 16t+16)
    of rows g and g+8 and of x, and MMA j uses bytes 8j.. of them (the
    permuted K order); C's columns are the bit passes, weighted by 2^i with
    the MSB negated when signed and folded into uint32 after each chunk;
    the splits' sums add in uint32."""
    R, C = w.shape
    _, splits, kps = tk._plan(R, C, sms)
    out = np.zeros(R, np.uint64)
    wt = np.asarray([0 if i >= bits else (1 << i) * (-1 if signed and
                     i == bits - 1 else 1) for i in range(8)], np.int64)
    Rp = -(-R // 16) * 16
    for s in range(splits):
        for kb in range(s * kps, min(C, (s + 1) * kps), chunk):
            ke = min(C, (s + 1) * kps, kb + chunk)
            nwin = -(-(ke - kb) // tk.WIN)
            wp = np.zeros((Rp, nwin * tk.WIN), np.int64)
            wp[:R, :ke - kb] = w[:, kb:ke]
            pl = np.zeros((8, nwin * tk.WIN), np.int64)
            pl[:, :ke - kb] = _planes(x[kb:ke], bits)
            S = np.zeros((Rp, 8), np.int64)
            for r0 in range(0, Rp, 16):
                for k in range(0, nwin * tk.WIN, tk.WIN):
                    for j in (0, 1):
                        a, b = [], []
                        for lane in range(32):
                            g, t = lane >> 2, lane & 3
                            c0 = k + 16 * t + 8 * j
                            a.append([wp[r0 + g, c0:c0 + 4],
                                      wp[r0 + g + 8, c0:c0 + 4],
                                      wp[r0 + g, c0 + 4:c0 + 8],
                                      wp[r0 + g + 8, c0 + 4:c0 + 8]])
                            b.append([pl[g, c0:c0 + 4], pl[g, c0 + 4:c0 + 8]])
                        S[r0:r0 + 16] += _mma_from_fragments(a, b)
            assert np.abs(S).max() < 2 ** 31      # the int32 sums are exact
            part = (S[:R] % 2 ** 32).astype(np.uint64) \
                * (wt % 2 ** 32).astype(np.uint64)
            out = (out + part.sum(axis=1)) % 2 ** 32
    return out.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("shape,sms,chunk", [((16, 64), 132, tk.CHUNK),
                                             ((40, 200), 8, tk.CHUNK),
                                             ((17, 138), 132, tk.CHUNK),
                                             ((20, 520), 1, 128)])
def test_kernel_bit_planes_match_jax_kernel(bits, signed, shape, sms, chunk):
    """The CUDA kernel's bit-plane MMA arithmetic (reconstructed lane by
    lane, K split as the plan splits it, and folded per chunk: one chunk
    here is cut to 128 columns so that the fold runs several times) equals
    the Pallas kernel in interpret mode and `core.mac2.mac2_mvm`: x in the
    bits range, over the whole int8 range (outside it), and unsigned 8-bit
    inputs stored as negative int8."""
    R, C = shape
    rng = np.random.default_rng(hash((bits, signed, shape)) % 2**31)
    w = rand_q(rng, bits, (R, C))
    for x in (rand_q(rng, bits, (C,), signed=signed),
              rng.integers(-128, 128, size=(C,)).astype(np.int8)):
        got = _kernel_emulation(w, x, bits, signed, sms, chunk)
        want = j_kernel(jnp.asarray(w), jnp.asarray(x), bits=bits,
                        signed=signed, block=R if R % 8 else 8,
                        interpret=True)
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(
            got, tm.mac2_mvm(_t(w), _t(x), bits, signed_inputs=signed).numpy())


GRANITE_GEMV = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336),
                (49152, 4096)]


@pytest.mark.parametrize("sms", [132, 114, 8])
@pytest.mark.parametrize("RC", GRANITE_GEMV + [(1, 2), (17, 482), (64, 14336),
                                               (3, 40000), (100000, 2),
                                               (8, 2000000)])
def test_mac2_kernel_launch_plan(RC, sms):
    """The kernel's launch plan: 64-, 32- or 16-row blocks; at most 8 K
    ranges (one thread block cluster), each a whole number of 64-byte
    windows, covering C exactly once; the MMA sums at most CHUNK columns
    before folding, below 2^24, so its int32 sums of 0/1 planes are exact;
    at every granite shape at least two blocks per SM."""
    R, C = RC
    rows, splits, kps = tk._plan(R, C, sms)
    assert rows in tk.BLOCK_ROWS and 1 <= splits <= tk.MAX_SPLITS
    assert kps > 0 and kps % tk.WIN == 0 and tk.CHUNK < 2 ** 24
    ranges = [(s * kps, min(C, (s + 1) * kps)) for s in range(splits)]
    assert all(b < e for b, e in ranges)
    assert ranges[0][0] == 0 and ranges[-1][1] == C
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(splits - 1))
    if RC in GRANITE_GEMV and sms == 132:
        assert -(-R // rows) * splits >= 2 * sms
