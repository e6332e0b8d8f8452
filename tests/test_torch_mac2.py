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
