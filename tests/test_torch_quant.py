"""repro_torch.core.quant vs repro.core.quant: quantization, bit-packing and
digit decompositions, bit-exact on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro_torch.core import quant as tq

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # smoke sizes: one intra-op thread per worker

BITS = [2, 4, 8]


def _x(seed, shape=(6, 8, 16), dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("axis", [None, -1, 1])
@pytest.mark.parametrize("pack_axis", [-1, -2])
def test_quantize_bit_exact(bits, axis, pack_axis):
    """f32 inputs: int8 values (packed or not) and f32 scales bit-exact,
    per-tensor and per-channel, packed along -1 and -2."""
    x = _x(100 * bits + 10 * (3 if axis is None else axis + 2) + pack_axis + 2)
    for pack in (False, True):
        a = jq.quantize(jnp.asarray(x), bits, axis=axis, pack=pack,
                        pack_axis=pack_axis)
        b = tq.quantize(torch.from_numpy(x), bits, axis=axis, pack=pack,
                        pack_axis=pack_axis)
        assert (a.bits, a.packed, tuple(a.shape), a.packed_axis) == \
            (b.bits, b.packed, tuple(b.shape), b.packed_axis)
        np.testing.assert_array_equal(np.asarray(a.values), b.values.numpy())
        np.testing.assert_array_equal(np.asarray(a.scale), b.scale.numpy())
        np.testing.assert_array_equal(np.asarray(a.unpacked_values()),
                                      b.unpacked_values().numpy())
        np.testing.assert_array_equal(np.asarray(a.dequantize()),
                                      b.dequantize().numpy())


def test_quantize_bf16_within_one_step():
    """bf16 inputs: the scale is computed in bf16 on both sides; XLA may
    fuse x/scale and round without torch's intermediate bf16 rounding, so
    values may differ by one quantization step (and scales not at all)."""
    x = _x(3, (32, 64))
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj).view(np.uint16).astype(np.int16)
                          ).view(torch.bfloat16)
    for bits in BITS:
        a = jq.quantize(xj, bits, axis=-1)
        b = tq.quantize(xt, bits, axis=-1)
        np.testing.assert_array_equal(np.asarray(a.scale), b.scale.numpy())
        diff = np.abs(np.asarray(a.values, np.int32)
                      - b.values.numpy().astype(np.int32))
        assert diff.max() <= 1


@pytest.mark.parametrize("bits", BITS)
def test_pack_unpack_and_digits_bit_exact(bits):
    lo, hi = jq.qrange(bits)
    q = np.random.default_rng(bits).integers(lo, hi + 1, size=(4, 8, 16)
                                             ).astype(np.int8)
    qj, qt = jnp.asarray(q), torch.from_numpy(q)
    for axis in (-1, 0, 1):
        pj = jq.pack_bits_axis(qj, bits, axis)
        pt = tq.pack_bits_axis(qt, bits, axis)
        np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
        np.testing.assert_array_equal(np.asarray(jq.unpack_axis(pj, bits, axis)),
                                      tq.unpack_axis(pt, bits, axis).numpy())
        np.testing.assert_array_equal(tq.unpack_axis(pt, bits, axis).numpy(), q)
    assert tq.num_digits(bits) == jq.num_digits(bits)
    for signed in (True, False):
        dj = jq.to_radix4_digits(qj, bits, signed)
        dt = tq.to_radix4_digits(qt, bits, signed)
        np.testing.assert_array_equal(np.asarray(dj), dt.numpy())
        np.testing.assert_array_equal(np.asarray(jq.from_radix4_digits(dj)),
                                      tq.from_radix4_digits(dt).numpy())
        np.testing.assert_array_equal(np.asarray(jq.to_bits(qj, bits, signed)),
                                      tq.to_bits(qt, bits, signed).numpy())
    np.testing.assert_array_equal(
        tq.from_radix4_digits(tq.to_radix4_digits(qt, bits)).numpy(), q)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("chunk", [100, 1500])
def test_prepare_serving_in_runs_equals_one_call(bits, chunk, monkeypatch):
    """A stacked (periods, E, in, out) weight larger than SERVE_CHUNK is
    quantized in runs of leading slices: single experts stacked back (a
    chunk below one expert's 128 elements) or runs of whole (E, in, out)
    periods (above one period's 512) give the values, scales and layout of
    one call, and of the reference's `prepare_serving`."""
    from repro.core import bramac_linear as jbl
    from repro_torch.core import bramac_linear as tbl
    w = _x(7 * bits + chunk, shape=(3, 4, 16, 8))
    q = dict(enabled=True, bits_w=bits, bits_a=8)
    whole = tbl.prepare_serving(torch.from_numpy(w), tbl.QuantConfig(**q))
    monkeypatch.setattr(tbl, "SERVE_CHUNK", chunk)
    got = tbl.prepare_serving(torch.from_numpy(w), tbl.QuantConfig(**q))
    want = jbl.prepare_serving(jnp.asarray(w), jbl.QuantConfig(**q))
    for b in (whole, got):
        assert (b.bits, b.packed, tuple(b.shape), b.packed_axis) == \
            (want.bits, want.packed, tuple(want.shape), want.packed_axis)
        np.testing.assert_array_equal(np.asarray(want.values),
                                      b.values.numpy())
        np.testing.assert_array_equal(np.asarray(want.scale), b.scale.numpy())
