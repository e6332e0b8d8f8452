"""Tensor parallelism in the port (`parallel.tp`, `parallel.sharding`,
`models.layers.dense_row`) and `bramac_matmul`'s int32 output mode, against
the JAX package's single-device functions on the same numpy inputs.

The int32 mode runs in this process: `ops.quant_matmul(...,
out_dtype=torch.int32)` equals the reference's `ops.quant_matmul(...,
out_dtype=jnp.int32)` (its Pallas kernel in interpret mode) bit for bit,
|acc| > 2^24 included.  The sharded cases run on 4 gloo ranks on the CPU,
spawned once for the file (`_torch_parallel_ranks.tp_rank`): a 4-way
`model` mesh and a data=2,model=2 mesh (2-way TP).  Integers and the one
epilogue are bit-exact: `tp_quant_matmul` k and n at 2/4/8 x 2/4/8 bits
against `ops.quant_matmul`, and the model's row-parallel linear against
the meshless `serve_dense` (JAX's and the port's).  The float row-parallel
linear sums float partials: within FP_ATOL (f32 reassociation of a
128-term dot)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parallel_ranks import tp_rank
from repro.core import bramac_linear as jbl
from repro.kernels import ops as jops
from repro_torch.core import bramac_linear as tbl
from repro_torch.core.quant import qrange
from repro_torch.kernels import ops as tops
from repro_torch.parallel import comm
from test_torch_convert import np_, to_torch

jax.config.update("jax_platform_name", "cpu")

BITS = (2, 4, 8)
M, K, N = 16, 64, 24                     # the reference's shapes
FP_ATOL = 1e-5


def _case(bits_a, bits_w, seed):
    rng = np.random.default_rng(seed)
    la, ha = qrange(bits_a)
    lw, hw = qrange(bits_w)
    return (rng.integers(la, ha + 1, (M, K), dtype=np.int8),
            rng.integers(lw, hw + 1, (K, N), dtype=np.int8),
            rng.uniform(0.5, 2.0, (M, 1)).astype(np.float32),
            rng.uniform(0.5, 2.0, (1, N)).astype(np.float32))


CASES = {(a, w): _case(a, w, 10 * a + w) for a in BITS for w in BITS}
DENSE_X = np.random.default_rng(1).normal(size=(6, 128)).astype(np.float32)
DENSE_W = (np.random.default_rng(2).normal(size=(128, 40)) / 11.0).astype(
    np.float32)


def _dense_cases():
    """bits → (x, serving weight, QuantConfig); "qat": a float weight under
    an enabled config; "fp": a float weight, no quantization."""
    x, w = torch.from_numpy(DENSE_X), torch.from_numpy(DENSE_W)
    cases = {}
    for bits in BITS:
        q = tbl.QuantConfig(enabled=True, bits_w=bits, bits_a=bits)
        cases[bits] = (x, tbl.prepare_serving(w, q), q)
    cases["qat"] = (x, w, tbl.QuantConfig(enabled=True, bits_w=8, bits_a=8))
    cases["fp"] = (x, w, None)
    return cases


@pytest.fixture(scope="module")
def ranks():
    """Every case's rank side on 4 gloo ranks, spawned once; rank 0's
    results, after checking that all ranks agree."""
    cases = {k: tuple(torch.from_numpy(a) for a in v)
             for k, v in CASES.items()}
    outs = comm.spawn(tp_rank, 4, cases, _dense_cases(), device="cpu")
    for other in outs[1:]:
        for key, (dt, y) in outs[0]["matmul"].items():
            np.testing.assert_array_equal(other["matmul"][key][1], y)
        for key, y in outs[0]["dense"].items():
            np.testing.assert_array_equal(other["dense"][key], y)
    return outs[0]


@pytest.fixture(scope="module")
def jax_ref():
    """The reference's single-device quant_matmul per bits pair."""
    return {k: np.asarray(jops.quant_matmul(
        *(jnp.asarray(a) for a in v), bits_a=k[0], bits_w=k[1]))
        for k, v in CASES.items()}


# --- the int32 output mode of bramac_matmul (in process) ----------------------

def _int32_case(name):
    """'random': 8-bit values of both signs; 'acc>2^24':
    8-bit values all +-127 at K=2048 (accumulators up to 33M); 'rounds':
    the same with one activation of 126 per row, so odd accumulators above
    2^24 round in the f32 round trip."""
    rng = np.random.default_rng(5)
    if name == "random":
        return (rng.integers(-128, 128, (8, 96), dtype=np.int8),
                rng.integers(-128, 128, (96, 40), dtype=np.int8))
    x = np.full((4, 2048), 127, np.int8)
    x[1, :9] = -127
    w = np.full((2048, 8), 127, np.int8)
    for n in range(8):
        w[:n, n] = -127
    if name == "rounds":
        x[:, 5] = 126
    return x, w


@pytest.mark.parametrize("name", ["random", "acc>2^24", "rounds"])
def test_int32_mode_equals_jax(name):
    """`out_dtype=torch.int32` equals the reference's int32 output bit for
    bit: the f32 epilogue value converted, not the raw accumulator (they
    part above 2^24, where the 'rounds' case checks that they do)."""
    x, w = _int32_case(name)
    one = np.ones((1, 1), np.float32)
    want = np.asarray(jops.quant_matmul(jnp.asarray(x), jnp.asarray(w), one,
                                        one, bits_a=8, bits_w=8,
                                        out_dtype=jnp.int32))
    got = tops.quant_matmul(torch.from_numpy(x), torch.from_numpy(w),
                            torch.ones(1, 1), torch.ones(1, 1), bits_a=8,
                            bits_w=8, out_dtype=torch.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np_(got), want)
    raw = x.astype(np.int64) @ w.astype(np.int64)
    if name != "random":
        assert np.abs(raw).max() > 2 ** 24
    assert (raw != want).any() == (name == "rounds")


def test_int32_mode_validates_out_dtype():
    x = torch.zeros((2, 8), dtype=torch.int8)
    one = torch.ones(1, 1)
    with pytest.raises(TypeError, match="out_dtype"):
        tops.quant_matmul(x, x.T.contiguous(), one, one, bits_a=8, bits_w=8,
                          out_dtype=torch.int64)


# --- tp_quant_matmul on 2- and 4-way model axes --------------------------------

@pytest.mark.parametrize("part", ["k", "n"])
@pytest.mark.parametrize("bits_w", BITS)
@pytest.mark.parametrize("bits_a", BITS)
@pytest.mark.parametrize("n", [2, 4])
def test_tp_quant_matmul_bit_exact_all_bits(ranks, jax_ref, n, bits_a,
                                            bits_w, part):
    """K-sharded (int32 partial all_reduce, one epilogue) and N-sharded
    (all_gather of the columns) == the single-device quant_matmul, bit for
    bit."""
    dt, got = ranks["matmul"][(n, bits_a, bits_w, part)]
    assert dt == "torch.float32"
    np.testing.assert_array_equal(got, jax_ref[(bits_a, bits_w)])


def test_tp_quant_matmul_respects_active_tp_rule(ranks):
    """With a sharding ctx active (data=2,model=2), tp resolves the
    physical axis from the logical `tp` rule."""
    x, w, _, _ = CASES[(8, 8)]
    one = jnp.ones((1, 1), jnp.float32)
    want = jops.quant_matmul(jnp.asarray(x), jnp.asarray(w), one, one,
                             bits_a=8, bits_w=8)
    np.testing.assert_array_equal(ranks["rule"], np.asarray(want))


@pytest.mark.parametrize("part", ["k", "n"])
def test_tp_quant_matmul_divisibility_error(ranks, part):
    assert "not divisible" in ranks[f"div_{part}"]


def test_tp_rejects_unknown_partition():
    from repro_torch.parallel import sharding, tp
    x = torch.zeros((2, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="partition"):
        tp.tp_quant_matmul(x, x.T.contiguous(), torch.ones(1, 1),
                           torch.ones(1, 1), mesh=sharding.build_mesh(1),
                           bits_a=8, bits_w=8, partition="x")


# --- the model's row-parallel linear -------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("bits", BITS)
def test_row_parallel_dense_equals_meshless(ranks, n, bits):
    """`dense_row` on this rank's K-slice (the global-absmax row scale, one
    int32 reduction, one epilogue) == the meshless serve_dense of the
    reference and of the port, bit for bit."""
    q = jbl.QuantConfig(enabled=True, bits_w=bits, bits_a=bits)
    jw = jbl.prepare_serving(jnp.asarray(DENSE_W), q)
    want = np.asarray(jbl.dense(jnp.asarray(DENSE_X), jw, q))
    np.testing.assert_array_equal(ranks["dense"][(bits, n)], want)
    tq = tbl.QuantConfig(enabled=True, bits_w=bits, bits_a=bits)
    mine = tbl.dense(torch.from_numpy(DENSE_X), to_torch(jw), tq)
    np.testing.assert_array_equal(np_(mine), want)


@pytest.mark.parametrize("n", [2, 4])
def test_row_parallel_qat_and_float(ranks, n):
    """A float weight under an enabled config (QAT forward: the weight's
    column scales from the global absmax too) == the meshless
    `bramac_dense` bit for bit; a float weight without one sums float
    partials, within FP_ATOL of x @ w."""
    want = np.asarray(jbl.dense(jnp.asarray(DENSE_X), jnp.asarray(DENSE_W),
                                jbl.QuantConfig(enabled=True, bits_w=8,
                                                bits_a=8)))
    np.testing.assert_array_equal(ranks["dense"][("qat", n)], want)
    np.testing.assert_allclose(ranks["dense"][("fp", n)], DENSE_X @ DENSE_W,
                               rtol=0, atol=FP_ATOL)
