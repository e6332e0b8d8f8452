"""Expert parallelism in the port (`parallel.ep`, the EP routes of
`models.moe`) and the mesh-spec builder (`parallel.sharding.build_mesh`),
against the JAX package's single-device functions on the same inputs.

The sharded cases run on 4 gloo ranks on the CPU, spawned once for the
file (`_torch_parallel_ranks.ep_rank`): a 4-way `model` mesh and a
data=2,model=2 mesh.  Integers and the one epilogue are bit-exact: the
expert einsum on "e" and "d" at 2/4/8 bits, alone and with the capacity
axis on `data`, against `bl.serve_einsum_edf`; the keep masks of `ep_moe`
against JAX's (global: `moe()`'s capacity dispatch; per_source:
`per_source_reference`).  `ep_moe`'s float outputs are held bit for bit
against the port's own single-rank `moe()` / `per_source_reference` —
the structural claim — and within test_torch_model's ATOL_Q of JAX's,
the bound the port's meshless MoE layer itself meets against JAX
(tests/test_torch_moe.py); float weights within ATOL_MOE.  The in-process
cases are the reference's: `build_mesh`'s specs and errors and the
capacity-factor forwarding regression at model=1."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parallel_ranks import ep_rank
from repro.core import bramac_linear as jbl
from repro.models import moe as JMoE
from repro.parallel import ep as jep
from repro_torch.models import moe as TMoE
from repro_torch.parallel import comm, ep
from repro_torch.parallel import sharding as shd
from test_torch_convert import np_, smoke_pair, to_torch
from test_torch_model import ATOL_Q
from test_torch_moe import ATOL_MOE

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # smoke sizes: one intra-op thread per worker

BITS = (2, 4, 8)
E, C, D, F = 8, 16, 32, 24               # the reference's einsum shapes
JC, TC = smoke_pair("qwen3-moe-30b-a3b")  # E=8, top-2, d=64
NO_DROP = JC.num_experts / JC.experts_per_token


def _einsum_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(E, C, D)).astype(np.float32)
    w = rng.normal(size=(E, D, F)).astype(np.float32)
    return x, {b: jbl.prepare_serving(
        jnp.asarray(w), jbl.QuantConfig(enabled=True, bits_w=b))
        for b in BITS}


EIN_X, EIN_W = _einsum_inputs()
KEY = jax.random.PRNGKey(0)
MOE_P = JMoE.init_moe(KEY, JC)
MOE_X = np.array(jax.random.normal(jax.random.fold_in(KEY, 1),
                                   (2, 8, JC.d_model), jnp.float32))
MOE_Q = {b: jbl.tree_prepare_serving(
    MOE_P, jbl.QuantConfig(enabled=True, bits_w=b, bits_a=8)) for b in BITS}


@pytest.fixture(scope="module")
def ranks():
    einsum = {b: (torch.from_numpy(EIN_X), to_torch(q))
              for b, q in EIN_W.items()}
    params = {b: to_torch(q) for b, q in MOE_Q.items()}
    params["float"] = to_torch(MOE_P)
    moe_cases = {"x": torch.from_numpy(MOE_X), "params": params}
    outs = comm.spawn(ep_rank, 4, einsum, moe_cases, TC, device="cpu")
    for other in outs[1:]:
        for key, y in outs[0]["einsum"].items():
            np.testing.assert_array_equal(other["einsum"][key], y)
        for key, (y, _, keep) in outs[0]["moe"].items():
            np.testing.assert_array_equal(other["moe"][key][0], y)
            np.testing.assert_array_equal(other["moe"][key][2], keep)
    return outs[0]


@functools.cache
def _single(name, cf, dispatch, n):
    """The port's single-rank counterpart of an ep_moe case: moe() for
    global (n unused), per_source_reference at ep_size=n for per_source."""
    p = to_torch(MOE_Q[name] if name != "float" else MOE_P)
    x = torch.from_numpy(MOE_X)
    if dispatch == "global":
        y, aux = TMoE.moe(p, x, TC, capacity_factor=cf)
        return np_(y), float(aux), None
    y, aux, keep = ep.per_source_reference(p, x, TC, ep_size=n,
                                           capacity_factor=cf)
    return np_(y), float(aux), np_(keep)


@functools.cache
def _jax_global(name, cf):
    """JAX moe()'s output, aux loss and keep mask (the capacity dispatch's
    rank < C) for one weight set and capacity factor."""
    p = MOE_Q[name] if name != "float" else MOE_P
    want, aux = JMoE.moe(p, jnp.asarray(MOE_X), JC, capacity_factor=cf)
    xf = jnp.asarray(MOE_X).reshape(-1, JC.d_model)
    probs = jax.nn.softmax(xf @ p["router"], axis=-1)
    _, top_i = jax.lax.top_k(probs, JC.experts_per_token)
    a = top_i.reshape(-1)
    T = xf.shape[0]
    C_ = JMoE.moe_capacity(T, JC.num_experts, JC.experts_per_token, cf)
    keep = np.asarray(JMoE._rank_in_expert_sort(a, JC.num_experts) < C_
                      ).reshape(T, JC.experts_per_token)
    return np.asarray(want), float(aux), keep


@functools.cache
def _jax_einsum(bits):
    """The single-device JAX serve_einsum_edf of EIN_X at `bits`."""
    return np.asarray(jbl.serve_einsum_edf(jnp.asarray(EIN_X), EIN_W[bits],
                                           transpose_out=False))


# --- the expert einsum ---------------------------------------------------------

@pytest.mark.parametrize("part", ["e", "d"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("bits", BITS)
def test_ep_quant_einsum_bit_exact_all_bits(ranks, bits, n, part):
    """Expert-sharded and contraction-sharded (int32 all_reduce) expert
    einsum == the single-device serve_einsum_edf, bit for bit."""
    want = _jax_einsum(bits)
    got = ranks["einsum"][(bits, n, part, None)]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("part", ["e", "d"])
@pytest.mark.parametrize("bits", BITS)
def test_ep_quant_einsum_dp_composition(ranks, bits, part):
    """DPxEP and DPxTP on data=2,model=2: the capacity axis rides `data`,
    experts / the contraction `model` — still bit-exact."""
    np.testing.assert_array_equal(ranks["einsum"][(bits, 2, part, "data")],
                                  _jax_einsum(bits))


def test_ep_quant_einsum_divisibility_error(ranks):
    assert "not divisible" in ranks["div"]


# --- ep_moe --------------------------------------------------------------------

@pytest.mark.parametrize("cf", [NO_DROP, 1.0], ids=["no_drop", "tight"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", BITS + ("float",))
def test_ep_moe_global_vs_single_device(ranks, name, n, cf):
    """ep_moe(dispatch="global") (all_gathered count scan, all_to_all
    dispatch, all_gather combine): its keep mask equals JAX moe()'s,
    drops included; its output equals the port's single-rank moe() bit
    for bit and JAX's within tolerance; aux within rtol 1e-5."""
    got, aux, keep = ranks["moe"][(name, n, cf, "global")]
    mine, mine_aux, _ = _single(name, cf, "global", 1)
    np.testing.assert_array_equal(got, mine)
    want, want_aux, want_keep = _jax_global(name, cf)
    np.testing.assert_array_equal(keep, want_keep)
    assert keep.all() == (cf == NO_DROP)
    atol = ATOL_MOE if name == "float" else ATOL_Q
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(aux, want_aux, rtol=1e-5)
    np.testing.assert_allclose(aux, mine_aux, rtol=1e-5)


@pytest.mark.parametrize("cf", [NO_DROP, 1.0], ids=["no_drop", "tight"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", BITS + ("float",))
def test_ep_moe_per_source_vs_reference(ranks, name, n, cf):
    """dispatch="per_source" == the single-rank `per_source_reference` at
    ep_size=n: keep mask equal to JAX's bit for bit, values equal to the
    port's simulator bit for bit and to JAX's within tolerance.  At no-drop
    capacity nothing is dropped and it equals the global path; at tight
    capacity it drops, and differs from the global path."""
    got, aux, keep = ranks["moe"][(name, n, cf, "per_source")]
    mine, mine_aux, mine_keep = _single(name, cf, "per_source", n)
    np.testing.assert_array_equal(got, mine)
    np.testing.assert_array_equal(keep, mine_keep)
    p = MOE_Q[name] if name != "float" else MOE_P
    want, want_aux, want_keep = jep.per_source_reference(
        p, jnp.asarray(MOE_X), JC, ep_size=n, capacity_factor=cf)
    np.testing.assert_array_equal(keep, np.asarray(want_keep))
    atol = ATOL_MOE if name == "float" else ATOL_Q
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)
    np.testing.assert_allclose(aux, float(want_aux), rtol=1e-5)
    np.testing.assert_allclose(aux, mine_aux, rtol=1e-5)
    exact = ranks["moe"][(name, n, cf, "global")][0]
    if cf == NO_DROP:
        assert keep.all()
        np.testing.assert_array_equal(got, exact)
    else:
        assert not keep.all()
        assert not np.array_equal(got, exact)


def test_moe_routes_through_ep_when_mesh_active(ranks):
    """With a sharding ctx active, moe()'s quantized expert compute goes
    through the expert-parallel einsum, and per_source hands the layer to
    ep_moe — the same bits as without a ctx."""
    p = to_torch(MOE_Q[8])
    x = torch.from_numpy(MOE_X)
    np.testing.assert_array_equal(ranks["route"], np_(TMoE.moe(p, x, TC)[0]))
    want, _, _ = ep.per_source_reference(p, x, TC, ep_size=2,
                                         capacity_factor=1.0)
    np.testing.assert_array_equal(ranks["route_ps"], np_(want))


# --- in process: capacity-factor forwarding (regression), model=1 ---------------

def test_moe_forwards_capacity_factor_to_ep_route():
    """When moe() hands the layer to ep_moe (per-source dispatch under an
    active ctx), it reuses the caller's capacity_factor, not ep_moe's
    default; with no ctx, per_source is the dense path, the same bits."""
    jc, tc = smoke_pair("qwen3-moe-30b-a3b", ep_dispatch="per_source")
    qp = to_torch(MOE_Q[8])
    x = torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(KEY, 1), (2, 16, tc.d_model), jnp.float32)))
    shd.activate(shd.build_mesh("model=1"))
    try:
        got, _ = TMoE.moe(qp, x, tc, capacity_factor=0.5)
    finally:
        shd.deactivate()
    want, _, keep = ep.per_source_reference(qp, x, tc, ep_size=1,
                                            capacity_factor=0.5)
    assert torch.equal(got, want)
    assert not bool(torch.all(keep))
    bad, _, _ = ep.per_source_reference(qp, x, tc, ep_size=1,
                                        capacity_factor=1.25)
    assert not torch.equal(got, bad)
    dense, _ = TMoE.moe(qp, x, tc, capacity_factor=0.5)
    assert torch.equal(dense, want)
    jwant, _, jkeep = jep.per_source_reference(
        MOE_Q[8], jnp.asarray(np_(x)), jc, ep_size=1, capacity_factor=0.5)
    np.testing.assert_array_equal(np_(keep), np.asarray(jkeep))
    np.testing.assert_allclose(np_(got), np.asarray(jwant), rtol=0,
                               atol=ATOL_Q)


def test_ep_moe_validates():
    mesh = shd.build_mesh(1)
    x = torch.zeros((1, 3, TC.d_model))
    p = to_torch(MOE_P)
    with pytest.raises(ValueError, match="dispatch"):
        ep.ep_moe(p, x, TC, mesh=mesh, dispatch="bogus")
    with pytest.raises(ValueError, match="partition"):
        ep.ep_quant_einsum_edf(torch.from_numpy(EIN_X), to_torch(EIN_W[8]),
                               mesh=mesh, partition="x")


# --- in process: mesh-spec builder ---------------------------------------------

def test_build_mesh_single_device_specs():
    for spec in (1, "1", "model=1", "data=1,model=1", "1x1"):
        mesh = shd.build_mesh(spec)
        assert mesh.axis_names == ("data", "model")
        assert mesh.shape["model"] == 1
        assert mesh.groups == {}
    mesh = shd.build_mesh("pod=1,data=1,model=1")
    assert mesh.axis_names == ("pod", "data", "model")
    assert shd.spec_ranks("data=2,model=4") == 8
    assert shd.spec_ranks("2x2x2") == 8 and shd.spec_ranks(4) == 4


def test_build_mesh_rejects_bad_specs():
    with pytest.raises(ValueError, match="unknown mesh axis"):
        shd.build_mesh("experts=2")
    with pytest.raises(ValueError, match="must be >= 1"):
        shd.build_mesh("model=0")
    with pytest.raises(ValueError, match="must be >= 1"):
        shd.build_mesh(data=2, model=-1)
    with pytest.raises(ValueError, match="2-D or 3-D"):
        shd.build_mesh("1x1x1x1")
    with pytest.raises(ValueError, match="spec or keyword"):
        shd.build_mesh("model=1", model=1)
    with pytest.raises(ValueError, match="devices"):
        shd.build_mesh(model=16)


def test_param_specs_and_local_config():
    """The reference's name rules, right-aligned over the period axis; a
    QuantizedTensor's values and scale take the weight's rule;
    `local_config` splits heads and d_ff or raises."""
    from repro.parallel import sharding as jshd
    for path, ndim in (("layers/pos0/mixer/wq", 3), ("embed/unembed", 2),
                       ("layers/pos0/moe/w_down/values", 4),
                       ("layers/pos0/mlp/w_down/scale", 3),
                       ("embed/embedding", 2), ("final_norm/scale", 1)):
        assert shd.spec_for(path, ndim) == jshd.spec_for(
            path.replace("/", "."), ndim), path
    _, gc = smoke_pair()
    mesh = shd.Mesh(("data", "model"), (1, 2), (0, 0), {})
    local = shd.local_config(gc, mesh)
    assert (local.num_heads, local.num_kv_heads, local.d_ff, local.hd) == (
        2, 1, 56, gc.hd)
    with pytest.raises(ValueError, match="num_kv_heads"):
        shd.local_config(gc, shd.Mesh(("model",), (4,), (0,), {}))
