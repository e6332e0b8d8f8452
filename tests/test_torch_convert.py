"""PyTorch port vs the JAX package: configs, parameter trees, and the
converter (`repro_torch.convert`).  Also home of the helpers the other
`test_torch_*` files import: JAX trees cross through numpy."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import bramac_linear as jbl
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.convert import array_to_torch, from_jax_tree
from repro_torch.core import bramac_linear as tbl
from repro_torch.core.quant import QuantizedTensor

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # smoke sizes: one intra-op thread per worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- shared helpers ---------------------------------------------------------

def to_torch(tree):
    """A JAX tree (arrays, QuantizedTensors, nested dicts) in the port, on
    the CPU, bit for bit."""
    return from_jax_tree(jax.tree_util.tree_map(np.asarray, tree))


def np_(t) -> np.ndarray:
    """A torch tensor (any dtype but bf16) or JAX array as numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def smoke_pair(arch="granite-8b", **over):
    """(JAX cfg, port cfg) smoke configs with the same overrides; a
    QuantConfig override is given as its fields (bits)."""
    bits = over.pop("quant_bits", 0)
    jc = jconfigs.get_config(arch, smoke=True).replace(**over)
    tc = tconfigs.get_config(arch, smoke=True).replace(**over)
    if bits:
        jc = jc.replace(quant=jbl.QuantConfig(enabled=True, bits_w=bits,
                                              bits_a=bits))
        tc = tc.replace(quant=tbl.QuantConfig(enabled=True, bits_w=bits,
                                              bits_a=bits))
    return jc, tc


def leaves(tree, path=""):
    """(path, leaf) pairs of a nested-dict tree, sorted by path."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], f"{path}.{k}" if path else k)
        return out
    return [(path, tree)]


# --- configs ----------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_equal_field_by_field(arch):
    """Smoke and full configs of every arch match the reference's field by
    field (QuantConfig included); only compute_dtype changes type."""
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    for smoke in (False, True):
        jc = jconfigs.get_config(arch, smoke=smoke)
        tc = tconfigs.get_config(arch, smoke=smoke)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert (jc.hd, jc.n_periods, jc.param_count()) == \
            (tc.hd, tc.n_periods, tc.param_count())
        assert str(tc.compute_dtype) == f"torch.{jc.dtype}"


# --- parameter trees --------------------------------------------------------

@pytest.fixture(scope="module")
def jax_smoke():
    cfg = jconfigs.get_config("granite-8b", smoke=True)
    return cfg, JM.init_params(cfg, jax.random.PRNGKey(0))


def test_smoke_tree_carried_leaf_for_leaf(jax_smoke):
    """The reference's smoke tree crosses with identical structure, shapes,
    dtypes and bits; the port's own init_params builds the same structure."""
    cfg, jp = jax_smoke
    tp = to_torch(jp)
    jl = leaves(jax.tree_util.tree_map(np.asarray, jp))
    tl = leaves(tp)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert a.shape == tuple(b.shape), path
        np.testing.assert_array_equal(a, np_(b), err_msg=path)
    from repro_torch.models import model as TM
    own = TM.init_params(tconfigs.get_config("granite-8b", smoke=True),
                         torch.Generator().manual_seed(0), "cpu")
    assert [(p, tuple(x.shape), x.dtype) for p, x in leaves(own)] == \
        [(p, tuple(x.shape), x.dtype) for p, x in tl]


def test_bf16_leaves_cross_bit_exact():
    a = jnp.asarray(np.random.default_rng(0).normal(size=(5, 7)),
                    jnp.bfloat16)
    t = array_to_torch(np.asarray(a))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(a).view(np.uint16),
                                  t.view(torch.int16).numpy().view(np.uint16))


@pytest.mark.parametrize("bits", [4, 8])
def test_serving_tree_carried_leaf_for_leaf(jax_smoke, bits):
    """tree_prepare_serving on both sides gives the same QuantizedTensors:
    the converted JAX serving tree equals the port's own quantization of
    the converted float tree (int8 values and f32 scales bit-exact)."""
    _, jp = jax_smoke
    q = jbl.QuantConfig(enabled=True, bits_w=bits, bits_a=bits)
    jq = to_torch(jbl.tree_prepare_serving(jp, q))
    tq = tbl.tree_prepare_serving(to_torch(jp), tbl.QuantConfig(
        enabled=True, bits_w=bits, bits_a=bits))
    jl, tl = leaves(jq), leaves(tq)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    n_q = 0
    for (path, a), (_, b) in zip(jl, tl):
        assert type(a) is type(b), path
        if isinstance(a, QuantizedTensor):
            n_q += 1
            assert (a.bits, a.packed, a.shape, a.packed_axis) == \
                (b.bits, b.packed, b.shape, b.packed_axis), path
            assert torch.equal(a.values, b.values), path
            assert torch.equal(a.scale, b.scale), path
        else:
            assert torch.equal(a, b), path
    assert n_q == 8          # wq wk wv wo w_gate w_up w_down unembed


def test_import_leaves_jax_out():
    """The port imports neither jax nor the reference package."""
    code = ("import sys, repro_torch, repro_torch.convert, "
            "repro_torch.runtime.serve, repro_torch.launch.serve, "
            "repro_torch.kernels.build, repro_torch.runtime.trainer, "
            "repro_torch.launch.train, repro_torch.launch.dryrun\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\nprint('CLEAN')")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "CLEAN" in out.stdout
