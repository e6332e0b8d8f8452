"""The training loss and gradients of one smoke step of the hybrid and
16-expert archs (jamba-1.5-large-398b: mamba, attention and MoE;
xlstm-1.3b: mLSTM and sLSTM; dbrx-132b) in the port against
`jax.value_and_grad` of the JAX package's loss, float weights, with
test_torch_train's tolerances: autograd through the recurrent mixers'
step-by-step state writes and the MoE dispatch's `index_put_`."""
import pytest
import torch

from test_torch_train import HYBRID, check_loss_and_grads

torch.set_num_threads(1)  # smoke sizes: one intra-op thread per worker


@pytest.mark.parametrize("arch", HYBRID)
def test_loss_and_grads_equal_jax(arch):
    check_loss_and_grads(arch, 0)
