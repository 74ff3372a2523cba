"""test_torch_train.py's per-architecture checks for the two architectures
whose JAX train step compiles for the longest: deepseek-v2-lite (MLA with a
dense first layer and MoE) and jamba (mamba, attention and MoE), in a file of
their own so that the two files run side by side."""
import pytest

from _torch_rows import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from _torch_train import check_loss_and_grads, check_train_steps, jax_run  # noqa: F401

HEAVY = ("deepseek-v2-lite-16b", "jamba-1.5-large-398b")


@pytest.mark.parametrize("arch", HEAVY)
def test_loss_and_grads_equal_jax(jax_run, arch):
    check_loss_and_grads(jax_run(arch), arch)


@pytest.mark.parametrize("arch", HEAVY)
def test_train_steps_equal_jax(jax_run, arch):
    check_train_steps(jax_run(arch), arch)
