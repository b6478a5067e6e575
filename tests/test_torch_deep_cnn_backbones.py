"""DarkNet-19, DarkNet-53 and ResNet50-CIFAR at their own depths and widths
against the JAX package's, in f32 on the CPU: the train-mode logits, the
new BatchNorm statistics and every gradient (ResNet50-CIFAR also with
gradient checkpointing), the eval-mode logits, and the weights both ways.
The checks, the cases and their bounds (``DEEP``, with the readings behind
them) are ``tests/test_torch_cnn_backbones.py``'s; this file holds the
deep cases apart so that each file's JAX compiles stay short."""

import pytest
import torch

import test_torch_cnn_backbones as base
from _torch_port import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread(), torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.fixture(scope="module", params=list(base.DEEP))
def case(request):
    return base._jax_case(request.param)


def test_train_mode_matches_jax(case):
    base.test_train_mode_matches_jax(case)


def test_eval_mode_matches_jax(case):
    base.test_eval_mode_matches_jax(case)


def test_weights_carry_both_ways(case):
    base.test_weights_carry_both_ways(case)

