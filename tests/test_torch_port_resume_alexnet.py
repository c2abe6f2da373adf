"""AlexNet's cases of tests/test_torch_port_resume.py (its checkpoints are
684 MB with float32 moments), in a file of their own so that the test
workers share them out: JAX-written ``ckpt_``, ``state_`` and ``model.npz``
files restore into the port, and the port's ``ckpt_`` files into the JAX
package, bitwise, with float32 and bf16 moments; the weight bridge's round
trip, bitwise, including the 9216-wide ``(h, w, c) <-> (c, h, w)`` reorder."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_port_resume as base  # noqa: E402

MOMENTS = ["float32", "bfloat16"]


@pytest.mark.parametrize("moments", MOMENTS)
def test_jax_ckpt_restores_into_the_port_bitwise(tmp_path, cpu_devices, moments):
    base.test_jax_ckpt_restores_into_the_port_bitwise(tmp_path, cpu_devices, "alexnet", moments)


@pytest.mark.parametrize("moments", MOMENTS)
def test_jax_state_and_model_files_restore_into_the_port_bitwise(tmp_path, cpu_devices, moments):
    base.test_jax_state_and_model_files_restore_into_the_port_bitwise(
        tmp_path, cpu_devices, "alexnet", moments)


@pytest.mark.parametrize("moments", MOMENTS)
def test_port_ckpt_restores_into_the_jax_package_bitwise(tmp_path, cpu_devices, moments):
    base.test_port_ckpt_restores_into_the_jax_package_bitwise(
        tmp_path, cpu_devices, "alexnet", moments)


def test_round_trips_through_the_bridge_are_bitwise(cpu_devices):
    base.test_round_trips_through_the_bridge_are_bitwise(cpu_devices, "alexnet")
