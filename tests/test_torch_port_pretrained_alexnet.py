"""The pretrained fine-tune of ``alexnet`` and ``alexnet_s2d`` (the
reference tutorial's model) against the JAX package's loader, on the CPU:
the loads of ``pretrained_tests`` and the malformed files of
``malformed_test`` (tests/test_torch_port_pretrained.py, which states the
tolerance: bitwise). AlexNet ignores keys it does not hold, as the JAX
converter does; a bias of the wrong shape is refused, where the JAX loader
takes it and its first step fails."""

import os
import sys

import pytest
import torch

from tpuddp.models import torch_import

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_pretrained import (  # noqa: E402
    _add, _drop, _shrink, _training, donor, malformed_test, port_load, saved,
    pretrained_tests,
)

ALEXNET_CASES = {
    "wrong shape": _shrink("features.3.weight"),
    "missing key": _drop("classifier.4.bias"),
    "extra key": _add("features.1.weight", torch.zeros(3)),
    "num_batches_tracked": _add("features.0.num_batches_tracked", torch.tensor(7)),
    "head without its key": _drop("classifier.6.weight"),
    "first linear's input width": _shrink("classifier.1.weight"),
}

globals().update(pretrained_tests(["alexnet", "alexnet_s2d"]))
globals().update(malformed_test("alexnet", ALEXNET_CASES))


def test_a_bias_of_the_wrong_shape_is_refused_where_the_jax_load_takes_it(tmp_path):
    sd = dict(donor("alexnet", 10, seed=3))
    sd["features.3.bias"] = sd["features.3.bias"][:-1].clone()
    with saved(tmp_path, sd, "bias") as path:
        training = _training("alexnet", path)
        with pytest.raises(ValueError, match=r"features\.3\.bias"):
            port_load(training)
        _, params, _ = torch_import.pretrained_from_config(training)  # taken as it is
    assert params[3]["bias"].shape == (191,)
