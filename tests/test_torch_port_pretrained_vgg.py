"""The pretrained fine-tune of ``vgg11`` against the JAX package's loader,
on the CPU, from full-width torchvision-layout donors (128.8 M parameters;
a file of its own, so that xdist runs it beside the others): the loads of
``pretrained_tests`` and the malformed files of ``malformed_test``
(tests/test_torch_port_pretrained.py, which states the tolerance:
bitwise)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_pretrained import _drop, _shrink, malformed_test, pretrained_tests  # noqa: E402

# the VGG-specific keys; the JAX converter and the port's check share the
# rest with AlexNet (tests/test_torch_port_pretrained_alexnet.py)
VGG_CASES = {
    "missing key": _drop("classifier.3.bias"),
    "first linear's input width": _shrink("classifier.0.weight"),
}

globals().update(pretrained_tests(["vgg11"]))
globals().update(malformed_test("vgg11", VGG_CASES))
