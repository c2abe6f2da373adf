"""The port's ResNet-50 (``resnet50``, ``resnet50_small``, ``resnet50_s2d``)
against the JAX package on the CPU: the bridge round trip, the JAX
package's torchvision converter on the port's ``state_dict``, eval
logits and a train-mode forward (``depth_tests`` in
tests/test_torch_port_resnet.py, which states the tolerances)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_resnet import depth_tests  # noqa: E402

globals().update(depth_tests("resnet50"))
