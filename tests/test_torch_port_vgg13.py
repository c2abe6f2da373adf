"""The port's VGG-13 (``vgg13``) against the JAX package on the CPU: the
bridge round trip, eval logits at 32 px, the leaf order and the JAX children
(``vgg_tests`` in tests/test_torch_port_vgg.py, which states the
tolerances)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_vgg import vgg_tests  # noqa: E402

globals().update(vgg_tests("vgg13"))
