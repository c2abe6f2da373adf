"""Import guard of the port: no module of ``tpuddp_torch/``, nor
``chip_smoke.py``, nor the port's test workers (which run without the JAX
package), imports ``jax``, ``jaxlib`` or the JAX package ``tpuddp`` — by an
import statement or by ``importlib.import_module``/``__import__`` with a
literal name. ``tpuddp_torch`` itself is allowed, and so are imports inside
the package relative to it."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "tpuddp")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "tpuddp_torch")):
        files += [os.path.join(dirpath, n) for n in sorted(names) if n.endswith(".py")]
    tests = os.path.join(ROOT, "tests")
    files += [os.path.join(tests, n) for n in sorted(os.listdir(tests))
              if n.startswith("_torch_port_") and n.endswith(".py")]
    return sorted(os.path.relpath(f, ROOT) for f in files)


def imported_names(source: str, filename: str = "<source>"):
    """Every absolute module name ``source`` imports, statically."""
    tree = ast.parse(source, filename=filename)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
            if name in ("import_module", "__import__"):
                yield node.args[0].value


def forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_the_guard_sees_every_form():
    src = ("import jax\nimport jax.numpy as jnp\nfrom jaxlib import xla_client\n"
           "from tpuddp.parallel import ddp\nimport tpuddp\nimportlib.import_module('jax')\n"
           "__import__('tpuddp.optim')\nimport tpuddp_torch\nfrom tpuddp_torch.ops import fused_adam\n"
           "from . import loader\nimport numpy\n")
    bad = [n for n in imported_names(src) if forbidden(n)]
    assert bad == ["jax", "jax.numpy", "jaxlib", "tpuddp.parallel", "tpuddp", "jax", "tpuddp.optim"]


def test_the_port_has_its_files():
    files = _port_files()
    for must in ("chip_smoke.py", "tpuddp_torch/accelerate.py", "tpuddp_torch/train_accelerate.py",
                 "tpuddp_torch/parallel/collectives.py", "tests/_torch_port_accel_worker.py"):
        assert must in files, must


@pytest.mark.parametrize("path", _port_files())
def test_no_jax_or_tpuddp_import(path):
    with open(os.path.join(ROOT, path)) as f:
        bad = sorted({n for n in imported_names(f.read(), path) if forbidden(n)})
    assert not bad, f"{path} imports {bad}"
