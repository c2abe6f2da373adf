"""Import guard of the port: no module of ``tpuddp_torch/``, nor
``chip_smoke.py``, nor the port's test workers (which run without the JAX
package), imports ``jax``, ``jaxlib`` or the JAX package ``tpuddp`` — by an
import statement or by ``importlib.import_module``/``__import__`` with a
literal name. ``tpuddp_torch`` itself is allowed, and so are imports inside
the package relative to it. Nor does the port read a source file of the JAX
package: its native sources (``gather.cpp``, ``fused_adam.cu``) are its own
copies inside ``tpuddp_torch/``, and no string in its code (docstrings
aside) names a path under ``tpuddp/``."""

import ast
import os
import re

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
                 "tpuddp_torch/parallel/collectives.py", "tests/_torch_port_accel_worker.py",
                 "tpuddp_torch/data/_native/__init__.py", "tpuddp_torch/training/pipeline.py",
                 "tpuddp_torch/training/checkpoint.py", "tpuddp_torch/utils/batching.py",
                 "tests/_torch_port_resume_worker.py", "tpuddp_torch/data/digits.py",
                 "tpuddp_torch/_threefry.py", "tpuddp_torch/seeding.py",
                 "tests/_torch_port_entry_worker.py"):
        assert must in files, must


@pytest.mark.parametrize("path", _port_files())
def test_no_jax_or_tpuddp_import(path):
    with open(os.path.join(ROOT, path)) as f:
        bad = sorted({n for n in imported_names(f.read(), path) if forbidden(n)})
    assert not bad, f"{path} imports {bad}"


# a source file under the JAX package (not tpuddp_torch/) in a string of code;
# a "file:line" reference (chip_smoke.py's "replaces") reads nothing
_JAX_PATH = re.compile(r"(^|[/\\'\"])tpuddp[/\\][^:]*\.(cpp|cc|cu|cuh|h|hpp|py)$")


def code_strings(source: str, filename: str = "<source>"):
    """Every string constant of ``source`` that is not a docstring."""
    tree = ast.parse(source, filename=filename)
    docstrings = {
        id(node.body[0].value) for node in ast.walk(tree)
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
        and node.body and isinstance(node.body[0], ast.Expr)
        and isinstance(node.body[0].value, ast.Constant)
    }
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docstrings:
            yield node.value


def test_the_source_guard_sees_a_jax_path():
    src = 'p = "tpuddp/data/_native/gather.cpp"\nq = "tpuddp_torch/ops/csrc/fused_adam.cu"\n'
    assert [v for v in code_strings(src) if _JAX_PATH.search(v)] == ["tpuddp/data/_native/gather.cpp"]
    assert not list(code_strings('"""see tpuddp/data/loader.py"""\n'))


@pytest.mark.parametrize("path", _port_files())
def test_no_source_of_the_jax_package_is_read(path):
    with open(os.path.join(ROOT, path)) as f:
        bad = [v for v in code_strings(f.read(), path) if _JAX_PATH.search(v)]
    assert not bad, f"{path} names {bad}"


def test_native_sources_are_the_ports_own():
    from tpuddp_torch.data import _native
    from tpuddp_torch.ops import fused_adam

    port = os.path.join(ROOT, "tpuddp_torch") + os.sep
    for source in (_native.SOURCE, fused_adam.SOURCE):
        assert str(source.resolve()).startswith(port) and source.exists(), source
