"""The hierarchical topology (``comm_topology: hierarchical``) in one
process, against the JAX package:

- ``comm_bytes_breakdown``'s intra-/inter-host split for every hook, for
  AlexNet (224 px), toy_cnn (8 px) and resnet18_small (32 px) at (world,
  L) = (8, 4), (4, 2) and (2, 1), equal to the JAX package's, and its two
  ``ValueError``s (``tests/test_comm.py:242-270``);
- the plan of hook ``none`` (``force=True``) and the host split
  (``mesh.factor``) against ``tpuddp/parallel/mesh.py``'s;
- the refusals with the JAX package's exception types and texts
  (``tests/test_comm.py:515-532``): a world that does not factor, ZeRO-1,
  the managed path, an unknown topology, in the wrap and in the settings.

Tolerance: exact (integers and texts).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp.accelerate import Accelerator as JaxAccelerator
from tpuddp.models import load_model as jax_load_model
from tpuddp.parallel import comm as jax_comm
from tpuddp.parallel import make_mesh
from tpuddp.parallel.mesh import hierarchical_mesh

from tpuddp_torch import config as cfg
from tpuddp_torch.accelerate import Accelerator
from tpuddp_torch.models import load_model
from tpuddp_torch.models.convert import jax_sizes
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.optim import Adam
from tpuddp_torch.parallel import comm, mesh
from tpuddp_torch.parallel.ddp import DistributedDataParallel

CAP, DENSITY = 25.0, 0.1
MODELS = {"alexnet": 224, "toy_cnn": 8, "resnet18_small": 32}
SPLITS = ((8, 4), (4, 2), (2, 1))


@pytest.fixture(scope="module")
def layouts():
    """Per model: the port's leaf sizes in the JAX order, and a JAX tree of
    float32 zeros of the JAX package's leaf shapes."""
    out = {}
    for name, hw in MODELS.items():
        with torch.device("meta"):
            model = load_model(name, 10, input_shape=(hw, hw, 3))
        shapes = jax.eval_shape(jax_load_model(name, 10).init, jax.random.key(0),
                                jnp.zeros((1, hw, hw, 3)))[0]
        tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
        out[name] = (jax_sizes(name, model), tree)
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("world,local", SPLITS)
@pytest.mark.parametrize("hook", comm.COMM_HOOKS)
def test_the_hierarchical_byte_split_is_the_jax_packages(layouts, name, world, local, hook):
    sizes, tree = layouts[name]
    kw = dict(bucket_cap_mb=CAP, density=DENSITY)
    got = comm.comm_bytes_breakdown(sizes, world, hook, "hierarchical", local_size=local, **kw)
    want = jax_comm.comm_bytes_breakdown(tree, world, hook, topology="hierarchical",
                                         local_size=local, **kw)
    assert got == want
    total = world * -(-sum(sizes) // world)
    assert got["intra_host"] == total * 4 + total // local * 4
    assert got["total"] == got["intra_host"] + got["inter_host"]
    flat = comm.comm_bytes_breakdown(sizes, world, hook, **kw)
    assert flat == jax_comm.comm_bytes_breakdown(tree, world, hook, topology="flat", **kw)
    assert got["inter_host"] <= flat["total"]
    # the managed path's collective stays float32 and flat (wire=False)
    assert comm.comm_bytes_breakdown(sizes, world, hook, "hierarchical", local_size=local,
                                     wire=False) == \
        jax_comm.comm_bytes_breakdown(tree, world, hook, topology="hierarchical", local_size=local,
                                      wire=False)


@pytest.mark.parametrize("local", (None, 3))
def test_the_split_needs_a_local_size_that_divides_the_world(local):
    p = {"w": jnp.zeros((100, 10))}
    with pytest.raises(ValueError, match="local_size") as want:
        jax_comm.comm_bytes_breakdown(p, 8, "int8_ef", topology="hierarchical", local_size=local)
    with pytest.raises(ValueError) as got:
        comm.comm_bytes_breakdown((1000,), 8, "int8_ef", "hierarchical", local_size=local)
    assert str(got.value) == str(want.value)


def test_an_unknown_topology_is_the_jax_value_error():
    with pytest.raises(ValueError) as want:
        jax_comm.comm_bytes_breakdown({"w": jnp.zeros((10,))}, 8, "int8_ef", topology="ring")
    with pytest.raises(ValueError) as got:
        comm.comm_bytes_breakdown((10,), 8, "int8_ef", "ring")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="comm_topology"):
        cfg.training_config({"training": {"comm_topology": "ring"}})


def test_hook_none_gets_a_plan_when_forced():
    assert comm.make_grad_comm((10, 7), 4, "none") is None
    plan = comm.make_grad_comm((10, 7), 4, "none", force=True)
    assert (plan.total, plan.hook, plan.needs_residual, plan.init_residual()) == (20, "none", False, None)


@pytest.mark.parametrize("world,hosts", [(8, None), (4, None), (2, None), (8, 4), (6, 3)])
def test_the_host_split_is_the_jax_meshs(cpu_devices, world, hosts):
    got = mesh.factor(world, hosts)
    want = hierarchical_mesh(devices=cpu_devices[:world], hosts=hosts)
    assert got == tuple(want.devices.shape)
    assert (mesh.HOST_AXIS, mesh.LOCAL_AXIS) == want.axis_names


@pytest.mark.parametrize("world,hosts", [(3, None), (1, None), (8, 3), (4, 1)])
def test_a_world_that_does_not_factor_is_the_jax_value_error(cpu_devices, world, hosts):
    with pytest.raises(ValueError, match="factorable") as want:
        hierarchical_mesh(devices=cpu_devices[:world], hosts=hosts)
    with pytest.raises(ValueError) as got:
        mesh.factor(world, hosts)
    assert str(got.value) == str(want.value)


def _wrap(**kw):
    model = load_model("toy_mlp", 10)
    return DistributedDataParallel(model, Adam(model.parameters(), lr=1e-3), CrossEntropyLoss(),
                                   device="cpu", comm_topology="hierarchical", **kw)


def test_the_wrap_refuses_zero1_before_it_factors():
    """``tpuddp/parallel/ddp.py:198-219``'s order: ZeRO-1 is refused before
    the groups are built (a world of one does not factor either)."""
    with pytest.raises(ValueError, match="mutually exclusive"):
        _wrap(weight_update_sharding=True)
    with pytest.raises(ValueError, match="factorable"):
        _wrap()


def test_the_managed_path_needs_the_explicit_api():
    with pytest.raises(ValueError) as want:
        JaxAccelerator(mesh=make_mesh(jax.devices("cpu")[:1]), comm_topology="hierarchical")
    with pytest.raises(ValueError) as got:
        Accelerator(device="cpu", comm_topology="hierarchical")
    assert "explicit" in str(got.value) and str(got.value) == str(want.value)


def test_the_settings_take_the_topology_and_refuse_it_with_zero1():
    training = cfg.training_config({"training": {"comm_topology": "hierarchical"}})
    assert training["comm_topology"] == "hierarchical"
    with pytest.raises(ValueError, match="mutually exclusive"):
        cfg.training_config({"training": {"comm_topology": "hierarchical",
                                          "weight_update_sharding": True}})
