"""The hierarchical topology (``comm_topology: hierarchical``) across two
Gloo processes, split 2 hosts x 1 local (the split of the card's world-2
run), against the JAX package on the factored mesh of 2 of the 8 virtual
CPU devices:

- ``GradComm.reduce_hierarchical`` of every hook, each rank's mean and
  residual (at L = 1 the intra-host hops are groups of one, skipped);
- the wrap: its split, its byte counters against the JAX wrap's, and the
  refusals with the JAX package's exception types and texts (ZeRO-1,
  ``comm_overlap: true``; ``auto`` records the JAX reason), and a
  CUDA-graph group refused on a Gloo world;
- hook ``none`` at 2 x 1 trains bitwise the flat run (the card's world-2
  check: a sum of two values does not depend on its order);
- checkpoints of a hierarchical ``int8_ef`` run (configs/digits_tpu.yaml's
  block, toy_cnn with sync_bn at 8 px): the port's file resumed by the
  JAX package's hierarchical run, and the JAX package's file restored into
  each rank's residual.

All runs of the port share one launch of ``tests/_torch_port_hier_worker.py``.
Tolerance: bitwise (every sum is of two values, rounded alike by Gloo and
XLA; the checkpoint layouts only move elements).
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpuddp.data import ShardedDataLoader as JaxLoader
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.parallel.mesh import hierarchical_mesh
from tpuddp.training import checkpoint as jax_ckpt
from tpuddp.training.loop import run_training_loop as jax_run_training_loop

from tpuddp_torch.training import graphs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_torch_port_hier_gloo4 import BASE, CAP, DENSITY, HOOKS, check_exchange, exchange_jobs, launch  # noqa: E402
from test_torch_port_zero1_gloo import _pieces, jax_init  # noqa: E402

WORLD = 2
CKPT = dict(BASE, comm_hook="int8_ef", num_epochs=2, checkpoint_epoch=1)
TOTAL = 22_058  # toy_cnn's parameters, even: no padding at world 2
WRAPS = {
    "auto": dict(BASE, comm_hook="int8_ef"),
    "none": dict(BASE, comm_hook="none"),
    "overlap_true": dict(BASE, comm_hook="int8_ef", comm_overlap=True),
    "zero1": dict(BASE, comm_hook="bf16_ef", weight_update_sharding=True),
}


def _arrays(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _jax_ddp(training, devices):
    mesh, train, test, augment, eval_transform, model, opt = _pieces(training, devices)
    mesh = hierarchical_mesh(devices=devices)
    ddp = JaxDDP(model, opt, JaxCrossEntropyLoss(), mesh=mesh, augment=augment,
                 eval_transform=eval_transform, comm_hook=training["comm_hook"], bucket_cap_mb=CAP,
                 topk_density=DENSITY, comm_topology="hierarchical")
    loaders = (JaxLoader(train, 32, mesh, shuffle=True), JaxLoader(test, 45, mesh, shuffle=True))
    return ddp, loaders


def _jax_state(ddp, init=None):
    kw = {} if init is None else dict(params=init[0], model_state=init[1])
    return ddp.init_state(jax.random.key(0), jnp.zeros((1, 8, 8, 3)), **kw)


@pytest.fixture(scope="module")
def init():
    return jax_init(BASE)


@pytest.fixture(scope="module")
def world2(tmp_path_factory, cpu_devices, init):
    """The JAX package's hierarchical file, then one 2-process launch: the
    exchanges, the wraps, the hierarchical int8_ef run with its checkpoints
    and the JAX file restored."""
    work = tmp_path_factory.mktemp("hier_world2")
    ddp, (train, test) = _jax_ddp(CKPT, cpu_devices[:WORLD])
    jax_run_training_loop(ddp, _jax_state(ddp, init), train, test, str(work / "jax"), num_epochs=1,
                          checkpoint_epoch=1, log=lambda *_: None)
    jobs, inputs = exchange_jobs(work, WORLD)
    jobs += [{"kind": "wrap", "name": f"wrap_{k}", "training": t} for k, t in WRAPS.items()]
    for name in ("straight", "from_jax", "flat_none", "hier_none"):
        np.savez(work / f"{name}_init.npz", **{k: v.numpy() for k, v in init[2].items()})
    jobs += [
        {"kind": "run", "name": "straight", "path": "native", "training": CKPT,
         "save_dir": str(work / "straight")},
        {"kind": "restore", "name": "from_jax", "path": "native", "training": CKPT,
         "dir": str(work / "jax")},
        {"kind": "run", "name": "flat_none", "path": "native",
         "training": dict(BASE, comm_hook="none", comm_topology="flat")},
        {"kind": "run", "name": "hier_none", "path": "native", "training": dict(BASE, comm_hook="none")},
    ]
    launch(work, jobs, WORLD)
    return work, inputs


@pytest.mark.parametrize("hook", HOOKS)
def test_the_hierarchical_exchange_matches_jax_world_2(cpu_devices, init, world2, hook):
    work, (g, r) = world2
    check_exchange(work, hook, init[0], g, r, cpu_devices[:WORLD])


@pytest.mark.parametrize("hook", ("none", "int8_ef"))
def test_the_wrap_splits_2_x_1_and_counts_the_jax_bytes(cpu_devices, world2, hook):
    work, _ = world2
    got = json.loads((work / f"wrap_{'auto' if hook == 'int8_ef' else 'none'}.json").read_text())
    assert got["hierarchy"] == [2, 1]
    ddp, _ = _jax_ddp(dict(BASE, comm_hook=hook), cpu_devices[:WORLD])
    _jax_state(ddp)
    assert got["bytes"] == [ddp.grad_comm_bytes_per_step, ddp.grad_comm_bytes_intra_host,
                            ddp.grad_comm_bytes_inter_host]
    # auto keeps the barrier step, with the JAX package's reason
    assert got["meta"] == {"enabled": False, "segments": None,
                           "reason": "comm_topology='hierarchical': a per-segment scatter would "
                                     "move the error-feedback residual's owner placement"}
    assert got["meta"] == ddp.comm_overlap_meta


def test_the_wrap_refuses_what_the_jax_package_refuses(cpu_devices, world2):
    work, _ = world2
    got = json.loads((work / "wrap_overlap_true.json").read_text())
    ddp, _ = _jax_ddp(dict(BASE, comm_hook="int8_ef"), cpu_devices[:WORLD])
    ddp.comm_overlap = True
    with pytest.raises(ValueError) as want:
        _jax_state(ddp)
    assert (got["error"], got["message"]) == ("ValueError", str(want.value))
    assert got["message"].startswith("comm_overlap=true refused: comm_topology='hierarchical'")
    got = json.loads((work / "wrap_zero1.json").read_text())
    assert got["error"] == "ValueError" and "mutually exclusive" in got["message"]


def test_a_cuda_graph_group_on_a_gloo_world_is_refused(world2):
    """Gloo's collectives run in host code, which a CUDA graph cannot hold:
    a group at world > 1 on Gloo raises before any work; at world 1 it
    does not."""
    work, _ = world2
    got = json.loads((work / "wrap_none.json").read_text())["capture"]
    assert "Gloo process group" in got and "scan_steps: 1" in got
    graphs.check_capturable()  # no process group here: nothing to refuse


def test_hook_none_at_2_x_1_trains_bitwise_the_flat_run(world2):
    work, _ = world2
    for rank in range(WORLD):
        hier, flat = (_arrays(work / f"{c}_{rank}.npz") for c in ("hier_none", "flat_none"))
        assert sorted(hier) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(hier[k], flat[k], err_msg=f"{rank} {k}")
        hier, flat = (_arrays(work / f"{c}_opt_{rank}.npz") for c in ("hier_none", "flat_none"))
        for k in flat:
            np.testing.assert_array_equal(hier[k], flat[k], err_msg=f"{rank} {k}")
    rows = [json.loads((work / f"{c}_history.json").read_text()) for c in ("hier_none", "flat_none")]
    assert [(r["train_loss"], r["test_loss"]) for r in rows[0]] == \
        [(r["train_loss"], r["test_loss"]) for r in rows[1]]


def test_the_port_file_holds_each_replicas_residual(world2):
    work, _ = world2
    file = _arrays(work / "straight" / "ckpt_1.npz")
    stored = file[".comm_state"]
    assert stored.shape == (WORLD * TOTAL,) and stored.dtype == np.float32
    for rank in range(WORLD):
        row = _arrays(work / f"straight_residual_{rank}.npz")["vec"]
        np.testing.assert_array_equal(stored[rank * TOTAL:(rank + 1) * TOTAL], row)
        # each replica owns its shard's loss: at 2 x 1 the whole vector
        assert row.any()
    topo = json.loads(str(file["__topology__"]))
    assert topo["leaves"][".comm_state"]["kind"] == "per_replica"


def test_the_jax_package_resumes_a_hierarchical_port_file_world_2(tmp_path, cpu_devices, world2):
    work, _ = world2
    directory = tmp_path / "run"
    shutil.copytree(work / "straight", directory)
    ddp, (train, test) = _jax_ddp(CKPT, cpu_devices[:WORLD])
    like = _jax_state(ddp)
    restored, next_epoch = jax_ckpt.restore_latest(str(directory), like, world_size=WORLD)
    assert next_epoch == 2
    np.testing.assert_array_equal(np.asarray(restored.comm_state),
                                  _arrays(directory / "ckpt_1.npz")[".comm_state"])
    _, history = jax_run_training_loop(ddp, like, train, test, str(directory), num_epochs=3,
                                       auto_resume=True, log=lambda *_: None)
    assert [r["epoch"] for r in history] == [2] and np.isfinite(history[0]["train_loss"])


def test_the_port_restores_a_hierarchical_jax_file_world_2(world2):
    work, _ = world2
    stored = _arrays(work / "jax" / "ckpt_0.npz")[".comm_state"]
    assert stored.shape == (WORLD * TOTAL,) and stored.any()
    for rank in range(WORLD):
        row = _arrays(work / f"from_jax_residual_{rank}.npz")["vec"]
        np.testing.assert_array_equal(row, stored[rank * TOTAL:(rank + 1) * TOTAL], err_msg=str(rank))
