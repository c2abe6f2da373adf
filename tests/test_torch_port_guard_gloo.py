"""The numerical guard of the port on two Gloo processes, against the JAX
package's on a 2-device CPU mesh (``tests/_torch_port_guard_worker.py``):

- the auditor: synced replicas pass; with one rank's copy of a parameter
  moved, every rank names the leaf the JAX auditor names for the same
  perturbation of one device's copy (``tests/test_guard.py:393-428``);
- a poisoned batch on ONE rank skips the update on both (its NaN reaches
  the other through the exchange, or, under ZeRO-1, the verdict is the
  all-reduce MIN of the shards'): a bitwise no-op on every rank, the
  counters the JAX package's 2-device step gives, and the parameters after
  the following finite steps within PERF.md section 2's tolerances (rtol
  1e-4 / atol 1e-5) of the JAX run's;
- the exit-code contract: a rank whose parameters diverge after the wrap
  trips the epoch audit, and the launch of either entry point's worker
  exits 77 (``tpuddp/parallel/spawn.py:163-168``)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from tpuddp import nn as jax_nn
from tpuddp import optim as jax_optim
from tpuddp.models import ToyMLP as JaxToyMLP
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.resilience import guard as jax_guard

from tpuddp_torch import config as cfg
from tpuddp_torch.models.convert import state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_port_guard_worker.py")
SPAWN_TIMEOUT_S = 300
KEY = jax.random.key(0)
PERTURB = 2  # the JAX leaf index moved on rank 1: [3]['bias']
CASES = [["none", "none", False], ["int8_ef", "int8_ef", False], ["zero1_bf16_ef", "bf16_ef", True]]
STEPS, BAD, ROWS = 4, 1, 8  # step BAD poisons rank 1's rows only


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    env.pop("TPUDDP_WORLD_SIZE", None)
    env.pop("TPUDDP_FAULT", None)
    return env


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(i):
    rng = np.random.RandomState(100 + i)
    x = rng.randn(2 * ROWS, 8, 8, 3).astype(np.float32)
    if i == BAD:
        x[ROWS, 0, 0, 0] = np.nan  # the first row of rank 1's half
    return x, rng.randint(0, 10, 2 * ROWS).astype(np.int32)


def _mesh():
    return make_mesh(jax.devices("cpu")[:2])


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One 2-process launch of the checks; the JAX init it starts from."""
    work = tmp_path_factory.mktemp("guard_world2")
    jd = JaxDDP(JaxToyMLP(hidden=(16,)), jax_optim.Adam(1e-2), jax_nn.CrossEntropyLoss(),
                mesh=_mesh(), guard=True)
    js = jd.init_state(KEY, jnp.zeros((1, 8, 8, 3)))
    sd = state_dict_from_jax("toy_mlp", _np(js.params))
    np.savez(work / "init.npz", **{k: v.numpy() for k, v in sd.items()})
    arrays = {}
    for i in range(STEPS):
        x, y = _batch(i)
        for r in range(2):
            arrays[f"x{i}_{r}"], arrays[f"y{i}_{r}"] = x[r * ROWS:(r + 1) * ROWS], \
                y[r * ROWS:(r + 1) * ROWS]
    np.savez(work / "batches.npz", **arrays)
    (work / "jobs.json").write_text(json.dumps({"perturb": PERTURB, "cases": CASES}))
    proc = subprocess.run([sys.executable, WORKER, str(work), "checks"], capture_output=True,
                          text=True, timeout=SPAWN_TIMEOUT_S, env=_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    return work, js


def _perturb_one_device(mesh, params, leaf, device_idx=1, delta=0.25):
    """tests/test_guard.py's desynced world: one device's copy differs."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    host = np.asarray(leaves[leaf])
    shards = []
    for i, d in enumerate(mesh.devices.flat):
        h = host.copy()
        if i == device_idx:
            h.flat[0] += delta
        shards.append(jax.device_put(h, d))
    leaves[leaf] = jax.make_array_from_single_device_arrays(
        host.shape, NamedSharding(mesh, P()), shards)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def test_the_auditor_names_the_jax_packages_leaf_world_2(world2):
    work, js = world2
    mesh = _mesh()
    assert jax_guard.audit_params(mesh, js.params) is None
    theirs = jax_guard.audit_params(mesh, _perturb_one_device(mesh, js.params, PERTURB))
    assert theirs == "[3]['bias']"
    for r in range(2):
        with open(work / f"audit_{r}.json") as f:
            assert json.load(f) == [None, theirs]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_one_poisoned_rank_skips_the_update_on_both_world_2(world2, case):
    work, js0 = world2
    name, hook, zero1 = case
    jd = JaxDDP(JaxToyMLP(hidden=(16,)), jax_optim.Adam(1e-2), jax_nn.CrossEntropyLoss(),
                mesh=_mesh(), comm_hook=hook, weight_update_sharding=zero1, guard=True)
    js = jd.init_state(KEY, jnp.zeros((1, 8, 8, 3)), params=js0.params,
                       model_state=js0.model_state)
    counters = []
    for i in range(STEPS):
        x, y = _batch(i)
        js, _ = jd.train_step(js, jd.shard((x, y, np.ones(len(y), np.float32))))
        counters.append(list(jax_guard.read_skip_counters(js)))
    assert counters[BAD] == [1, 1] and counters[-1] == [1, 0]
    finals = []
    for r in range(2):
        with open(work / f"{name}_{r}.json") as f:
            got = json.load(f)
        assert got["counters"] == counters
        assert got["noop"] == [i == BAD for i in range(STEPS)]
        finals.append(dict(np.load(work / f"{name}_{r}.npz")))
    ref = state_dict_from_jax("toy_mlp", _np(js.params))
    for k, v in ref.items():
        np.testing.assert_array_equal(finals[0][k], finals[1][k], err_msg=k)
        np.testing.assert_allclose(finals[0][k], v.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("path", ["native", "managed"])
def test_a_divergent_rank_exits_77(tmp_path, path):
    training = dict(cfg.TRAINING_DEFAULTS, model="toy_mlp", dataset="synthetic",
                    synthetic_n=[32, 8], train_batch_size=8, test_batch_size=8, image_size=None,
                    flip=False, seed=0, num_epochs=2, checkpoint_epoch=5, prefetch=False,
                    guard={"audit_every_n_epochs": 1})
    (tmp_path / "training.json").write_text(json.dumps(training))
    proc = subprocess.run([sys.executable, WORKER, str(tmp_path), "desync", path],
                          capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S, env=_env())
    assert proc.returncode == 77, proc.stderr[-3000:]
    assert "cross-replica desync at epoch 0 audit: parameter leaf \"[1]['bias']\"" in proc.stderr
    with open(tmp_path / "history.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert records[0]["type"] == "run_meta"
    events = [r for r in records if r["type"] == "event"]
    assert events == [{"type": "event", "schema_version": 12, "event": "desync", "epoch": 0,
                       "leaf": "[1]['bias']"}]
