"""The hierarchical topology (``comm_topology: hierarchical``) across four
Gloo processes, split 2 hosts x 2 local, against the JAX package on the
factored ``("host", "local")`` mesh of 4 of the 8 virtual CPU devices
(``tpuddp.parallel.mesh.hierarchical_mesh``, its simulated 2 hosts), from
one JAX init and inputs made from a seed with numpy:

- ``GradComm.reduce_hierarchical`` of every hook: each rank's mean and
  residual, the residual also through the guard's staging vector;
- 2 epochs of configs/digits_tpu.yaml's block (toy_cnn with sync_bn on the
  digit scans at 8 px, batch 32, no flip) on the native path: hook ``none``,
  ``bf16_ef`` with accumulation 2 at ``scan_steps: 4``, ``int8_ef`` under
  the guard.

All runs of the port share one launch of ``tests/_torch_port_hier_worker.py``.

Tolerances. The exchange is bitwise: at 2 x 2 every sum is of two values
(the intra-host reduce-scatter, and the host hop's all-reduce, bf16 sum or
int8 / top-k gather), which Gloo and XLA round alike, and int8's dequantised
sum is computed with the JAX reduction's fused multiply-add rounding.

Training is held to ``SPREAD`` (4) times the JAX package's own spread
(tests/test_torch_port_comm_gloo.py's rule and reason), taken here as the
larger of its runs from an init one ulp higher and one ulp lower: at world
4 this block is ill-conditioned even without a hook. The port's FLAT
world-4 run with hook ``none`` parts from the JAX package's flat run by
1.45e-4 in the losses, as far as the JAX run from an init one ulp higher
does (1.45e-4), so rtol 1e-4 is out of reach for either topology; and with
``int8_ef`` (one bucket a shard: most elements quantise to a code of 0 or
1, and a one-ulp gradient change flips a code) the JAX package's run from
one ulp up moved its parameters by 7.5e-4, from one ulp down by 1.45e-3,
the port's by 4.1e-3. Hook ``none`` is also held against the port's own
flat world-4 run: the hierarchical exchange only re-brackets the sum, so
within ``REBRACKET`` (1e-6) of it.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from tpuddp.data import ShardedDataLoader as JaxLoader
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.parallel import comm as jax_comm
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.parallel.mesh import HOST_AXIS, LOCAL_AXIS, hierarchical_mesh
from tpuddp.training.loop import run_training_loop as jax_run_training_loop
from tpuddp.training.step import _tree_to_vec, _vec_to_tree
from tpuddp.utils.compat import shard_map

from tpuddp_torch.models import load_model
from tpuddp_torch.models.convert import jax_sizes, state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_torch_port_optim_train import _env, _np  # noqa: E402
from test_torch_port_zero1_gloo import BASE as ZERO1_BASE  # noqa: E402
from test_torch_port_zero1_gloo import _hw, _pieces, jax_init  # noqa: E402

WORLD = 4
SPAWN_TIMEOUT_S = 400
HOOKS = ("none", "bf16", "bf16_ef", "int8_ef", "topk_ef")
CAP, DENSITY = 0.002, 0.1
SPREAD = 4
SPREAD_LOSS_CAP = 1e-2
REBRACKET = 1e-6
BASE = dict(ZERO1_BASE, weight_update_sharding=False, learning_rate=1e-3,
            comm_topology="hierarchical", bucket_cap_mb=CAP, topk_density=DENSITY)
CASES = {
    "none": dict(comm_hook="none"),
    "flat_none": dict(comm_hook="none", comm_topology="flat"),
    "bf16_ef_accum_scan": dict(comm_hook="bf16_ef", gradient_accumulation_steps=2, scan_steps=4),
    "int8_ef_guard": dict(comm_hook="int8_ef", guard=True),
}


def _toy():
    return load_model("toy_cnn", 10, input_shape=(8, 8, 3))


def exchange_inputs(raw, total, world, seed=11):
    """Each rank's gradient (zero in the padding past ``raw``, as a
    flattened gradient is) and residual."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((world, total)) * 10.0 ** rng.uniform(-3, 0, (world, 1))).astype(np.float32)
    g[:, raw:] = 0
    r = (rng.standard_normal((world, total)) * 1e-3).astype(np.float32)
    return g, r


def jax_hier_exchange(hook, params, g, r, devices):
    """The JAX package's ``reduce_hierarchical`` in a ``shard_map`` over
    the factored mesh of ``devices``: per device its row of ``g`` and
    ``r``; ``(means (world, total), residuals (world, total) or None)``."""
    world = len(devices)
    mesh = hierarchical_mesh(devices=devices)
    plan = jax_comm.make_grad_comm(params, world, hook, CAP, density=DENSITY, force=True)
    res = jnp.asarray(r.reshape(-1)) if plan.needs_residual else None
    axes = (HOST_AXIS, LOCAL_AXIS)

    def body(g, r):
        out, new = plan.reduce_hierarchical(_vec_to_tree(g[0], plan.spec), r, LOCAL_AXIS, HOST_AXIS)
        return _tree_to_vec(out, plan.spec)[None], new

    fn = shard_map(body, mesh=mesh, in_specs=(P(axes), P(axes)), out_specs=(P(axes), P(axes)),
                   check_vma=False)
    vec, new = jax.jit(fn)(jnp.asarray(g), res)
    return np.asarray(vec), None if new is None else np.asarray(new).reshape(world, -1)


def exchange_jobs(work, world):
    sizes = jax_sizes("toy_cnn", _toy())
    total = world * -(-sum(sizes) // world)
    g, r = exchange_inputs(sum(sizes), total, world)
    jobs = []
    for hook in HOOKS:
        np.savez(work / f"exchange_{hook}_inputs.npz", g=g, r=r)
        jobs.append({"kind": "exchange", "name": f"exchange_{hook}", "hook": hook,
                     "sizes": list(sizes), "cap": CAP, "density": DENSITY})
    return jobs, (g, r)


def launch(work, jobs, world):
    (work / "jobs.json").write_text(json.dumps(jobs))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_port_hier_worker.py"), str(work),
         str(world)],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S, env=_env(),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]


def check_exchange(work, hook, params, g, r, devices):
    """Each rank's mean (its parameters' elements: the padding's mean is
    dropped by the unflatten, and the JAX output shows it as zeros) and
    residual bitwise the JAX package's; the staged residual equal to the
    in-place one, the residual it was staged beside untouched, the staging
    vector's other elements zero."""
    world = len(devices)
    raw = sum(jax_sizes("toy_cnn", _toy()))
    want, want_res = jax_hier_exchange(hook, params, g, r, devices)
    got = [dict(np.load(work / f"exchange_{hook}_{rank}.npz")) for rank in range(world)]
    assert [int(x["hosts"]) for x in got] == [2] * world
    assert [int(x["local"]) for x in got] == [world // 2] * world
    for rank in range(world):
        np.testing.assert_array_equal(got[rank]["reduce"][:raw], want[rank][:raw],
                                      err_msg=f"mean {rank}")
        np.testing.assert_array_equal(got[rank]["reduce"], got[0]["reduce"])
    if want_res is None:
        assert "residual" not in got[0]
        return
    shard_n = g.shape[1] // (world // 2)
    for rank in range(world):
        x = got[rank]
        np.testing.assert_array_equal(x["residual"], want_res[rank], err_msg=f"residual {rank}")
        np.testing.assert_array_equal(x["staged"], x["residual"])
        np.testing.assert_array_equal(x["kept"], r[rank])
        np.testing.assert_array_equal(x["again"], x["reduce"])
        lo = (rank % (world // 2)) * shard_n
        outside = np.concatenate([x["residual"][:lo], x["residual"][lo + shard_n:]])
        assert not outside.any() and x["residual"][lo:lo + shard_n].any()


def jax_reference(training, params, mstate, devices):
    """The JAX package's hierarchical native run of ``training``:
    ``(per-epoch (train_loss, test_loss), final state_dict)``."""
    _, train, test, augment, eval_transform, model, opt = _pieces(training, devices)
    mesh = hierarchical_mesh(devices=devices)
    ddp = JaxDDP(model, opt, JaxCrossEntropyLoss(), mesh=mesh, augment=augment,
                 eval_transform=eval_transform, grad_accumulation=training["gradient_accumulation_steps"],
                 comm_hook=training["comm_hook"], bucket_cap_mb=CAP, topk_density=DENSITY,
                 comm_topology="hierarchical", guard=training.get("guard"))
    hw = _hw(training)
    state = ddp.init_state(jax.random.key(0), jnp.zeros((1, hw, hw, 3)), params=params,
                           model_state=mstate)
    bs, tbs = training["train_batch_size"], training["test_batch_size"]
    state, history = jax_run_training_loop(
        ddp, state, JaxLoader(train, bs, mesh, shuffle=True), JaxLoader(test, tbs, mesh, shuffle=True),
        None, num_epochs=training["num_epochs"], scan_steps=training["scan_steps"],
        log=lambda *_: None)
    return ([(r["train_loss"], r["test_loss"]) for r in history],
            state_dict_from_jax("toy_cnn", _np(state.params), _np(state.model_state)))


def _ulp(tree, direction):
    return jax.tree_util.tree_map(lambda p: np.nextafter(p, direction).astype(p.dtype), tree)


def check_training(work, case, training, init, devices):
    with open(work / f"{case}_history.json") as f:
        history = json.load(f)
    world = len(devices)
    finals = [dict(np.load(work / f"{case}_{rank}.npz")) for rank in range(world)]
    for rank in range(1, world):  # every replica holds the same weights
        for k in finals[0]:
            np.testing.assert_array_equal(finals[0][k], finals[rank][k], err_msg=k)
    assert all(row["comm_topology"] == training["comm_topology"] for row in history)
    params, mstate, _ = init
    ref = jax_reference(training, params, mstate, devices)
    ours, theirs = np.array([(r["train_loss"], r["test_loss"]) for r in history]), np.array(ref[0])
    assert ours.shape == theirs.shape
    spread = {"losses": 0.0, "state": 0.0}
    for direction in (np.inf, -np.inf):
        alt = jax_reference(training, _ulp(params, direction), mstate, devices)
        spread["losses"] = max(spread["losses"], float(np.max(np.abs(np.array(alt[0]) / theirs - 1))))
        spread["state"] = max(spread["state"], max(
            float(np.abs(alt[1][k].numpy() - ref[1][k].numpy()).max()) for k in ref[1]))
    got = {"losses": float(np.max(np.abs(ours / theirs - 1))),
           "state": max(float(np.abs(finals[0][k] - ref[1][k].numpy()).max()) for k in ref[1])}
    detail = {k: (got[k], spread[k], got[k] / spread[k]) for k in got}
    assert 0 < spread["losses"] < SPREAD_LOSS_CAP and 0 < spread["state"], detail
    for k in got:
        assert got[k] <= SPREAD * spread[k], f"{case}: (port, JAX spread, ratio) {detail}"


@pytest.fixture(scope="module")
def init():
    return jax_init(BASE)


@pytest.fixture(scope="module")
def world4(tmp_path_factory, init):
    work = tmp_path_factory.mktemp("hier_world4")
    jobs, inputs = exchange_jobs(work, WORLD)
    for case, overrides in CASES.items():
        np.savez(work / f"{case}_init.npz", **{k: v.numpy() for k, v in init[2].items()})
        jobs.append({"kind": "run", "name": case, "path": "native", "training": dict(BASE, **overrides)})
    launch(work, jobs, WORLD)
    return work, inputs


@pytest.mark.parametrize("hook", HOOKS)
def test_the_hierarchical_exchange_matches_jax_world_4(cpu_devices, init, world4, hook):
    work, (g, r) = world4
    check_exchange(work, hook, init[0], g, r, cpu_devices[:WORLD])


@pytest.mark.parametrize("case", sorted(c for c in CASES if c != "flat_none"))
def test_hierarchical_training_matches_jax_world_4(cpu_devices, init, world4, case):
    work, _ = world4
    check_training(work, case, dict(BASE, **CASES[case]), init, cpu_devices[:WORLD])


def test_hierarchical_none_rebrackets_the_flat_run_world_4(world4):
    """Hook ``none`` under ``hierarchical`` sums the same gradients in
    another bracketing: the port's run stays within ``REBRACKET`` of its
    flat run, losses and weights."""
    work, _ = world4
    hier, flat = (dict(np.load(work / f"{c}_0.npz")) for c in ("none", "flat_none"))
    for k in flat:
        np.testing.assert_allclose(hier[k], flat[k], rtol=0, atol=REBRACKET, err_msg=k)
    rows = [json.load(open(work / f"{c}_history.json")) for c in ("none", "flat_none")]
    for a, b in zip(*rows):
        for key in ("train_loss", "test_loss"):
            assert abs(a[key] - b[key]) <= REBRACKET * abs(b[key]), (key, a, b)
        assert b["grad_comm_bytes_intra_host"] == 0 < a["grad_comm_bytes_intra_host"]
