"""``training.mode: auto`` on the native path against the JAX package's
``mode="auto"`` on the CPU: the port in one process against a 1-device
mesh, and on two Gloo processes (tests/_torch_port_auto_worker.py) against
a 2-device mesh. toy_cnn (its BatchNorms over the global batch), Adam, one
flip mask of the global batch fed to both packages (each draws its own
masks from its own stream otherwise), a padded row:

- 3 train steps with hooks ``none`` and ``bf16_ef`` (the replicated
  ``(total,)`` residual), and guarded (a NaN weight in replica 1's rows
  skips the step on every replica), then the eval sums;
- the native loop at ``scan_steps: 2`` with ``bf16_ef``, 2 epochs;
- the header's byte counters and overlap block; ``comm_overlap: true``,
  ZeRO-1 and hierarchical with ``auto`` refused with the JAX texts;
- ``auto`` checkpoints cross-loaded both ways (the residual ``data_flat``);
- the global batch's dropout mask, each replica its rows.

Tolerances: losses and eval sums rtol 1e-4, and without a hook the
parameters too (atol 1e-6), those of tests/test_torch_port_scan_train.py:
float32 convolutions and sums in another order. ``bf16_ef`` rounds each
gradient element to the bf16 grid, so a last-bit difference moves an
element by a whole bf16 step now and then and Adam carries it on: its
parameters, buffers and residual are held, as in
tests/test_torch_port_comm_gloo.py, to ``SPREAD`` (4) times the JAX
package's own spread (its run from an init one ulp higher). Counts,
byte counters, texts, the replicas against each other and the file
round trips are exact."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp import optim as jax_optim
from tpuddp.data import ShardedDataLoader as JaxLoader
from tpuddp.data import transforms as jax_tf
from tpuddp.data.synthetic import SyntheticClassification as JaxSynthetic
from tpuddp.models import ToyCNN as JaxToyCNN
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.training import checkpoint as jax_ckpt
from tpuddp.training.loop import run_training_loop as jax_run_training_loop

from tpuddp_torch import config as cfg
from tpuddp_torch.models.convert import state_dict_from_jax
from tpuddp_torch.nn.layers import global_batch_dropout
from tpuddp_torch.training import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import _torch_port_auto_worker as W  # noqa: E402

SPAWN_TIMEOUT_S = 240
RTOL, P_ATOL = 1e-4, 1e-6
SPREAD = 4  # tests/test_torch_port_comm_gloo.py's multiple of the JAX package's own spread


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def init():
    params, mstate = JaxToyCNN(num_classes=10, widths=W.WIDTHS).init(
        jax.random.key(11), jnp.zeros((1, *W.SHAPE)))
    return params, mstate, state_dict_from_jax("toy_cnn", _np_tree(params), _np_tree(mstate))


@pytest.fixture(scope="module")
def batches():
    rng = np.random.RandomState(3)
    w = np.ones((W.STEPS, W.GLOBAL), np.float32)
    w[-1, -1] = 0.0  # the last batch's padded row
    return {"x": rng.randint(0, 256, (W.STEPS, W.GLOBAL, *W.SHAPE)).astype(np.uint8),
            "y": rng.randint(0, 10, (W.STEPS, W.GLOBAL)).astype(np.int32), "w": w}


@pytest.fixture(scope="module")
def gloo(tmp_path_factory, init, batches):
    """The worker's world-2 outputs: ``{case: [rank 0, rank 1]}`` and the
    loop's ``(history, [finals])``."""
    work = tmp_path_factory.mktemp("auto_gloo")
    np.savez(work / "init.npz", **{k: v.numpy() for k, v in init[2].items()})
    np.savez(work / "batches.npz", **batches)
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    env.pop("TPUDDP_WORLD_SIZE", None)
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tests", "_torch_port_auto_worker.py"),
                           str(work)], capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S,
                          env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    out = {name: [dict(np.load(work / f"{name}_{r}.npz")) for r in range(2)] for name in W.CASES}
    with open(work / "loop_history.json") as f:
        out["loop"] = (json.load(f), [dict(np.load(work / f"loop_{r}.npz")) for r in range(2)])
    out["dir"] = work
    return out


def _jax_augment():
    """The JAX augment with :data:`W.FLIP` applied to the global batch
    (flip before normalize, as the port's; the two flips are equal,
    tests/test_torch_port_data.py)."""
    plain = jax_tf.make_train_augment(size=None, flip=False)
    mask = jnp.asarray(W.FLIP)[:, None, None, None]
    return lambda rng, x: plain(rng, jnp.where(mask, x[:, :, ::-1, :], x))


def jax_ddp(devices, init, hook="none", guard=False, **kw):
    params, mstate, _ = init
    ddp = JaxDDP(JaxToyCNN(num_classes=10, widths=W.WIDTHS), jax_optim.Adam(W.LR),
                 JaxCrossEntropyLoss(), mesh=make_mesh(devices), mode="auto", comm_hook=hook,
                 guard=guard, augment=_jax_augment(),
                 eval_transform=jax_tf.make_eval_transform(size=None), **kw)
    state = ddp.init_state(jax.random.key(0), jnp.zeros((1, *W.SHAPE)), params=params,
                           model_state=mstate)
    return ddp, state


def jax_steps(devices, init, batches, hook, guard):
    ddp, state = jax_ddp(devices, init, hook, guard)
    sums = []
    for i in range(W.STEPS):
        batch = (batches["x"][i], batches["y"][i], W.weights(batches["w"], i, guard))
        state, m = ddp.train_step(state, ddp.shard(batch))
        sums.append([float(np.asarray(m[k]).sum()) for k in ("loss_sum", "n")])
    ev = ddp.eval_step(state, ddp.shard((batches["x"][0], batches["y"][0], batches["w"][0])))
    out = {f"sd/{k}": v.numpy() for k, v in state_dict_from_jax(
        "toy_cnn", _np_tree(state.params), _np_tree(state.model_state)).items()}
    out.update(sums=np.array(sums), eval=np.array([float(np.asarray(ev[k]).sum())
                                                   for k in ("loss_sum", "correct", "n")]),
               skipped=np.array([0, 0] if state.skipped_steps is None else [
                   int(state.skipped_steps["total"]), int(state.skipped_steps["consecutive"])]),
               bytes=np.array([ddp.grad_comm_bytes_per_step, ddp.grad_comm_bytes_per_step_f32]))
    if state.comm_state is not None and np.size(state.comm_state):
        out["residual"] = np.asarray(state.comm_state)
    return out


def _port_world(world, name, init, batches, gloo):
    """The port's arrays of case ``name`` at ``world``, summed over the
    replicas where the JAX package reports the global batch's."""
    hook, guard = W.CASES[name]
    if world == 1:
        torch.set_num_threads(2)
        batches = {k: torch.from_numpy(v) for k, v in batches.items()}
        return W.steps(0, 1, init[2], batches, hook, guard)
    ranks = gloo[name]
    for k in ranks[0]:  # the replicas agree bitwise (one global step)
        if k not in ("sums", "eval"):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    out = dict(ranks[0])
    out["sums"] = ranks[0]["sums"] + ranks[1]["sums"]
    out["eval"] = ranks[0]["eval"] + ranks[1]["eval"]
    return out


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("name", list(W.CASES))
def test_three_auto_steps_match_the_jax_auto_step(cpu_devices, init, batches, gloo, world, name):
    ours = _port_world(world, name, init, batches, gloo)
    ref = jax_steps(cpu_devices[:world], init, batches, *W.CASES[name])
    np.testing.assert_allclose(ours["sums"], ref["sums"], rtol=RTOL)  # NaN where the guard skips
    np.testing.assert_allclose(ours["eval"], ref["eval"], rtol=RTOL)
    np.testing.assert_array_equal(ours["skipped"], ref["skipped"])
    np.testing.assert_array_equal(ours["bytes"], ref["bytes"])
    if W.CASES[name][1]:
        assert ref["skipped"].tolist() == [1, 0]
    keys = [k for k in ref if k.startswith("sd/") or k == "residual"]
    assert ("residual" in ours) == ("residual" in ref) == (W.CASES[name][0] != "none")
    if W.CASES[name][0] == "none":
        for k in keys:
            np.testing.assert_allclose(ours[k], ref[k], rtol=RTOL, atol=P_ATOL, err_msg=k)
    else:
        alt = jax_steps(cpu_devices[:world], _ulp_up(init), batches, *W.CASES[name])
        _within_jax_spread(ours, ref, alt, keys)


def _ulp_up(init):
    """The JAX init one float32 ulp higher."""
    params, mstate, _ = init
    return jax.tree_util.tree_map(lambda p: np.nextafter(p, np.inf).astype(p.dtype),
                                  _np_tree(params)), mstate, None


def _within_jax_spread(ours, ref, alt, keys):
    """The port's state is as close to the JAX run as :data:`SPREAD` times
    the JAX run from an init one ulp higher (``alt``) is: per group, the
    parameters and buffers, and the residual."""
    groups = {"state": [k for k in keys if k != "residual"],
              "residual": [k for k in keys if k == "residual"]}
    for group, names in groups.items():
        if not names:
            continue
        spread = max(float(np.abs(alt[k] - ref[k]).max()) for k in names)
        got = max(float(np.abs(ours[k] - ref[k]).max()) for k in names)
        assert 0 < spread and got <= SPREAD * spread, (group, got, spread, got / spread)


def jax_loop(devices, init):
    params, mstate, _ = init
    mesh = make_mesh(devices)
    ddp = JaxDDP(JaxToyCNN(num_classes=10, widths=W.WIDTHS), jax_optim.Adam(W.LR),
                 JaxCrossEntropyLoss(), mesh=mesh, mode="auto", comm_hook="bf16_ef")
    state = ddp.init_state(jax.random.key(0), jnp.zeros((1, *W.SHAPE)), params=params,
                           model_state=mstate)
    train, test = JaxSynthetic(n=W.DATA_N, shape=W.SHAPE, seed=W.DATA_SEED).split(W.DATA_TEST)
    state, history = jax_run_training_loop(
        ddp, state, JaxLoader(train, W.BATCH, mesh, shuffle=True),
        JaxLoader(test, W.BATCH, mesh, shuffle=True), save_dir=None, num_epochs=W.EPOCHS,
        scan_steps=W.SCAN, log=lambda *_: None)
    final = state_dict_from_jax("toy_cnn", _np_tree(state.params), _np_tree(state.model_state))
    return history, {k: v.numpy() for k, v in final.items()}


@pytest.mark.parametrize("world", [1, 2])
def test_the_scan_steps_2_loop_matches_the_jax_auto_loop(cpu_devices, init, gloo, world):
    if world == 1:
        torch.set_num_threads(2)
        history, final = W.loop(0, 1, init[2])
    else:
        history, finals = gloo["loop"]
        for k in finals[0]:
            np.testing.assert_array_equal(finals[0][k], finals[1][k], err_msg=k)
        final = finals[0]
    ref_history, ref_final = jax_loop(cpu_devices[:world], init)
    _, alt_final = jax_loop(cpu_devices[:world], _ulp_up(init))
    assert len(history) == len(ref_history) == W.EPOCHS
    for ours, theirs in zip(history, ref_history):
        assert ours["scan_steps"] == W.SCAN
        for key in ("train_samples", "test_samples"):
            assert ours[key] == theirs[key], key
        for key in ("train_loss", "test_loss", "test_accuracy"):
            np.testing.assert_allclose(ours[key], theirs[key], rtol=RTOL, err_msg=key)
    _within_jax_spread(final, ref_final, alt_final, list(ref_final))


@pytest.mark.parametrize("hook", ["none", "bf16_ef", "int8_ef"])
def test_the_header_counters_and_overlap_equal_the_jax_auto_header(cpu_devices, init, hook):
    """World 1 here; world 2's counters are compared in the step test."""
    ours = W.make_ddp(init[2], hook, False)
    ref, _ = jax_ddp(cpu_devices[:1], init, hook)
    assert ours.grad_comm_bytes_per_step == ref.grad_comm_bytes_per_step
    assert ours.grad_comm_bytes_per_step_f32 == ref.grad_comm_bytes_per_step_f32
    assert ours.grad_comm_bytes_inter_host == ref.grad_comm_bytes_inter_host
    assert ours.grad_comm_bytes_intra_host == ref.grad_comm_bytes_intra_host
    assert ours.comm_overlap_meta == ref.comm_overlap_meta
    assert ours.comm_overlap_meta["reason"].startswith("mode='auto' has no explicit collective")


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_auto_refusals_carry_the_jax_texts(cpu_devices, init):
    """``comm_overlap: true`` (the wrap), ZeRO-1 (the config check and the
    wrap) and hierarchical (the wrap) with ``mode: auto``."""
    ref = _error(lambda: jax_ddp(cpu_devices[:1], init, comm_overlap=True))
    assert _error(lambda: W.make_ddp(init[2], "none", False, comm_overlap=True)) == ref
    assert ref.startswith("comm_overlap=true refused: mode='auto'")
    ref = _error(lambda: jax_ddp(cpu_devices[:1], init, weight_update_sharding=True))
    assert ref.startswith("weight_update_sharding requires mode='shard_map'")
    training = {"mode": "auto", "weight_update_sharding": True}
    assert _error(lambda: cfg.check_weight_update_sharding(training)) == ref
    assert _error(lambda: W.make_ddp(init[2], "none", False, weight_update_sharding=True)) == ref
    ref = _error(lambda: jax_ddp(cpu_devices[:1], init, comm_topology="hierarchical"))
    assert "mode='auto' lets XLA place the collective" in ref
    assert _error(lambda: W.make_ddp(init[2], "none", False,
                                     comm_topology="hierarchical")) == ref


def _same_state(model_sd, residual, state):
    want = state_dict_from_jax("toy_cnn", _np_tree(state.params), _np_tree(state.model_state))
    for k, v in want.items():
        np.testing.assert_array_equal(model_sd[k], v.numpy(), err_msg=k)
    np.testing.assert_array_equal(residual, np.asarray(state.comm_state))


@pytest.mark.parametrize("world", [1, 2])
def test_auto_checkpoints_cross_load_both_ways(cpu_devices, init, batches, gloo, tmp_path, world):
    """The port's ``auto`` file (``bf16_ef`` after 3 steps, at ``world``)
    restores in the JAX package on a ``world``-device mesh with the same
    params, moments and residual (tagged ``data_flat``), and the JAX
    package's file of that state restores into the port bitwise, its
    residual fitted to this world (re-padded from world 2)."""
    torch.set_num_threads(2)
    tb = {k: torch.from_numpy(v) for k, v in batches.items()}
    ddp = W.make_ddp(init[2], "bf16_ef", False)
    rows = slice(0, W.GLOBAL)
    for i in range(W.STEPS):
        ddp.train_step((tb["x"][i][rows], tb["y"][i][rows], tb["w"][i][rows]))
    ours = tmp_path / "ours"
    if world == 1:
        ckpt.save_on_main(str(ours), 0, ddp.model, ddp.optimizer, 0, step=ddp.step,
                          comm_state=ddp.residual, residual_replicated=True)
    else:  # the worker's rank-0 state, written as the world-2 run would
        ours.mkdir()
        for f in os.listdir(gloo["dir"] / "ckpt"):
            (ours / f).write_bytes((gloo["dir"] / "ckpt" / f).read_bytes())
    path = str(ours / "ckpt_0.npz")
    assert ckpt.read_topology(path)["leaves"][".comm_state"] == {"kind": "data_flat"}
    jddp, like = jax_ddp(cpu_devices[:world], init, "bf16_ef")
    restored, next_epoch = jax_ckpt.restore_latest(str(ours), like, world_size=world)
    assert next_epoch == 1
    sd = {k: v.numpy() for k, v in (ddp.model.state_dict() if world == 1 else {
        k[3:]: torch.from_numpy(v) for k, v in gloo["bf16_ef"][0].items() if k.startswith("sd/")
    }).items()}
    residual = ddp.residual.numpy() if world == 1 else gloo["bf16_ef"][0]["residual"]
    _same_state(sd, residual, restored)
    # and back: the JAX package's file of that state into a fresh port wrap
    theirs = tmp_path / "theirs"
    jax_ckpt.save_on_main(str(theirs), 0, restored, world_size=world)
    fresh = W.make_ddp(init[2], "bf16_ef", False)
    ckpt.restore_latest(str(theirs), fresh.model, fresh.optimizer, comm_state=fresh.residual,
                        residual_replicated=True)
    _same_state({k: v.numpy() for k, v in fresh.model.state_dict().items()},
                fresh.residual.numpy(), restored)
    assert {int(st["step"]) for st in fresh.optimizer.state.values()} == {W.STEPS}


@pytest.mark.parametrize("rank", [0, 1])
def test_the_dropout_mask_is_the_global_batchs_rows(rank):
    """``mode: auto``'s one dropout key a step: replica ``rank`` of 2, its
    stream seeded as every replica's, keeps its rows of the mask the whole
    global batch draws at world 1."""
    x = torch.randn(8, 6)
    model = torch.nn.Sequential(torch.nn.Dropout(0.5))
    torch.manual_seed(5)
    whole = model(x)
    global_batch_dropout(model, rank, 2)
    torch.manual_seed(5)
    mine = model(x[rank * 4:(rank + 1) * 4])
    assert torch.equal(mine, whole[rank * 4:(rank + 1) * 4]) and (mine == 0).any()
    model.eval()
    assert torch.equal(model(x[:4]), x[:4])
