"""Step snapshots of a tensor-parallel job on the port, the offline
reshaper command and the fleet's TP resize, against the JAX package.

A ``2 x 2`` token job (``tests/_torch_port_tp_worker.py --train``:
``transformer_tiny``, Gloo world 4, ``parallel: {model: 2}``,
``scan_steps: 2``, a step snapshot every 2 micro-batches) runs straight and,
beside it, drained by ``TPUDDP_FAULT=preempt@step=5``: exit 75 from the
launcher, every rank's drain at the same dispatch, one v4 step file
(``ckpt_1_s2.npz``) carrying the model-2 topology. Auto-resumed at ``2 x
2`` it continues the epoch at its step and ends bitwise the straight run
(every epoch row and the last checkpoint's parameters and moments); with
``reshard_on_mismatch`` it restores at ``2 x 1`` through the reshaper, redoes
the epoch (a resharded restore carries no plan key, as in the JAX loop) and
finishes; the same file restored at model 1 in process holds, bitwise, the
parameters the JAX TP wrap gathers from it.
The JAX ``restore_latest`` on a ``2 x 2`` CPU mesh reads that step file, and
the JAX engine writes the same arrays from it. ``python -m
tpuddp_torch.inspect reshard`` writes the arrays ``tools/tpuddp_inspect.py
reshard`` writes, with its exit codes and texts. The fleet resizes a
running ``2 x 2`` job to ``1 x 2`` through the drain with
``$TPUDDP_MODEL_SIZE`` pinned (``tests/test_chaos.py:654``'s counterpart).
"""

import json
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpuddp import optim as jax_optim
from tpuddp.models import load_model as jax_load_model
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.parallel import tensor as jax_tp
from tpuddp.parallel.mesh2d import mesh2d as jax_mesh2d
from tpuddp.training import checkpoint as jax_ckpt
from tpuddp.training import snapshot as jax_snap
from tpuddp_torch.fleet.controller import FleetController
from tpuddp_torch.fleet.spec import JobSpec
from tpuddp_torch.models import load_model
from tpuddp_torch.models.convert import torch_layout
from tpuddp_torch.optim import Adam
from tpuddp_torch.observability import schema
from tpuddp_torch.resilience.supervisor import SupervisorPolicy
from tpuddp_torch.training import checkpoint as ckpt
from tpuddp_torch.training import snapshot as snap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_port_tp_worker.py")
EPOCHS, EVERY, PREEMPT_STEP, EXIT_PREEMPTED, TIMEOUT_S = 2, 2, 5, 75, 300
STEP_FILE = "ckpt_1_s2.npz"  # step 5 is epoch 1's 2nd micro-batch: the chunk of 2 ends it
NAME, V, T, B = "transformer_tiny", 64, 32, 8


def _env(**more):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    for var in ("TPUDDP_WORLD_SIZE", "TPUDDP_MODEL_SIZE", "TPUDDP_FAULT", "TPUDDP_AUTO_RESUME",
                "TPUDDP_HEARTBEAT_DIR", "TPUDDP_WATCHDOG_TIMEOUT", "TPUDDP_SPAWNED"):
        env.pop(var, None)
    env.update({k: str(v) for k, v in more.items()})
    return env


def _start(out_dir, epochs=EPOCHS, every=EVERY, **env):
    return subprocess.Popen([sys.executable, WORKER, "--train", str(out_dir), str(epochs),
                             str(every)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=_env(**env))


def _finish(proc, code=0):
    out, err = proc.communicate(timeout=TIMEOUT_S)
    assert proc.returncode == code, (proc.returncode, out[-2000:], err[-3000:])
    return out, err


def _records(out_dir):
    with open(os.path.join(str(out_dir), "history.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _epochs(out_dir):
    rows = [r for r in _records(out_dir) if r.get("type") == "epoch"]
    keep = ("epoch", "train_loss", "train_samples", "test_loss", "test_accuracy", "test_samples")
    return [{k: r.get(k) for k in keep} for r in rows]


def _arrays(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_snapshot")
    straight, drained, shrunk = root / "straight", root / "drained", root / "tp2dp1"
    procs = [_start(straight), _start(drained, TPUDDP_FAULT=f"preempt@step={PREEMPT_STEP}")]
    _finish(procs[0])
    _, drain_err = _finish(procs[1], EXIT_PREEMPTED)
    step_file = str(drained / STEP_FILE)
    shutil.copytree(str(drained), str(shrunk))
    kept = root / "step_file"
    kept.mkdir()
    for suffix in ("", ".sha256"):
        shutil.copy(step_file + suffix, str(kept))
    legs = [_start(drained, TPUDDP_AUTO_RESUME=1),
            _start(shrunk, TPUDDP_AUTO_RESUME=1, TPUDDP_WORLD_SIZE=2, TPUDDP_MODEL_SIZE=1)]
    resumed_out, _ = _finish(legs[0])
    shrunk_out = "".join(_finish(legs[1]))
    return dict(straight=straight, drained=drained, shrunk=shrunk, step_file=str(kept / STEP_FILE),
                drain_err=drain_err, resumed_out=resumed_out, shrunk_out=shrunk_out)


def test_the_drain_stops_every_rank_at_one_step_in_a_model_2_step_file(runs):
    err = runs["drain_err"]
    for rank in range(4):
        assert f"rank {rank}; snapshot engine:" in err
    assert err.count("training preempted during epoch 1") == 4
    path = runs["step_file"]
    assert ckpt.read_meta(path) == {"epoch": 1, "completed": 0, "step": 2}
    topo = ckpt.read_topology(path)
    assert (topo["format"], topo["world_size"], topo["model_size"], topo["mesh_shape"]) == \
        (ckpt.FORMAT_VERSION, 4, 2, [2, 2])
    assert topo["placement"][".params['embed']['weight']"] == ["model"]
    with np.load(path) as f:
        assert f[".params['blocks'][0]['attn']['wqkv']"].shape == (64, 3, 64)  # the TP layout
    cursor = ckpt.read_cursor(path)
    assert (cursor["epoch"], cursor["step"]) == (1, 2)
    preempt = [r for r in _records(runs["drained"]) if r.get("event") == "preempt"]
    # the row counts micro-batches from the run's start: epoch 0's 4, then 2
    assert [(p["epoch"], p["step"], p["completed"]) for p in preempt] == [(1, 6, False)]


def test_the_resumed_2x2_job_is_bitwise_its_straight_run(runs):
    assert "Exact resume: epoch 1 continues at step 2 (zero batches replayed)." in \
        runs["resumed_out"]
    assert _epochs(runs["drained"]) == _epochs(runs["straight"])
    assert [r["epoch"] for r in _epochs(runs["straight"])] == list(range(EPOCHS))
    ours, theirs = (_arrays(str(runs[k] / f"ckpt_{EPOCHS - 1}.npz")) for k in ("drained", "straight"))
    keys = [k for k in theirs if k.startswith((".params", ".opt_state", ".step"))]
    assert any(".opt_state.m" in k for k in keys) and any(".opt_state.v" in k for k in keys)
    assert sorted(ours) == sorted(theirs)
    for k in keys:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    for d in ("drained", "straight"):
        errors, _ = schema.validate_history_file(str(runs[d] / "history.jsonl"))
        assert not errors, errors


def test_the_step_file_restores_at_2x1_through_the_reshaper(runs):
    # a resharded restore drops the plan key (the data plan is the world's):
    # the JAX loop's rule, epoch 1 is redone from the step file's state
    assert "Step snapshot for epoch 1 carries no plan key (resharded restore): redoing the " \
        "epoch." in runs["shrunk_out"]
    records = _records(runs["shrunk"])
    topo = [r for r in records if r.get("event") == "topology_change"]
    assert topo and (topo[0]["from_world"], topo[0]["to_world"], topo[0]["from_model"],
                     topo[0]["to_model"]) == (4, 2, 2, 1)
    assert topo[0]["checkpoint"].endswith(STEP_FILE)
    metas = [r for r in records if r.get("type") == "run_meta" and r.get("resumed_from_world")]
    assert metas and metas[0]["mesh"]["model"] == 1 and metas[0]["resumed_from_model"] == 2
    rows = _epochs(runs["shrunk"])
    assert [r["epoch"] for r in rows] == list(range(EPOCHS))
    assert rows[0] == _epochs(runs["straight"])[0] and np.isfinite(rows[1]["train_loss"])
    errors, _ = schema.validate_history_file(str(runs["shrunk"] / "history.jsonl"))
    assert not errors, errors


def test_the_jax_restore_latest_reads_the_tp_step_file(runs, cpu_devices, tmp_path):
    """The JAX TP wrap on a ``(2, 2)`` CPU mesh restores the port's step
    file at its step (``cursor_out``), and the JAX engine, handed that
    state and cursor, writes the port's arrays."""
    ddp = JaxDDP(jax_load_model(NAME, num_classes=V), jax_optim.Adam(1e-3), JaxCrossEntropyLoss(),
                 mesh=jax_mesh2d(2, 2, devices=cpu_devices[:4]))
    like = ddp.init_state(jax.random.key(0), jnp.zeros((1, T), jnp.int32))
    batch = tuple(np.zeros((B, T), np.int32) for _ in range(2)) + (np.ones((B, T), np.float32),)
    like, _ = ddp.train_step(like, ddp.shard(batch))
    cursors = []
    state, epoch = jax_ckpt.restore_latest(os.path.dirname(runs["step_file"]), like, world_size=4,
                                           model_size=2, cursor_out=cursors)
    assert epoch == 1 and (cursors[0]["epoch"], cursors[0]["step"]) == (1, 2)
    acc = snap.acc_from_cursor(cursors[0])
    engine = jax_snap.SnapshotEngine(str(tmp_path / "jax"), jax_snap.SnapshotConfig(
        every_steps=EVERY, async_writes=False), world_size=4)
    path = engine.final_snapshot(state, epoch=1, step=2, plan_key=cursors[0]["plan_key"],
                                 acc={k: jnp.asarray(v) for k, v in acc.items()})
    engine.close()
    ours, theirs = _arrays(runs["step_file"]), _arrays(path)
    keys = [k for k in theirs if k.startswith((".params", ".opt_state", ".step"))]
    assert any("wqkv" in k for k in keys) and any(".opt_state.m" in k for k in keys)
    for k in keys:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert jax_ckpt.read_topology(runs["step_file"])["model_size"] == 2
    # the port's restore at model 1 through the reshaper: the parameters the
    # JAX TP wrap gathered from the same file, bitwise
    model = load_model(NAME, V)
    opt = Adam(model.parameters(), lr=1e-3)
    ckpt.restore_latest(os.path.dirname(runs["step_file"]), model, opt, reshard_on_mismatch=True)
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    gathered = torch_layout(NAME, host(jax_tp.gather_params(state)))
    moments = torch_layout(NAME, jax_tp.from_tp_tree(host(state.opt_state.m)))
    params = dict(model.named_parameters())
    assert sorted(model.state_dict()) == sorted(gathered)
    for k, v in gathered.items():
        np.testing.assert_array_equal(params[k].detach().numpy(), np.asarray(v), err_msg=k)
        np.testing.assert_array_equal(opt.state[params[k]]["exp_avg"].numpy(),
                                      np.asarray(moments[k]), err_msg=k)


def _cli(args, jax_side):
    cmd = ([sys.executable, os.path.join(ROOT, "tools", "tpuddp_inspect.py")] if jax_side
           else [sys.executable, "-m", "tpuddp_torch.inspect"])
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    return subprocess.run(cmd + args, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)


def test_the_inspect_reshard_command_is_the_jax_one(runs, tmp_path):
    src = runs["step_file"]
    outs = {}
    for side in (False, True):
        out = str(tmp_path / f"{'jax' if side else 'port'}.npz")
        proc = _cli(["reshard", src, "--to", "data=2,model=1", "--out", out], side)
        assert proc.returncode == 0, proc.stderr
        outs[side] = (proc.stdout.replace(out, "<out>"), _arrays(out))
        assert ckpt.verify_file(out, require_manifest=True)
    assert outs[False][0] == outs[True][0] and "relayout" in outs[False][0]
    ours, theirs = outs[False][1], outs[True][1]
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert ckpt.read_topology(str(tmp_path / "port.npz"))["model_size"] == 1
    # the refusals, the missing file and the argument errors, code for code
    for args in (["reshard", src, "--to", "data=1,model=3", "--out", str(tmp_path / "x.npz")],
                 ["reshard", str(tmp_path / "missing.npz"), "--to", "data=1"],
                 ["reshard", src, "--to", "model=2"],
                 ["tune", str(runs["straight"]), "--json"]):
        port, jax_run = _cli(args, False), _cli(args, True)
        assert port.returncode == jax_run.returncode, (args, port.stderr, jax_run.stderr)
        if args[0] == "tune" and port.returncode == 0:
            assert json.loads(port.stdout) == json.loads(jax_run.stdout)
        else:
            assert port.stderr.splitlines()[-1].replace("python -m tpuddp_torch.inspect", "") == \
                jax_run.stderr.splitlines()[-1].replace("tpuddp_inspect.py", ""), args


def test_the_fleet_resizes_a_2x2_job_to_1x2_through_the_drain(tmp_path):
    """A running ``model_size: 2`` job displaced by a higher-priority
    arrival drains to exit 75 and relaunches at the clamped smaller world
    with ``$TPUDDP_MODEL_SIZE`` pinned: the child derives data 1 and
    finishes every epoch (``tests/test_chaos.py:654``)."""
    epochs = 4
    c = FleetController(4, fleet_dir=str(tmp_path), env=_env(),
                        supervisor_policy=SupervisorPolicy(backoff_base=0.1, backoff_cap=0.5))
    tp = c.submit(JobSpec(name="tp-job", kind="training", priority=0, min_world=2, max_world=4,
                          model_size=2,
                          argv=(sys.executable, "-u", WORKER, "--train", "{run_dir}",
                                str(epochs))))
    try:
        c.step()
        assert tp.state == "running" and tp.supervisor.world_size == 4
        assert tp.supervisor.model_size == 2
        deadline = time.monotonic() + TIMEOUT_S
        while not os.path.exists(os.path.join(tp.run_dir, "ckpt_0.npz")):
            assert time.monotonic() < deadline and tp.state == "running", tp.state
            c.step()
            time.sleep(0.1)
        c.submit(JobSpec(name="filler", kind="training", priority=1, min_world=2, max_world=2,
                         argv=(sys.executable, "-c", "import time; time.sleep(600)")))
        assert c.run_until(lambda ctl: ctl.jobs["tp-job"].state in ("done", "failed"),
                           poll=0.2, timeout=TIMEOUT_S)
        assert tp.state == "done", (tp.state, tp.exit_code)
        assert tp.resizes >= 1
    finally:
        c.shutdown(timeout=60)
    assert [(rc, w) for _, rc, w in tp.supervisor.history] == [(75, 4), (0, 2)]
    records = _records(tp.run_dir)
    assert sorted({r["epoch"] for r in records if r.get("type") == "epoch"}) == list(range(epochs))
    events = [r for r in records if r.get("event") == "topology_change"]
    assert events and (events[0]["from_world"], events[0]["to_world"]) == (4, 2)
    assert (events[0]["from_model"], events[0]["to_model"]) == (2, 2)
    metas = [r for r in records if r.get("type") == "run_meta" and r.get("resumed_from_world")]
    assert metas and (metas[0]["mesh"]["data"], metas[0]["mesh"]["model"]) == (1, 2)
    errors, _ = schema.validate_history_file(os.path.join(tp.run_dir, "history.jsonl"))
    assert not errors
