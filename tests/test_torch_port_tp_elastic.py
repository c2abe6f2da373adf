"""The elastic legs of tensor parallelism on the port: the counterpart of
``tests/test_chaos.py:525-650`` with ``tests/_chaos_tp_worker.py``.

A 2 x 2 token job of 2 epochs (``tests/_torch_port_tp_worker.py --train``:
``transformer_tiny``, Gloo world 4, ``parallel: {model: 2}``,
``reshard_on_mismatch: true``) drained at epoch 1
(``TPUDDP_FAULT=preempt@epoch=1``: exit 75, ``ckpt_1.npz`` with
``completed=0``, the topology record of a model-2 file) auto-resumes at both
2-process shapes: 1 x 2 (``$TPUDDP_WORLD_SIZE=2``, the data axis shrinks;
the residual-free file loads as it is) and 2 x 1 (``$TPUDDP_MODEL_SIZE=1``,
a model-width crossing through the reshaper). Each run lands the
uninterrupted 2 x 2 run's per-epoch train losses within the JAX chaos
test's bound (rtol 1e-3, atol 2e-3), with the typed ``topology_change``
rows (model widths included) and the ``resumed_from_model`` header. The
baseline runs once, beside the drained run; the two legs run side by side.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np

from tpuddp_torch.training import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_port_tp_worker.py")
EPOCHS, EXIT_PREEMPTED, TIMEOUT_S = 2, 75, 300
RTOL, ATOL = 1e-3, 2e-3  # tests/test_chaos.py's train-loss parity bound


def _start(out_dir, **env):
    full = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    for var in ("TPUDDP_WORLD_SIZE", "TPUDDP_MODEL_SIZE", "TPUDDP_FAULT", "TPUDDP_AUTO_RESUME",
                "TPUDDP_HEARTBEAT_DIR", "TPUDDP_WATCHDOG_TIMEOUT"):
        full.pop(var, None)
    full.update({k: str(v) for k, v in env.items()})
    return subprocess.Popen([sys.executable, WORKER, "--train", str(out_dir), str(EPOCHS)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=full)


def _finish(proc, code=0):
    out, err = proc.communicate(timeout=TIMEOUT_S)
    assert proc.returncode == code, (proc.returncode, out[-2000:], err[-3000:])
    return out


def _records(out_dir):
    with open(os.path.join(str(out_dir), "history.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _losses(out_dir):
    rows = {r["epoch"]: r for r in _records(out_dir) if r.get("type") == "epoch"}
    assert sorted(rows) == list(range(EPOCHS))
    return [rows[e]["train_loss"] for e in range(EPOCHS)]


def test_a_drained_2x2_job_resumes_at_1x2_and_2x1(tmp_path):
    base, killed = tmp_path / "baseline", tmp_path / "tp_elastic"
    runs = [_start(base), _start(killed, TPUDDP_FAULT="preempt@epoch=1")]
    _finish(runs[0])
    _finish(runs[1], EXIT_PREEMPTED)
    emergency = str(killed / "ckpt_1.npz")
    assert ckpt.read_meta(emergency) == {"epoch": 1, "completed": 0}
    topo = ckpt.read_topology(emergency)
    assert (topo["world_size"], topo["model_size"], topo["mesh_shape"]) == (4, 2, [2, 2])
    assert topo["placement"][".params['embed']['weight']"] == ["model"]
    assert ".params['blocks'][0]['attn']['wqkv']" in topo["placement"]
    with np.load(emergency) as f:
        assert f[".params['blocks'][0]['attn']['wqkv']"].shape == (64, 3, 64)

    shrunk = tmp_path / "tp2dp1"
    shutil.copytree(str(killed), str(shrunk))
    legs = {"1x2": (shrunk, _start(shrunk, TPUDDP_AUTO_RESUME=1, TPUDDP_WORLD_SIZE=2,
                                   TPUDDP_MODEL_SIZE=2)),
            "2x1": (killed, _start(killed, TPUDDP_AUTO_RESUME=1, TPUDDP_WORLD_SIZE=2,
                                   TPUDDP_MODEL_SIZE=1))}
    outs = {label: _finish(proc) for label, (_, proc) in legs.items()}
    want = {"1x2": ((4, 2), (2, 2), {"data": 1, "model": 2}),
            "2x1": ((4, 2), (2, 1), {"data": 2, "model": 1})}
    base_losses = _losses(base)
    for label, (out_dir, _) in legs.items():
        assert "Auto-resume: continuing from epoch 1." in outs[label]
        records = _records(out_dir)
        events = [r for r in records if r.get("event") == "topology_change"]
        worlds, models, mesh = want[label]
        assert events and (events[0]["from_world"], events[0]["to_world"]) == worlds
        assert (events[0]["from_model"], events[0]["to_model"]) == models
        metas = [r for r in records if r.get("type") == "run_meta" and r.get("resumed_from_world")]
        assert metas and (metas[0]["resumed_from_world"], metas[0]["resumed_from_model"]) == (4, 2)
        assert {k: metas[0]["mesh"][k] for k in ("data", "model")} == mesh
        assert (metas[0]["mesh"]["tp_rules_hash"] is None) == (mesh["model"] == 1)
        np.testing.assert_allclose(_losses(out_dir), base_losses, rtol=RTOL, atol=ATOL,
                                   err_msg=label)
    # the model-width crossing relaid the QKV leaves, parameters and moments
    crossing = next(r for r in _records(killed) if r.get("event") == "topology_change")
    assert any(leaf.startswith(".opt_state") and leaf.endswith("['attn']['wqkv']")
               for leaf in crossing["resharded_leaves"]), crossing
    with np.load(str(killed / "ckpt_1.npz")) as f:  # epoch 1 redone and saved at model 1
        assert ckpt.read_topology(str(killed / "ckpt_1.npz"))["model_size"] == 1
        assert f[".params['blocks'][0]['attn']['wqkv']"].shape == (64, 192)  # canonical
