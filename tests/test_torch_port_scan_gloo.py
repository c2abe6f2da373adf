"""Native training at ``scan_steps: 4`` in the port on two Gloo processes
against the JAX native loop at ``scan_steps: 4`` on a 2-device CPU mesh:
toy_cnn with sync_bn, 45 rows per process in batches of 7 (7 batches: a
chunk of 4 and 3 single steps; at A = 2 a chunk of two cycles and a tail of
3 padded to two cycles), 2 epochs; both depths in one launch. Tolerances
are those of tests/test_torch_port_scan_train.py; every replica ends with
the same parameters and buffers, bitwise."""

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_torch_port_scan_train import assert_matches_jax, jax_scan_run  # noqa: E402
from test_torch_port_scan_train import init  # noqa: E402,F401  (module fixture)

SPAWN_TIMEOUT_S = 240
DEPTHS = (1, 2)


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    env.pop("TPUDDP_WORLD_SIZE", None)
    return env


def test_scan_steps_4_matches_the_jax_native_loop_world_2(tmp_path, cpu_devices, init):
    np.savez(tmp_path / "init.npz", **{k: v.numpy() for k, v in init[2].items()})
    (tmp_path / "run.json").write_text(json.dumps(list(DEPTHS)))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_port_scan_worker.py"), str(tmp_path)],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S, env=_env(),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    for accum in DEPTHS:
        with open(tmp_path / f"a{accum}_history.json") as f:
            history = json.load(f)
        finals = [dict(np.load(tmp_path / f"a{accum}_{r}.npz")) for r in range(2)]
        for k in finals[0]:
            np.testing.assert_array_equal(finals[0][k], finals[1][k], err_msg=k)
        step = int(finals[0].pop("__step__"))
        assert step == 2 * (7 + accum - 1)
        assert all(len(r["step_ms"]) == -(-7 // accum) for r in history)
        assert_matches_jax(history, finals[0], step, jax_scan_run(init, cpu_devices[:2], accum))
