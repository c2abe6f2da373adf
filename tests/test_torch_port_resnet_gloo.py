"""``resnet18_small`` with ``sync_bn`` (configs/multihost.yaml's block, cut
to the synthetic stand-in at its 32 px: 64 train and 32 test images, batch
8 per process, one step per batch, no flip: the two packages draw their
flips from different streams) for 2 epochs through the port's native
entry point on two Gloo processes, replicated and under ZeRO-1
(``weight_update_sharding``), against the JAX package's
``DistributedDataParallel`` on a 2-device CPU mesh from the same JAX init.

Both replicas end bitwise equal. Tolerance: losses rtol 1e-4 and the final
parameters and BatchNorm statistics rtol 1e-4 / atol 1e-5, or, where the
JAX package's own run moves by more than that from an init one ulp higher
(a train-mode BatchNorm net under Adam: each step's near-zero gradient
elements take either sign under float32 rounding), within 4 times that
move, the rule tests/test_torch_port_comm_gloo.py holds hooked runs to."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tpuddp_torch import config as cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_torch_port_optim_train import _env, _np  # noqa: E402
from test_torch_port_zero1_gloo import jax_init, jax_reference  # noqa: E402
from test_torch_port_resnet import _ulp_up, _within  # noqa: E402

SPAWN_TIMEOUT_S = 400
TRAINING = dict(
    cfg.TRAINING_DEFAULTS, model="resnet18_small", sync_bn=True, dataset="synthetic",
    synthetic_n=(64, 32), train_batch_size=8, test_batch_size=16, image_size=None, seed=0,
    num_epochs=2, checkpoint_epoch=1, learning_rate=1e-3, scan_steps=1, flip=False,
)
CASES = {"replicated": False, "zero1": True}


@pytest.fixture(scope="module")
def init():
    return jax_init(TRAINING)


@pytest.fixture(scope="module")
def world2(tmp_path_factory, init):
    """One 2-process Gloo launch of both port runs."""
    work = tmp_path_factory.mktemp("resnet_world2")
    jobs = []
    for case, wus in CASES.items():
        np.savez(work / f"{case}_init.npz", **{k: v.numpy() for k, v in init[2].items()})
        jobs.append({"kind": "run", "name": case, "path": "native",
                     "training": dict(TRAINING, weight_update_sharding=wus)})
    (work / "jobs.json").write_text(json.dumps(jobs))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_port_zero1_worker.py"), str(work)],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S, env=_env(),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return work


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_processes_match_the_jax_mesh(cpu_devices, init, world2, case):
    wus = CASES[case]
    params, mstate, _ = init
    training = dict(TRAINING, weight_update_sharding=wus)
    ref_losses, ref_sd, _ = jax_reference("native", training, params, mstate, cpu_devices[:2], wus=wus)
    up_losses, up_sd, _ = jax_reference("native", training, _ulp_up(_np(params)), mstate,
                                        cpu_devices[:2], wus=wus)
    with open(world2 / f"{case}_history.json") as f:
        history = json.load(f)
    assert len(history) == len(ref_losses) == TRAINING["num_epochs"]
    got = np.array([(r["train_loss"], r["test_loss"]) for r in history])
    ref, up = np.array(ref_losses), np.array(up_losses)
    _within(got, ref, np.abs(up - ref), f"{case} losses", per_tensor=False)
    final = [np.load(world2 / f"{case}_{r}.npz") for r in range(2)]
    assert sorted(final[0].files) == sorted(ref_sd)
    for k in ref_sd:
        np.testing.assert_array_equal(final[0][k], final[1][k])  # the replicas agree
        want = np.asarray(ref_sd[k])
        _within(final[0][k], want, np.abs(np.asarray(up_sd[k]) - want), f"{case} {k}",
                per_tensor=False)
