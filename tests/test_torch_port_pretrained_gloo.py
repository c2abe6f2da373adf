"""``training.pretrained_path`` on two Gloo processes: both entry points
(native and managed) load a 1000-class AlexNet donor (written by the JAX
package's torchvision-layout model function, tests/test_torch_import.py) and swap
its head for 10 classes; at the wrap (0 epochs), every rank holds the same
model: the file's tensors but the head, and the head drawn from the
generator seeded by ``training.seed``.

Tolerance: bitwise (a load and a broadcast only move elements)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpuddp_torch import config as cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_torch_port_optim_train import _env  # noqa: E402
from test_torch_port_pretrained import donor  # noqa: E402

SPAWN_TIMEOUT_S = 300
PATHS = ("native", "managed")


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    work = tmp_path_factory.mktemp("pretrained_world2")
    sd = donor("alexnet", 1000)
    path = os.path.join(str(work), "alexnet_1000.pt")
    torch.save(sd, path)
    training = dict(cfg.TRAINING_DEFAULTS, model="alexnet", dataset="synthetic", synthetic_n=(16, 8),
                    train_batch_size=4, test_batch_size=4, image_size=64, seed=3, num_epochs=0,
                    pretrained_path=path)
    jobs = [{"kind": "run", "name": p, "path": p, "training": training} for p in PATHS]
    (work / "jobs.json").write_text(json.dumps(jobs))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_port_zero1_worker.py"), str(work)],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S, env=_env(),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count(f"Loaded pretrained alexnet weights from {path}.") == 2 * len(PATHS)
    yield work, sd
    shutil.rmtree(work)


@pytest.mark.parametrize("path", PATHS)
def test_every_rank_holds_the_file_and_the_same_head(world2, path):
    work, sd = world2
    ranks = [np.load(work / f"{path}_{r}.npz") for r in range(2)]
    assert sorted(ranks[0].files) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
        if not k.startswith("classifier.6."):
            np.testing.assert_array_equal(ranks[0][k], sd[k].numpy(), err_msg=k)
    bound = 1.0 / 4096 ** 0.5
    gen = torch.Generator().manual_seed(3)
    w = torch.empty(10, 4096).uniform_(-bound, bound, generator=gen)
    b = torch.empty(10).uniform_(-bound, bound, generator=gen)
    np.testing.assert_array_equal(ranks[0]["classifier.6.weight"], w.numpy())
    np.testing.assert_array_equal(ranks[0]["classifier.6.bias"], b.numpy())
