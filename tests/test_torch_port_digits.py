"""The digits dataset of the port (tpuddp_torch/data/digits.py) against the
JAX package's (tpuddp/data/digits.py), on the CPU: the committed arrays
(``tpuddp_torch/data/digits.npz``), the seeded 1,437/360 split and the
normalization statistics, bitwise; the arrays load without scikit-learn; tpuddp_torch/configs/digits_h100.yaml's training block
against configs/digits_tpu.yaml's; both entry points' builders at the native
8 px (``image_size: null``); and that block (toy_cnn with sync_bn) for one
epoch through the native entry point on 1 and 2 Gloo processes against the
JAX package, from the JAX init.

Tolerances (PERF.md section 2): losses rtol 1e-4, parameters rtol 1e-4 /
atol 1e-5; the data bitwise."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from tpuddp import config as jax_cfg
from tpuddp.data import digits as jax_digits
from tpuddp.data import flip_for as jax_flip_for
from tpuddp.data import norm_stats_for as jax_norm_stats_for

from tpuddp_torch import config as cfg
from tpuddp_torch import train_accelerate, train_native
from tpuddp_torch.data import digits, flip_for, load_datasets_for, norm_stats_for

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import _torch_port_entry_worker as entry_worker  # noqa: E402
from test_torch_port_optim_train import (  # noqa: E402
    SPAWN_TIMEOUT_S, _env, assert_run_close, jax_init, jax_reference,
)

PORT_SETTINGS = os.path.join(ROOT, "tpuddp_torch", "configs", "digits_h100.yaml")
JAX_SETTINGS = os.path.join(ROOT, "configs", "digits_tpu.yaml")


def _settings(path):
    with open(path) as f:
        return yaml.safe_load(f)


def _training():
    """The port's and the JAX package's merged training blocks, one epoch."""
    port = cfg.training_config(_settings(PORT_SETTINGS))
    ref = jax_cfg.training_config(_settings(JAX_SETTINGS))
    return dict(port, num_epochs=1), dict(ref, num_epochs=1)


def test_arrays_split_and_statistics_are_the_jax_packages():
    images, labels = digits._load_arrays()
    ref_images, ref_labels = jax_digits._load_arrays()
    assert images.shape == (1797, 8, 8, 3) and images.dtype == np.uint8 and labels.dtype == np.int32
    np.testing.assert_array_equal(images, ref_images)
    np.testing.assert_array_equal(labels, ref_labels)
    for ours, ref in zip(load_datasets_for({"dataset": "digits"}), jax_digits.load_datasets()):
        np.testing.assert_array_equal(ours.images, ref.images)
        np.testing.assert_array_equal(ours.labels, ref.labels)
    train, test = digits.load_datasets()
    assert (len(train), len(test)) == (1437, 360) and train.num_classes == 10
    assert (digits.DIGITS_MEAN, digits.DIGITS_STD) == (jax_digits.DIGITS_MEAN, jax_digits.DIGITS_STD)
    for training in ({"dataset": "digits"}, {"dataset": "cifar10"}, {}):
        assert norm_stats_for(training) == jax_norm_stats_for(training)
        assert flip_for(training) == jax_flip_for(training)
    assert cfg.num_classes_from({"dataset": "digits"}) == 10


def test_without_scikit_learn_digits_raise_an_import_error(monkeypatch):
    """Digits need no scikit-learn at run time: with it unimportable they
    load from ``tpuddp_torch/data/digits.npz``, bitwise the arrays read with
    it, and no ImportError is raised."""
    images, labels = digits._load_arrays()
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    again, again_labels = digits._load_arrays()
    np.testing.assert_array_equal(images, again)
    np.testing.assert_array_equal(labels, again_labels)
    train, test = digits.load_datasets()
    assert (len(train), len(test)) == (1437, 360)


def test_the_settings_file_is_the_jax_packages_block():
    port, ref = _settings(PORT_SETTINGS), _settings(JAX_SETTINGS)
    assert port["training"] == ref["training"]
    assert port["local"]["device"] == "cuda"
    training = cfg.training_config(port)
    assert (training["model"], training["sync_bn"], training["image_size"]) == ("toy_cnn", True, None)


@pytest.mark.parametrize("path", ["native", "managed"])
def test_both_entry_points_build_digits_at_8_px(path):
    training, _ = _training()
    if path == "native":
        ddp, loader, _, _ = train_native.build_training(0, 1, training, "cpu")
        model, augment = ddp.model, ddp.augment
    else:
        _, prepared, _, loader, _, _, _ = train_accelerate.build_training(training, "cpu")
        model, augment = prepared.module, prepared.accelerator.augment
    x, y, w = next(iter(loader))
    x = augment(torch.as_tensor(np.asarray(x)))
    assert tuple(x.shape) == (32, 8, 8, 3)
    assert tuple(model(x).shape) == (32, 10)


@pytest.fixture(scope="module")
def init():
    return jax_init(_training()[1])


def test_digits_epoch_matches_jax_world_1(cpu_devices, init):
    training, ref_training = _training()
    history, final = entry_worker.run(0, 1, "native", training, init[2])
    ref_losses, ref_sd = jax_reference("native", ref_training, init[0], init[1], cpu_devices[:1])
    assert_run_close(history, final, ref_losses, ref_sd, "digits world 1")
    assert history[0]["train_samples"] == 1437 and history[0]["test_samples"] == 360


def test_digits_epoch_matches_jax_world_2(tmp_path, cpu_devices, init):
    training, ref_training = _training()
    np.savez(tmp_path / "digits_init.npz", **{k: v.numpy() for k, v in init[2].items()})
    (tmp_path / "run.json").write_text(json.dumps(
        [{"name": "digits", "path": "native", "training": training}]))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_port_entry_worker.py"), str(tmp_path)],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S, env=_env(),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp_path / "digits_history.json") as f:
        history = json.load(f)
    finals = [dict(np.load(tmp_path / f"digits_{r}.npz")) for r in range(2)]
    for k in finals[0]:
        np.testing.assert_array_equal(finals[0][k], finals[1][k], err_msg=k)
    ref_losses, ref_sd = jax_reference("native", ref_training, init[0], init[1], cpu_devices[:2])
    assert_run_close(history, finals[0], ref_losses, ref_sd, "digits world 2")
