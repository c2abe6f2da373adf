"""The pretrained fine-tune (``training.pretrained_path``,
``tpuddp_torch/models/pretrained.py``) against the JAX package's loader
(``tpuddp/models/torch_import.py``), on the CPU, with donor files written
by the JAX package's own torchvision-layout model functions
(tests/test_torch_import.py), so that the port is not judged against
itself:

- the names: the JAX package's 16, and its ``ValueError`` texts for any
  other model and for a dataset without a class count;
- per name (``pretrained_tests``; this file holds ``resnet18``,
  ``resnet18_s2d`` and ``resnet50``, tests/test_torch_port_pretrained_
  {alexnet,vgg}.py the others): from a 1000-class donor, every tensor but
  the swapped head bitwise the JAX load through the bridge, the head
  ``(num_classes, in)`` from ``num_classes`` or from the dataset, drawn
  U(-1/sqrt(in), 1/sqrt(in)) from the generator; from a 10-class donor the
  whole model bitwise;
- malformed files (a wrong shape, a missing key, a missing shortcut, an
  extra key, ``num_batches_tracked``): refused with the JAX loader's
  exception type where it refuses, and loaded as it loads them where it
  accepts them.

Tolerance: bitwise throughout (a load only moves elements).
"""

import os
import sys
from contextlib import contextmanager

import jax
import numpy as np
import pytest
import torch

from tpuddp.models import torch_import

from tpuddp_torch import config as cfg
from tpuddp_torch.models.convert import state_dict_from_jax
from tpuddp_torch.models.pretrained import PRETRAINED_NAMES, load_pretrained, pretrained_from_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_torch_import import (  # noqa: E402
    _torch_vgg, _TorchResNet18, _TorchResNet50, torch_alexnet,
)

# name -> (the JAX tests' function that builds its torchvision-layout donor, image size)
DONORS = {
    "alexnet": (torch_alexnet, 64), "alexnet_s2d": (torch_alexnet, 64),
    "vgg11": (lambda n: _torch_vgg("vgg11", n), 32),
    "resnet18": (_TorchResNet18, 32), "resnet18_s2d": (_TorchResNet18, 32),
    "resnet50": (lambda n: _TorchResNet50(num_classes=n), 32),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def donor(name, num_classes, seed=0):
    """The ``state_dict`` of a torchvision-layout donor of ``name`` with
    ``num_classes`` outputs (non-trivial BatchNorm statistics for a
    ResNet)."""
    torch.manual_seed(seed)
    model = DONORS[name][0](num_classes)
    if name.startswith("resnet"):
        model.train()
        with torch.no_grad():
            model(torch.randn(4, 3, 64, 64))
    return model.state_dict()


@contextmanager
def saved(directory, state_dict, stem="donor"):
    """``state_dict`` in a file of ``directory`` while the block runs (a
    full-width donor is up to 0.5 GB; none outlives its test)."""
    path = os.path.join(str(directory), f"{stem}.pt")
    torch.save(state_dict, path)
    try:
        yield path
    finally:
        os.remove(path)


def _training(name, path, **kw):
    return dict(cfg.TRAINING_DEFAULTS, model=name, pretrained_path=path, seed=0,
                image_size=DONORS[name][1], **kw)


def jax_load(training):
    """The JAX package's load of ``training`` as the port's ``state_dict``
    (numpy leaves in the port's layout, via the bridge)."""
    _, params, mstate = torch_import.pretrained_from_config(training)
    name = str(training["model"])
    return state_dict_from_jax(name.replace("_s2d", ""), _np(params),
                               _np(mstate) if name.startswith("resnet") else None)


def _head(name):
    return "fc" if name.startswith("resnet") else "classifier.6"


def outcome(load, training):
    """``("ok", state_dict)`` or the exception's type."""
    try:
        return "ok", load(training)
    except (KeyError, ValueError) as e:
        return type(e), None


def port_load(training):
    return pretrained_from_config(training).state_dict()


# ------------------------------------------------------------------ names --

def test_the_names_are_the_jax_loaders():
    assert sorted(PRETRAINED_NAMES) == sorted(torch_import._PRETRAINED_LOADERS)
    assert len(PRETRAINED_NAMES) == 16


@pytest.mark.parametrize("name", ["resnet18_small", "toy_cnn", "toy_mlp", "resnet50_small"])
def test_other_models_are_the_jax_value_error(name):
    training = dict(cfg.TRAINING_DEFAULTS, model=name, pretrained_path="/nonexistent.pt")
    with pytest.raises(ValueError) as ours:
        pretrained_from_config(training)
    with pytest.raises(ValueError) as theirs:
        torch_import.pretrained_from_config(training)
    assert str(ours.value) == str(theirs.value)


def test_a_dataset_without_a_class_count_is_the_jax_value_error():
    training = dict(cfg.TRAINING_DEFAULTS, model="resnet18", pretrained_path="/nonexistent.pt",
                    dataset="imagenet")
    with pytest.raises(ValueError) as ours:
        pretrained_from_config(training)
    with pytest.raises(ValueError) as theirs:
        torch_import.pretrained_from_config(training)
    assert str(ours.value) == str(theirs.value)


def test_the_settings_accept_pretrained_path():
    training = cfg.training_config({"training": {"model": "vgg16", "pretrained_path": "/w.pt"}})
    assert training["pretrained_path"] == "/w.pt"


# --------------------------------------------------------------- per name --

def pretrained_tests(names):
    """The load tests of ``names``, for a test module's namespace."""

    @pytest.mark.parametrize("name", names)
    def test_a_1000_class_donor_loads_as_the_jax_package_loads_it(tmp_path, name):
        torch.set_num_threads(2)
        sd = donor(name, 1000)
        with saved(tmp_path, sd) as path:
            training = _training(name, path)
            want = jax_load(training)
            model = pretrained_from_config(training, torch.Generator().manual_seed(0))
            assert model.pretrained_from == path
            # the head's width from the settings: explicit, else the dataset's
            for extra, width in (({"num_classes": 7}, 7), ({"dataset": "digits"}, 10)):
                assert pretrained_from_config(dict(training, **extra)).get_submodule(
                    _head(name)).out_features == width
        got = model.state_dict()
        head = _head(name)
        assert list(got) == list(want)
        for k, v in got.items():
            if not k.startswith(head + "."):
                assert torch.equal(v, want[k]), k
                assert torch.equal(v, sd[k].float()), k  # the file's own tensor
        in_f = sd[f"{head}.weight"].shape[1]
        assert got[f"{head}.weight"].shape == (10, in_f) == want[f"{head}.weight"].shape
        # U(-1/sqrt(in), 1/sqrt(in)) drawn from the generator: weight, then bias
        bound = 1.0 / in_f ** 0.5
        draw = torch.Generator().manual_seed(0)
        w = torch.empty(10, in_f).uniform_(-bound, bound, generator=draw)
        b = torch.empty(10).uniform_(-bound, bound, generator=draw)
        assert torch.equal(got[f"{head}.weight"], w) and torch.equal(got[f"{head}.bias"], b)

    @pytest.mark.parametrize("name", names)
    def test_a_10_class_donor_loads_whole_and_bitwise(tmp_path, name):
        torch.set_num_threads(2)
        sd = donor(name, 10, seed=1)
        with saved(tmp_path, sd) as path:
            training = _training(name, path)
            want = jax_load(training)
            got = pretrained_from_config(training).state_dict()
        assert list(got) == list(want)
        for k, v in got.items():
            assert torch.equal(v, want[k]) and torch.equal(v, sd[k].float()), k

    return {f.__name__: f for f in (test_a_1000_class_donor_loads_as_the_jax_package_loads_it,
                                    test_a_10_class_donor_loads_whole_and_bitwise)}


def malformed_test(name, cases):
    """A parametrised test of ``name``'s malformed files: ``cases`` maps a
    case id to a function that edits the donor's ``state_dict``."""

    @pytest.mark.parametrize("case", sorted(cases))
    def test_malformed_files_are_refused_or_accepted_as_the_jax_loader_does(tmp_path, case):
        torch.set_num_threads(2)
        sd = dict(donor(name, 10, seed=2))
        cases[case](sd)
        with saved(tmp_path, sd, "malformed") as path:
            training = _training(name, path)
            ours, got = outcome(port_load, training)
            theirs, want = outcome(jax_load, training)
            assert ours == theirs, (case, ours, theirs)
            if ours == "ok":
                for k, v in got.items():
                    assert torch.equal(v, want[k]), k
            else:
                with pytest.raises(ours) as err:
                    port_load(training)
                key = MALFORMED_KEYS.get(case)
                assert key is None or key in str(err.value), (case, str(err.value))

    return {test_malformed_files_are_refused_or_accepted_as_the_jax_loader_does.__name__:
            test_malformed_files_are_refused_or_accepted_as_the_jax_loader_does}


def _shrink(key):
    def edit(sd):
        sd[key] = sd[key][..., :-1].clone()
    return edit


def _drop(*keys):
    def edit(sd):
        for k in keys:
            del sd[k]
    return edit


def _add(key, value):
    def edit(sd):
        sd[key] = value
    return edit


# the key a refusal names, by case
MALFORMED_KEYS = {
    "wrong shape": None, "missing key": None, "missing shortcut": "layer2.0",
    "extra key": "layer1.2.conv1.weight",
}
RESNET_CASES = {
    "wrong shape": _shrink("layer3.1.conv2.weight"),
    "missing key": _drop("layer2.1.bn1.running_var"),
    "missing shortcut": _drop(*(f"layer2.0.downsample.{k}" for k in (
        "0.weight", "1.weight", "1.bias", "1.running_mean", "1.running_var"))),
    "extra key": _add("layer1.2.conv1.weight", torch.zeros(64, 64, 3, 3)),
    "num_batches_tracked": _add("bn1.num_batches_tracked", torch.tensor(7)),
    "head without its key": _drop("fc.weight"),
}

globals().update(pretrained_tests(["resnet18", "resnet18_s2d", "resnet50"]))
globals().update(malformed_test("resnet18", RESNET_CASES))


def test_the_refusals_name_the_key(tmp_path):
    """A wrong shape and a missing key name the tensor."""
    sd = donor("resnet18", 10, seed=3)
    for edit, key in ((_shrink("layer3.1.conv2.weight"), "layer3.1.conv2.weight"),
                      (_drop("layer2.1.bn1.running_var"), "layer2.1.bn1.running_var")):
        bad = dict(sd)
        edit(bad)
        with saved(tmp_path, bad, "bad") as path:
            with pytest.raises((KeyError, ValueError), match=key.replace(".", r"\.")):
                load_pretrained("resnet18", path, 10, torch.Generator())
