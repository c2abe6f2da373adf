"""Fine-tune from a torchvision checkpoint on disk — the counterpart of the
fine-tune half of ``tpuddp/models/torch_import.py`` (:138-236, :408-425,
:501-543), the reference tutorial's central move: a pretrained model with
its head swapped for the dataset's classes (``data_and_toy_model.py:41-45``).

The port's models are laid out as torchvision's, so a checkpoint loads by
key with no conversion. :func:`load_pretrained` accepts and refuses the
files the JAX loader does:

- the head's width is read from the checkpoint (``classifier.6.weight``,
  ResNets ``fc.weight``; a ``KeyError`` without it) and the model is built
  at that width;
- every parameter and BatchNorm statistic the model holds must be in the
  file (a ``KeyError`` naming the key; a ResNet block whose projection
  shortcut is missing is the JAX ``ValueError``) at the model's shape (a
  ``ValueError`` naming the key);
- AlexNet and the VGGs ignore any other key in the file; a ResNet refuses
  them (``ValueError``), but for ``num_batches_tracked``;
- where the file's head width differs from ``num_classes``, a fresh
  ``Linear(in, num_classes)`` takes the head's place, drawn U(-1/sqrt(in),
  1/sqrt(in)) from the caller's generator (the JAX head's law,
  ``tpuddp/nn/layers.py:35-46``; the JAX package draws it from a key).

One stricter check: a bias of the wrong shape is refused here, where the
JAX loader takes it and its first step fails.

:func:`convert_transformer_state_dict` is the JAX package's import of a
torch transformer checkpoint (``tpuddp/models/torch_import.py:429-500``):
the file's tensors in the JAX parameter tree, with its refusals. The port's
:class:`~tpuddp_torch.models.transformer.TransformerLM` loads such a file by
key as it is.

The model is built on the meta device and takes the file's tensors as its
own (float32), so loading draws nothing from torch's generators. It
carries ``pretrained_from`` (the path), by which the managed path leaves
out the JAX init key's draw, as ``tpuddp/accelerate.py:597-605`` does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

import numpy as np

from tpuddp_torch.models import RESNET_NAMES, VGG_NAMES, load_model
from tpuddp_torch.models.resnet import Bottleneck
from tpuddp_torch.nn.layers import Linear

# the JAX package's _PRETRAINED_LOADERS (tpuddp/models/torch_import.py:501-519)
PRETRAINED_NAMES = ("alexnet", "alexnet_s2d", *(n for n in RESNET_NAMES if not n.endswith("_small")),
                    *VGG_NAMES)


def _is_resnet(name: str) -> bool:
    return name.startswith("resnet")


def _head(name: str) -> str:
    """The head Linear's module name."""
    return "fc" if _is_resnet(name) else "classifier.6"


def _checked(name: str, model: torch.nn.Module, state_dict) -> Dict[str, torch.Tensor]:
    """The file's tensors for every key of ``model``'s ``state_dict``, in
    float32, after the JAX loader's checks."""
    out = {}
    for key, want in model.state_dict().items():
        if key not in state_dict:
            block = key.split(".downsample.")[0]
            if ".downsample." in key and f"{block}.downsample.0.weight" not in state_dict:
                raise ValueError(
                    f"{block}: checkpoint lacks expected tensors ['down_bn', 'down_conv'] "
                    "(truncated file or a different shortcut variant)")
            raise KeyError(key)
        t = state_dict[key]
        if tuple(t.shape) != tuple(want.shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} != expected {tuple(want.shape)}")
        out[key] = t.detach().to(torch.float32).contiguous()
    if _is_resnet(name):
        leftover = sorted(k for k in state_dict if k not in out and not k.endswith("num_batches_tracked"))
        if leftover:
            convs = 3 if isinstance(model.layer1[0], Bottleneck) else 2
            raise ValueError(
                f"checkpoint has {len(leftover)} tensors this ResNet{model.depths} ({convs}-conv "
                f"block) layout does not consume (e.g. {leftover[:3]}); wrong architecture?")
    return out


def load_pretrained(name: str, path: str, num_classes: int, generator: torch.Generator) -> torch.nn.Module:
    """The port's model ``name`` (one of :data:`PRETRAINED_NAMES`) on the
    CPU holding the torchvision checkpoint at ``path``, its head swapped
    for a fresh ``num_classes`` one drawn from ``generator`` where the
    widths differ."""
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state_dict, "state_dict"):
        state_dict = state_dict.state_dict()
    head = _head(name)
    head_out = int(state_dict[f"{head}.weight"].shape[0])
    with torch.device("meta"):
        model = load_model(name, head_out)
    model.load_state_dict(_checked(name, model, state_dict), assign=True)
    if head_out != num_classes:
        in_f = model.get_submodule(head).in_features
        fresh = Linear(in_f, num_classes, device="meta").to_empty(device="cpu")
        bound = 1.0 / math.sqrt(in_f)
        with torch.no_grad():
            fresh.weight.uniform_(-bound, bound, generator=generator)
            fresh.bias.uniform_(-bound, bound, generator=generator)
        parent, _, child = head.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, child, fresh)
    model.pretrained_from = path
    return model


def pretrained_from_config(training, generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    """``training.pretrained_path`` as the entry points load it
    (``tpuddp/models/torch_import.py:522-545``): the model name checked,
    the class count from the settings, the head's generator seeded from
    ``training.seed`` (0 when unset), the same on every rank, unless the
    caller gives one."""
    from tpuddp_torch.config import num_classes_from

    name = str(training["model"])
    if name not in PRETRAINED_NAMES:
        raise ValueError(
            "training.pretrained_path supports models "
            f"{sorted(PRETRAINED_NAMES)} (got {training['model']!r})"
        )
    if generator is None:
        generator = torch.Generator().manual_seed(int(training.get("seed") or 0))
    return load_pretrained(name, str(training["pretrained_path"]), num_classes_from(training), generator)


def _shapes_checked(tag: str, new: dict, expect) -> dict:
    """Every array of ``new`` (nested) at the shape of its place in
    ``expect``, else the JAX converter's ``ValueError`` naming it."""
    for k, arr in new.items():
        exp = expect.get(k) if isinstance(expect, dict) else None
        if isinstance(arr, dict):
            if exp is None:
                raise ValueError(f"{tag}.{k}: unexpected parameter group")
            _shapes_checked(f"{tag}.{k}", arr, exp)
        elif exp is None or tuple(arr.shape) != tuple(np.shape(exp)):
            raise ValueError(
                f"{tag}.{k}: shape {tuple(arr.shape)} != expected "
                f"{None if exp is None else tuple(np.shape(exp))}")
    return new


def convert_transformer_state_dict(state_dict, params) -> dict:
    """A torch decoder-only transformer ``state_dict`` (the port's layout:
    ``embed.weight``, ``pos.weight``, ``blocks.{i}.{ln1,ln2}.{weight,bias}``,
    ``blocks.{i}.attn.{in_proj,out_proj}.{weight,bias}``,
    ``blocks.{i}.mlp.{fc1,fc2}.{weight,bias}``, ``ln_f.{weight,bias}``) ->
    the JAX ``TransformerLM``'s parameter tree of float32 numpy arrays, each
    checked against ``params`` (that tree's template, e.g. the first of
    :func:`~tpuddp_torch.models.convert.jax_from_state_dict`), as
    ``tpuddp/models/torch_import.py:429-500`` converts it: Linear weights
    transposed ``(out, in) -> (in, out)``; a missing tensor a ``KeyError``;
    a wrong geometry a ``ValueError`` naming it; a tensor the layout does
    not take (an untied ``head.weight``, a block past ``params``') the
    leftover ``ValueError``."""
    consumed = set()

    def get(key):
        consumed.add(key)
        t = state_dict[key]
        return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t, np.float32)

    def lin(key):
        return get(f"{key}.weight").T, get(f"{key}.bias")

    def ln(key):
        return {"scale": get(f"{key}.weight"), "bias": get(f"{key}.bias")}

    new = dict(params)
    new["embed"] = _shapes_checked("embed", {"weight": get("embed.weight")}, params["embed"])
    new["pos"] = _shapes_checked("pos", {"weight": get("pos.weight")}, params["pos"])
    blocks = []
    for i, expect in enumerate(params["blocks"]):
        t = f"blocks.{i}"
        (wqkv, bqkv), (wo, bo) = lin(f"{t}.attn.in_proj"), lin(f"{t}.attn.out_proj")
        (w1, b1), (w2, b2) = lin(f"{t}.mlp.fc1"), lin(f"{t}.mlp.fc2")
        block = {
            "ln1": ln(f"{t}.ln1"),
            "attn": {"wqkv": wqkv, "bqkv": bqkv, "wo": wo, "bo": bo},
            "ln2": ln(f"{t}.ln2"),
            "mlp": {"w1": w1, "b1": b1, "w2": w2, "b2": b2},
        }
        blocks.append(_shapes_checked(t, block, expect))
    new["blocks"] = tuple(blocks)
    new["ln_f"] = _shapes_checked("ln_f", ln("ln_f"), params["ln_f"])
    leftover = sorted(k for k in state_dict
                      if k not in consumed and not k.endswith("num_batches_tracked"))
    if leftover:
        raise ValueError(
            f"checkpoint has {len(leftover)} tensors this {len(params['blocks'])}-block "
            f"TransformerLM layout does not consume (e.g. {leftover[:3]}); wrong architecture?")
    return new
