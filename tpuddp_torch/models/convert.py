"""Weight bridge from the JAX package's parameter trees to the port's
``state_dict`` — the inverse of ``tpuddp/models/torch_import.py:56-108``.

JAX params arrive as numpy arrays (one entry per layer of the JAX
``Sequential``; parameter-free layers hold ``()``):

- conv weights: HWIO -> OIHW;
- Linear weights: ``(in, out)`` -> ``(out, in)``;
- AlexNet's first classifier Linear additionally re-orders its 9216-wide
  input axis from JAX's NHWC flatten ``(h, w, c)`` to torch's ``(c, h, w)``.

Every tensor's shape is checked against the port's model, with the key named
on a mismatch.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

# JAX AlexNet Sequential index -> torchvision key (tpuddp/models/torch_import.py)
_ALEXNET_CONV = {0: "features.0", 3: "features.3", 6: "features.6",
                 8: "features.8", 10: "features.10"}
_ALEXNET_LINEAR = {16: "classifier.1", 19: "classifier.4", 21: "classifier.6"}
_POOL_GRID, _POOL_CH = 6, 256


def _linear_indices(params: Sequence) -> list:
    return [i for i, p in enumerate(params) if p and "weight" in p]


def _expected_model(name: str, params: Sequence):
    """The port's model with the widths ``params`` imply, on the meta device
    (shapes only, no memory)."""
    from tpuddp_torch.models import AlexNet, ToyMLP

    lin = _linear_indices(params)
    num_classes = int(np.shape(params[lin[-1]]["weight"])[1])
    with torch.device("meta"):
        if name == "alexnet":
            return AlexNet(num_classes=num_classes)
        if name == "toy_mlp":
            hidden = [int(np.shape(params[i]["weight"])[1]) for i in lin[:-1]]
            in_features = int(np.shape(params[lin[0]]["weight"])[0])
            return ToyMLP(in_features, num_classes, hidden)
    raise ValueError(f"no weight bridge for model {name!r}; one of alexnet, toy_mlp")


def state_dict_from_jax(name: str, params: Sequence) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (float32 CPU tensors) for JAX ``params``."""
    out: Dict[str, np.ndarray] = {}
    if name == "alexnet":
        for idx, key in _ALEXNET_CONV.items():
            out[f"{key}.weight"] = np.transpose(params[idx]["weight"], (3, 2, 0, 1))
            out[f"{key}.bias"] = params[idx]["bias"]
        for idx, key in _ALEXNET_LINEAR.items():
            w = np.asarray(params[idx]["weight"])  # (in, out)
            if key == "classifier.1":
                out_f = w.shape[1]
                if w.shape[0] != _POOL_GRID * _POOL_GRID * _POOL_CH:
                    raise ValueError(
                        f"{key}.weight: input width {w.shape[0]} != "
                        f"{_POOL_GRID * _POOL_GRID * _POOL_CH}"
                    )
                # (h, w, c, out) -> (out, c, h, w)
                w = (
                    w.reshape(_POOL_GRID, _POOL_GRID, _POOL_CH, out_f)
                    .transpose(3, 2, 0, 1)
                    .reshape(out_f, -1)
                )
            else:
                w = w.T
            out[f"{key}.weight"] = w
            out[f"{key}.bias"] = params[idx]["bias"]
    elif name == "toy_mlp":
        for idx in _linear_indices(params):
            out[f"{idx}.weight"] = np.asarray(params[idx]["weight"]).T
            out[f"{idx}.bias"] = params[idx]["bias"]

    expected = _expected_model(name, params).state_dict()
    if set(out) != set(expected):
        raise ValueError(
            f"{name}: converted keys {sorted(out)} != model keys {sorted(expected)}"
        )
    state = {}
    for key, value in out.items():
        arr = np.array(value, dtype=np.float32, order="C")  # a writable copy
        if arr.shape != tuple(expected[key].shape):
            raise ValueError(
                f"{key}: shape {arr.shape} != expected {tuple(expected[key].shape)}"
            )
        state[key] = torch.from_numpy(arr)
    return state
