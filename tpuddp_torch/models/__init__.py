"""Model zoo of the port: ``alexnet`` (the main path), ``alexnet_s2d`` (its
space-to-depth stem, the same parameters and checkpoints), ``toy_mlp`` and
``toy_cnn``. The JAX package's other models wait for a later slice."""

from typing import Sequence

from tpuddp_torch.models.alexnet import AlexNet  # noqa: F401
from tpuddp_torch.models.toy import ToyCNN, ToyMLP  # noqa: F401

# the JAX package's other models (tpuddp/models/__init__.py)
_NOT_PORTED = (
    "vgg11", "vgg13", "vgg16", "vgg19", "resnet18", "resnet34",
    "resnet50", "resnet101", "resnet152", "transformer_tiny", "transformer_small",
)


def load_model(
    name: str = "alexnet",
    num_classes: int = 10,
    input_shape: Sequence[int] = (224, 224, 3),
    **kwargs,
):
    """Build ``name`` for NHWC inputs of ``input_shape`` (one sample)."""
    if name in ("alexnet", "alexnet_s2d"):
        return AlexNet(num_classes=num_classes, space_to_depth=name == "alexnet_s2d", **kwargs)
    if name == "toy_mlp":
        h, w, c = input_shape
        return ToyMLP(in_features=h * w * c, num_classes=num_classes, **kwargs)
    if name == "toy_cnn":
        return ToyCNN(num_classes=num_classes, input_shape=input_shape, **kwargs)
    base = name.split("_s2d")[0].split("_small")[0]
    if base in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not implemented in tpuddp_torch yet "
            "(ROADMAP.md Queue 1 item 8: other models)"
        )
    raise ValueError(f"unknown model {name!r}; one of alexnet, alexnet_s2d, toy_mlp, toy_cnn")


__all__ = ["AlexNet", "ToyCNN", "ToyMLP", "load_model"]
