"""Model zoo of the port: ``alexnet`` (the main path), ``alexnet_s2d`` (its
space-to-depth stem, the same parameters and checkpoints), ``toy_mlp``,
``toy_cnn``, the ResNets (``resnet{18,34,50,101,152}``, each with its
``_small`` CIFAR stem and its ``_s2d`` stem) and the VGGs
(``vgg{11,13,16,19}``). The JAX package's transformers wait for a later
slice."""

from typing import Sequence

from tpuddp_torch.models.alexnet import AlexNet  # noqa: F401
from tpuddp_torch.models.resnet import DEPTHS as _RESNETS
from tpuddp_torch.models.resnet import BasicBlock, Bottleneck, ResNet, resnet  # noqa: F401
from tpuddp_torch.models.toy import ToyCNN, ToyMLP  # noqa: F401
from tpuddp_torch.models.vgg import VGG, VGG_PLANS

# the JAX package's other models (tpuddp/models/__init__.py)
_NOT_PORTED = ("transformer_tiny", "transformer_small")
VGG_NAMES = tuple(VGG_PLANS)  # vgg11, vgg13, vgg16, vgg19
RESNET_NAMES = tuple(f"{base}{stem}" for base in _RESNETS for stem in ("", "_small", "_s2d"))


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
    if name in RESNET_NAMES:
        return resnet(name, num_classes=num_classes, **kwargs)
    if name in VGG_PLANS:
        return VGG(name, num_classes=num_classes, **kwargs)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not implemented in tpuddp_torch yet "
            "(ROADMAP.md Queue 1 item 8: other models)"
        )
    raise ValueError(
        f"unknown model {name!r}; one of alexnet, alexnet_s2d, toy_mlp, toy_cnn, "
        f"{', '.join(RESNET_NAMES)}, {', '.join(VGG_NAMES)}"
    )


__all__ = ["AlexNet", "BasicBlock", "Bottleneck", "ResNet", "ToyCNN", "ToyMLP", "VGG", "load_model",
           "RESNET_NAMES", "VGG_NAMES"]
