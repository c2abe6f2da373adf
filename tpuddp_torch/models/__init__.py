"""Model zoo of the port: ``alexnet`` (the main path), ``alexnet_s2d`` (its
space-to-depth stem, the same parameters and checkpoints), ``toy_mlp``,
``toy_cnn``, the ResNets (``resnet{18,34,50,101,152}``, each with its
``_small`` CIFAR stem and its ``_s2d`` stem), the VGGs
(``vgg{11,13,16,19}``) and the decoder-only transformers
(``transformer_tiny``: d 64, 4 heads, 2 layers, 128 positions;
``transformer_small``: d 128, 8 heads, 4 layers, 256 positions), which take
``(B, T)`` int tokens; their ``num_classes`` is the vocabulary, and
``max_seq_len=`` passes through."""

from typing import Sequence

from tpuddp_torch.models.alexnet import AlexNet  # noqa: F401
from tpuddp_torch.models.resnet import DEPTHS as _RESNETS
from tpuddp_torch.models.resnet import BasicBlock, Bottleneck, ResNet, resnet  # noqa: F401
from tpuddp_torch.models.toy import ToyCNN, ToyMLP  # noqa: F401
from tpuddp_torch.models.transformer import TransformerLM  # noqa: F401
from tpuddp_torch.models.vgg import VGG, VGG_PLANS

# the JAX registry's widths (tpuddp/models/__init__.py:36-44)
TRANSFORMERS = {
    "transformer_tiny": dict(d_model=64, n_heads=4, n_layers=2, max_seq_len=128),
    "transformer_small": dict(d_model=128, n_heads=8, n_layers=4, max_seq_len=256),
}
VGG_NAMES = tuple(VGG_PLANS)  # vgg11, vgg13, vgg16, vgg19
RESNET_NAMES = tuple(f"{base}{stem}" for base in _RESNETS for stem in ("", "_small", "_s2d"))


def load_model(
    name: str = "alexnet",
    num_classes: int = 10,
    input_shape: Sequence[int] = (224, 224, 3),
    **kwargs,
):
    """Build ``name`` for NHWC inputs of ``input_shape`` (one sample); a
    transformer takes token sequences and ignores ``input_shape``."""
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
    if name in TRANSFORMERS:
        return TransformerLM(num_classes=num_classes, **{**TRANSFORMERS[name], **kwargs})
    raise ValueError(
        f"unknown model {name!r}; one of alexnet, alexnet_s2d, toy_mlp, toy_cnn, "
        f"{', '.join(RESNET_NAMES)}, {', '.join(VGG_NAMES)}, {', '.join(TRANSFORMERS)}"
    )


__all__ = ["AlexNet", "BasicBlock", "Bottleneck", "ResNet", "ToyCNN", "ToyMLP", "TransformerLM",
           "VGG", "load_model", "RESNET_NAMES", "TRANSFORMERS", "VGG_NAMES"]
