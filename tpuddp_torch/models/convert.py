"""Weight bridge between the JAX package's parameter trees and the port's
``state_dict``, both ways (``state_dict_from_jax`` is the inverse of
``tpuddp/models/torch_import.py:56-108``, :func:`jax_from_state_dict` the
inverse of ``state_dict_from_jax``), and each parameter's place in the JAX
package's flattened parameter tree.

JAX params arrive as numpy arrays (one entry per layer of the JAX
``Sequential``; parameter-free layers hold ``()``):

- conv weights: HWIO -> OIHW;
- Linear weights: ``(in, out)`` -> ``(out, in)``;
- AlexNet's first classifier Linear additionally re-orders its 9216-wide
  input axis from JAX's NHWC flatten ``(h, w, c)`` to torch's ``(c, h, w)``;
- BatchNorm (``toy_cnn``, the ResNets): ``scale`` and ``bias`` -> ``weight``
  and ``bias``, and the JAX model state's ``mean`` and ``var`` -> the
  ``running_mean`` and ``running_var`` buffers.

A ResNet child of the JAX ``Sequential`` is a block whose parameters (and
state) are a nested dict, ``{"bn1": {"bias", "scale"}, "conv1": {"weight"},
..., "down_conv", "down_bn"}``, which the port keeps as torchvision's
``layer{s}.{b}.bn1``, ``.conv1``, ``.downsample.0``/``.1``. So a parameter's
place in the JAX tree is ``(child index, path)``, the path a tuple of dict
keys, ``(3, ("bn1", "scale"))``; places sort as ``jax.tree_util`` flattens
the tree (children in order, each dict's keys sorted, at every level).

``alexnet_s2d`` has AlexNet's parameters and keys, and each ``resnet*_s2d``
its base's, so every function here takes them as ``alexnet`` and
``resnet*``; a ``resnet*_small`` is a layout of its own (no max-pool
child). :func:`flat_to_jax` and :func:`flat_from_jax` move
one flat vector of all parameters (ZeRO-1's layout) between the port's order
(``model.parameters()``, each raveled as PyTorch stores it) and the JAX
package's (its tree's leaves in order, each raveled in its own layout).

Every tensor's shape is checked against the port's model, with the key named
on a mismatch. Both directions only move elements, so a round trip is
bitwise; :func:`torch_layout` and :func:`jax_from_state_dict` keep each
array's dtype, so Adam moments travel the same way (bf16 ones as their
uint16 bits).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from tpuddp_torch.models.resnet import DEPTHS as _RESNET_DEPTHS
from tpuddp_torch.models.resnet import Bottleneck

# JAX AlexNet Sequential index -> torchvision key (tpuddp/models/torch_import.py)
_ALEXNET_CONV = {0: "features.0", 3: "features.3", 6: "features.6",
                 8: "features.8", 10: "features.10"}
_ALEXNET_LINEAR = {16: "classifier.1", 19: "classifier.4", 21: "classifier.6"}
_POOL_GRID, _POOL_CH = 6, 256


Place = Tuple[int, Tuple[str, ...]]  # (JAX child index, path of dict keys)


def _base(name: str) -> str:
    """The name whose layout ``name`` shares: ``alexnet_s2d`` is AlexNet's,
    ``resnet18_s2d`` ResNet-18's."""
    return name[: -len("_s2d")] if name.endswith("_s2d") else name


def _resnet_spec(name: str):
    """``(blocks per stage, block class, small stem)`` of a ResNet layout
    name, None for another model."""
    small = name.endswith("_small")
    spec = _RESNET_DEPTHS.get(name[: -len("_small")] if small else name)
    return None if spec is None else (*spec, small)


# a block's port child -> its key in the JAX block's dict
_BLOCK_KEYS = {"downsample.0": "down_conv", "downsample.1": "down_bn"}


@lru_cache(maxsize=None)
def _resnet_modules(name: str) -> Tuple[Tuple[Tuple[str, str, Place], ...], int]:
    """Every module of the ResNet layout ``name`` that may hold parameters,
    in the port's order: ``(module prefix, kind, place)``, kind ``conv``,
    ``bn`` or ``linear``, place its dict's ``(child, path)`` in the JAX
    tree (``downsample`` listed for every block; a block without it has
    none); and the JAX ``Sequential``'s child count."""
    depths, block, small = _resnet_spec(name)
    convs = 3 if block is Bottleneck else 2
    child = 3 if small else 4  # conv, BatchNorm, ReLU[, MaxPool]
    out = [("conv1", "conv", (0, ())), ("bn1", "bn", (1, ()))]
    for stage, n_blocks in enumerate(depths, start=1):
        for b in range(n_blocks):
            prefix = f"layer{stage}.{b}"
            for i in range(1, convs + 1):
                out += [(f"{prefix}.conv{i}", "conv", (child, (f"conv{i}",))),
                        (f"{prefix}.bn{i}", "bn", (child, (f"bn{i}",)))]
            out += [(f"{prefix}.{key}", "conv" if key.endswith("0") else "bn", (child, (jkey,)))
                    for key, jkey in _BLOCK_KEYS.items()]
            child += 1
    out.append(("fc", "linear", (child + 1, ())))  # after the pool
    return tuple(out), child + 2


def _get(tree, path: Sequence[str]):
    """The node at ``path`` inside one child's dict, None where it is absent."""
    for key in path:
        if not tree or key not in tree:
            return None
        tree = tree[key]
    return tree


def _set(tree: dict, path: Sequence[str], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def tree_leaves(node, path: Tuple = ()) -> Iterator[Tuple[Tuple, np.ndarray]]:
    """``(path, leaf)`` of a JAX tree (tuples by index, dicts by sorted
    key, ``()`` and empty dicts holding none) in ``jax.tree_util``'s
    order; a path is a tuple of ints and strings."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from tree_leaves(node[k], path + (k,))
    elif isinstance(node, (tuple, list)):
        for i, child in enumerate(node):
            yield from tree_leaves(child, path + (i,))
    else:
        yield path, node


def keystr(path: Tuple) -> str:
    """``jax.tree_util.keystr`` of a :func:`tree_leaves` path of tuples
    and dicts: ``[3]['bn1']['bias']``."""
    return "".join(f"[{k}]" if isinstance(k, int) else f"['{k}']" for k in path)


def tree_map(fn, node, path: Tuple = ()):
    """``node`` with each leaf replaced by ``fn(path, leaf)``, the same
    structure."""
    if isinstance(node, dict):
        return {k: tree_map(fn, v, path + (k,)) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return tuple(tree_map(fn, c, path + (i,)) for i, c in enumerate(node))
    return fn(path, node)


def _linear_indices(params: Sequence) -> list:
    return [i for i, p in enumerate(params) if p and "weight" in p]


def _expected_model(name: str, params: Sequence):
    """The port's model with the widths ``params`` imply, on the meta device
    (shapes only, no memory)."""
    from tpuddp_torch.models import AlexNet, ResNet, ToyCNN, ToyMLP

    name = _base(name)
    lin = _linear_indices(params)
    num_classes = int(np.shape(params[lin[-1]]["weight"])[1])
    with torch.device("meta"):
        if name == "alexnet":
            return AlexNet(num_classes=num_classes)
        if _resnet_spec(name) is not None:
            depths, block, small = _resnet_spec(name)
            return ResNet(depths, block, num_classes, small_input=small)
        if name == "toy_mlp":
            hidden = [int(np.shape(params[i]["weight"])[1]) for i in lin[:-1]]
            in_features = int(np.shape(params[lin[0]]["weight"])[0])
            return ToyMLP(in_features, num_classes, hidden)
        if name == "toy_cnn":
            convs = [np.shape(p["weight"]) for p in params[:lin[-1]] if p and "weight" in p]
            widths = [int(s[3]) for s in convs]
            # the head sees (h // f) * (w // f) * widths[-1] features, f = 2^blocks;
            # any input with that many gives the same shapes
            cells = int(np.shape(params[lin[-1]]["weight"])[0]) // widths[-1]
            f = 2 ** len(widths)
            return ToyCNN(num_classes, widths, input_shape=(f, f * cells, int(convs[0][2])))
    raise ValueError(f"no weight bridge for model {name!r}; {_LAYOUTS}")


_LAYOUTS = ("one of alexnet, toy_mlp, toy_cnn, resnet{18,34,50,101,152} and their _small "
            "layouts")


def _check_children(name: str, params: Sequence, n: int) -> None:
    if len(params) != n:
        raise ValueError(f"{name}: the JAX tree has {len(params)} children, the layout {n}")


def torch_layout(
    name: str, params: Sequence, model_state: Optional[Sequence] = None
) -> Dict[str, np.ndarray]:
    """JAX ``params`` (and ``model_state``) as numpy arrays by the port's
    ``state_dict`` keys, in the port's layouts, each in its own dtype."""
    out: Dict[str, np.ndarray] = {}
    name = _base(name)
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
    elif _resnet_spec(name) is not None:
        modules, n_children = _resnet_modules(name)
        _check_children(name, params, n_children)
        for prefix, kind, (idx, path) in modules:
            p = _get(params[idx], path)
            if p is None:  # a block without a projection shortcut
                continue
            if kind == "bn":
                out[f"{prefix}.weight"], out[f"{prefix}.bias"] = p["scale"], p["bias"]
                if model_state is not None:
                    s = _get(model_state[idx], path)
                    out[f"{prefix}.running_mean"], out[f"{prefix}.running_var"] = s["mean"], s["var"]
            elif kind == "conv":  # HWIO -> OIHW
                out[f"{prefix}.weight"] = np.transpose(p["weight"], (3, 2, 0, 1))
            else:
                out[f"{prefix}.weight"] = np.asarray(p["weight"]).T
                out[f"{prefix}.bias"] = p["bias"]
    elif name == "toy_cnn":
        for idx, p in enumerate(params):
            if not p:
                continue
            if "scale" in p:  # BatchNorm
                out[f"{idx}.weight"], out[f"{idx}.bias"] = p["scale"], p["bias"]
                if model_state is not None:
                    out[f"{idx}.running_mean"] = model_state[idx]["mean"]
                    out[f"{idx}.running_var"] = model_state[idx]["var"]
            elif np.ndim(p["weight"]) == 4:  # conv, HWIO -> OIHW
                out[f"{idx}.weight"] = np.transpose(p["weight"], (3, 2, 0, 1))
            else:  # Linear
                out[f"{idx}.weight"] = np.asarray(p["weight"]).T
                out[f"{idx}.bias"] = p["bias"]
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def state_dict_from_jax(
    name: str, params: Sequence, model_state: Optional[Sequence] = None
) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (float32 CPU tensors) for JAX ``params``
    and, for a model with buffers, its ``model_state``. Without
    ``model_state`` only the parameters are converted (as for a gradient
    tree)."""
    out = torch_layout(name, params, model_state)
    model = _expected_model(name, params)
    expected = (
        model.state_dict() if model_state is not None
        else dict(model.named_parameters())
    )
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


# JAX AlexNet's Sequential: 22 layers, parameters at the conv and Linear indices
_ALEXNET_LAYERS = 22


def _numpy(value) -> np.ndarray:
    if torch.is_tensor(value):
        if value.dtype == torch.bfloat16:
            raise TypeError("pass a bf16 tensor as its uint16 bits (numpy has no bfloat16)")
        return value.detach().cpu().numpy()
    return np.asarray(value)


def jax_from_state_dict(name: str, state_dict) -> Tuple[tuple, tuple]:
    """The inverse of :func:`state_dict_from_jax`: the JAX package's
    ``(params, model_state)`` tuples (one entry per layer, ``()`` where a
    layer has none) for a port ``state_dict`` of tensors or arrays, each in
    its own dtype. A mapping of parameters alone (a moment tree) gives its
    ``params`` and a ``model_state`` of ``()``."""
    sd = {k: _numpy(v) for k, v in state_dict.items()}
    name = _base(name)
    if _resnet_spec(name) is not None:
        return _resnet_from_state_dict(name, sd)
    if name == "alexnet":
        layers = {idx: key for idx, key in {**_ALEXNET_CONV, **_ALEXNET_LINEAR}.items()}
        n_layers = _ALEXNET_LAYERS
    elif name in ("toy_mlp", "toy_cnn"):
        idxs = sorted({int(k.split(".")[0]) for k in sd})
        layers = {i: str(i) for i in idxs}
        n_layers = idxs[-1] + 1
    else:
        raise ValueError(f"no weight bridge for model {name!r}; {_LAYOUTS}")
    params, mstate = [()] * n_layers, [()] * n_layers
    for idx, key in layers.items():
        w, b = sd.get(f"{key}.weight"), sd.get(f"{key}.bias")
        if w is None:
            raise KeyError(f"{name}: state_dict has no {key}.weight")
        if w.ndim == 1:  # BatchNorm
            params[idx] = {"bias": b, "scale": w}
            if f"{key}.running_mean" in sd:
                mstate[idx] = {"mean": sd[f"{key}.running_mean"], "var": sd[f"{key}.running_var"]}
            continue
        if w.ndim == 4:  # conv, OIHW -> HWIO
            w = np.transpose(w, (2, 3, 1, 0))
        elif name == "alexnet" and key == "classifier.1":
            # (out, c, h, w) -> (h, w, c, out)
            out_f = w.shape[0]
            w = w.reshape(out_f, _POOL_CH, _POOL_GRID, _POOL_GRID).transpose(2, 3, 1, 0)
            w = w.reshape(-1, out_f)
        else:  # Linear, (out, in) -> (in, out)
            w = w.T
        params[idx] = {"weight": w} if b is None else {"weight": w, "bias": b}
    contiguous = lambda layer: (
        {k: np.ascontiguousarray(v) for k, v in layer.items()} if layer else ()
    )
    return tuple(map(contiguous, params)), tuple(map(contiguous, mstate))


def _resnet_from_state_dict(name: str, sd: Dict[str, np.ndarray]) -> Tuple[tuple, tuple]:
    """:func:`jax_from_state_dict` of a ResNet: each block's child a nested
    dict (``{"bn1": {"bias", "scale"}, "conv1": {"weight"}, ...}``)."""
    modules, n_children = _resnet_modules(name)
    params = [{} for _ in range(n_children)]
    mstate = [{} for _ in range(n_children)]
    known = set()
    for prefix, kind, (idx, path) in modules:
        w = sd.get(f"{prefix}.weight")
        if w is None:
            if not prefix.endswith(tuple(_BLOCK_KEYS)):
                raise KeyError(f"{name}: state_dict has no {prefix}.weight")
            continue
        keys = {f"{prefix}.{k}" for k in ("weight", "bias", "running_mean", "running_var")}
        known |= keys
        if kind == "bn":
            node = {"bias": sd[f"{prefix}.bias"], "scale": w}
            if f"{prefix}.running_mean" in sd:
                stats = {"mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]}
                if path:
                    _set(mstate[idx], path, stats)
                else:
                    mstate[idx] = stats
        elif kind == "conv":  # OIHW -> HWIO
            node = {"weight": np.transpose(w, (2, 3, 1, 0))}
        else:  # (out, in) -> (in, out)
            node = {"weight": w.T, "bias": sd[f"{prefix}.bias"]}
        if path:
            _set(params[idx], path, node)
        else:
            params[idx] = node
    unknown = sorted(set(sd) - known)
    if unknown:
        raise KeyError(f"{name}: state_dict keys {unknown[:3]} have no place in the layout")
    contiguous = lambda child: tree_map(lambda _, a: np.ascontiguousarray(a), child) if child else ()
    return tuple(map(contiguous, params)), tuple(map(contiguous, mstate))


def model_name(model: torch.nn.Module) -> str:
    """The registry name of the layout of one of the port's models
    (``alexnet`` for ``alexnet_s2d`` too; ``resnet{depth}`` or
    ``resnet{depth}_small`` for a ResNet, its ``_s2d`` stem included)."""
    from tpuddp_torch.models import AlexNet, ResNet, ToyCNN, ToyMLP

    if isinstance(model, ResNet):
        block = type(model.layer1[0])
        for base, spec in _RESNET_DEPTHS.items():
            if spec == (model.depths, block):
                return base + ("_small" if model.maxpool is None else "")
        raise ValueError(f"no JAX layout for a ResNet of {model.depths} {block.__name__}s")
    for cls, name in ((AlexNet, "alexnet"), (ToyCNN, "toy_cnn"), (ToyMLP, "toy_mlp")):
        if isinstance(model, cls):
            return name
    raise ValueError(
        f"no JAX layout for a {type(model).__name__}; one of AlexNet, ResNet, ToyCNN, ToyMLP")


def jax_leaf_index(name: str, model: torch.nn.Module) -> Dict[str, int]:
    """Each parameter of the port's ``model`` (by ``named_parameters`` name)
    -> its index among the leaves of the JAX package's flattened parameter
    tree for the same model: the layers in order, each layer's dict keys
    sorted at every level (``bias`` before ``scale`` and ``weight``; a
    ResNet block's ``bn1`` before ``conv1`` and ``down_bn``),
    parameter-free layers holding none. bf16 Adam moments salt their
    rounding with it (``tpuddp/optim.py:127``)."""
    places = jax_places(name, model)
    return {pname: k for k, pname in enumerate(sorted(places, key=places.get))}


def jax_places(name: str, model: torch.nn.Module) -> Dict[str, Place]:
    """Each parameter of the port's ``model`` (by ``named_parameters``
    name) -> its ``(layer index, path)`` in the JAX package's parameter
    tree, the path the dict keys down to the leaf: ``(0, ("weight",))``,
    a ResNet block's ``(3, ("bn1", "scale"))`` (a BatchNorm's ``weight`` is
    its ``scale``)."""
    from tpuddp_torch.nn.norm import BatchNorm

    name = _base(name)
    if name == "alexnet":
        place_of = {key: (idx, ()) for idx, key in {**_ALEXNET_CONV, **_ALEXNET_LINEAR}.items()}
    elif name in ("toy_mlp", "toy_cnn"):
        place_of = None  # Sequentials with the JAX layer indices
    elif _resnet_spec(name) is not None:
        place_of = {prefix: place for prefix, _, place in _resnet_modules(name)[0]}
    else:
        raise ValueError(f"no JAX leaf order for model {name!r}; {_LAYOUTS}")
    places = {}
    for pname, _ in model.named_parameters():
        prefix, key = pname.rsplit(".", 1)
        if key == "weight" and isinstance(model.get_submodule(prefix), BatchNorm):
            key = "scale"
        idx, path = (int(prefix), ()) if place_of is None else place_of[prefix]
        places[pname] = (idx, path + (key,))
    return places


def _n_children(name: str, model: torch.nn.Module) -> int:
    """The JAX ``Sequential``'s child count for ``model``."""
    name = _base(name)
    if name == "alexnet":
        return _ALEXNET_LAYERS
    if _resnet_spec(name) is not None:
        return _resnet_modules(name)[1]
    return len(model)


def _jax_shape(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """A parameter's JAX shape for its port shape: OIHW -> HWIO, ``(out,
    in)`` -> ``(in, out)``, vectors as they are."""
    if len(shape) == 4:
        return (shape[2], shape[3], shape[1], shape[0])
    if len(shape) == 2:
        return (shape[1], shape[0])
    return tuple(shape)


def flat_to_jax(name: str, model: torch.nn.Module, vec: np.ndarray) -> np.ndarray:
    """``vec``, the model's parameters (or a moment of each) raveled in
    ``model.parameters()`` order, in the JAX package's flat order: its
    tree's leaves in order, each in its JAX layout. Any dtype; only elements
    move, so the result is bitwise the same values. Padding past the raw
    element count is the caller's."""
    arrays, offset = {}, 0
    for pname, p in model.named_parameters():
        arrays[pname] = vec[offset:offset + p.numel()].reshape(tuple(p.shape))
        offset += p.numel()
    if offset != len(vec):
        raise ValueError(f"flat_to_jax: {len(vec)} elements for {offset} parameters")
    params, _ = jax_from_state_dict(name, arrays)
    return np.concatenate([np.ravel(leaf) for _, leaf in tree_leaves(params)])


def flat_from_jax(name: str, model: torch.nn.Module, vec: np.ndarray) -> np.ndarray:
    """The inverse of :func:`flat_to_jax`: a raw JAX-ordered flat vector in
    ``model.parameters()`` order."""
    places = jax_places(name, model)
    shapes = {pname: _jax_shape(tuple(p.shape)) for pname, p in model.named_parameters()}
    tree, offset = [{} for _ in range(_n_children(name, model))], 0
    for pname in sorted(places, key=places.get):
        layer, path = places[pname]
        n = int(np.prod(shapes[pname]))
        _set(tree[layer], path, vec[offset:offset + n].reshape(shapes[pname]))
        offset += n
    if offset != len(vec):
        raise ValueError(f"flat_from_jax: {len(vec)} elements for {offset} parameters")
    arrays = torch_layout(name, [layer or () for layer in tree])
    return np.concatenate([np.ravel(arrays[pname]) for pname, _ in model.named_parameters()])


def jax_sizes(name: str, model: torch.nn.Module) -> Tuple[int, ...]:
    """The element counts of ``model``'s parameters in the JAX package's
    tree order (the leaves its ``make_flat_param_spec`` concatenates), which
    the comm hooks' bucket plan packs."""
    places = jax_places(name, model)
    numel = {pname: p.numel() for pname, p in model.named_parameters()}
    return tuple(numel[pname] for pname in sorted(places, key=places.get))


def jax_layer_sizes(name: str, model: torch.nn.Module) -> Tuple[int, ...]:
    """The element count of each child of the JAX package's ``Sequential``
    for ``model`` (0 for a parameter-free child; AlexNet's 22 children),
    which the segmented-overlap step's :func:`~tpuddp_torch.parallel.comm.
    make_segments` takes. The port's AlexNet and ResNets are torchvision's
    nested layouts, so the children are the JAX package's (a ResNet block
    one child: 13 for ``resnet18_small``, 22 for ``resnet50``), never
    ``model.children()``."""
    places = jax_places(name, model)
    sizes = [0] * _n_children(name, model)
    for pname, p in model.named_parameters():
        sizes[places[pname][0]] += p.numel()
    return tuple(sizes)


def jax_param_span(name: str, model: torch.nn.Module, layers) -> Tuple[int, int]:
    """The port parameters ``[first, end)`` (by ``model.parameters()``
    index) of the JAX children ``[layers[0], layers[1])``: a contiguous run
    in every model here, else a ``ValueError``."""
    places = jax_places(name, model)
    inside = [i for i, (n, _) in enumerate(model.named_parameters())
              if layers[0] <= places[n][0] < layers[1]]
    first, end = (inside[0], inside[-1] + 1) if inside else (0, 0)
    if inside != list(range(first, end)):
        raise ValueError(
            f"the parameters of JAX children {tuple(layers)} are not contiguous in the port's "
            "parameter order")
    return first, end


class JaxFlatOrder:
    """The permutation between the port's flat parameter order and the JAX
    package's (:func:`flat_to_jax`), as two int64 index tensors on
    ``device``, built once per model: ``to_jax(vec)`` is ``flat_to_jax`` of
    a flat tensor (one gather), ``from_jax(vec)`` its inverse. The native
    comm hooks exchange the gradient in the JAX order, so that its buckets,
    their int8 scales and top-k sets, and the error-feedback residual are
    the JAX package's.

    With ``layers = (a, b)`` it is the permutation of one backward segment:
    the parameters of the JAX children ``[a, b)`` (:func:`jax_param_span`),
    concatenated in the port's order, against their span of the JAX order.
    ``perm``, when given, is ``flat_to_jax`` of the port's element indices
    (one computation for a model's segments)."""

    def __init__(self, name: str, model: torch.nn.Module, device=None, layers=None, perm=None):
        named = list(model.named_parameters())
        sizes = [p.numel() for _, p in named]
        if perm is None:
            perm = flat_to_jax(name, model, np.arange(sum(sizes), dtype=np.int64))
        first, end, jax_lo = 0, len(named), 0
        if layers is not None:
            first, end = jax_param_span(name, model, layers)
            places = jax_places(name, model)
            jax_lo = sum(s for (n, _), s in zip(named, sizes) if places[n][0] < layers[0])
        port_lo, raw = sum(sizes[:first]), sum(sizes[first:end])
        perm = perm[jax_lo:jax_lo + raw] - port_lo
        inverse = np.empty_like(perm)
        inverse[perm] = np.arange(raw, dtype=np.int64)
        device = next(model.parameters()).device if device is None else device
        self.raw = raw
        self._to_jax = torch.from_numpy(perm).to(device)
        self._from_jax = torch.from_numpy(inverse).to(device)

    def to_jax(self, vec: torch.Tensor) -> torch.Tensor:
        """The ``raw`` elements of ``vec`` (port order) in the JAX order."""
        return vec.index_select(0, self._to_jax)

    def from_jax(self, vec: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The first ``raw`` elements of ``vec`` (JAX order) in the port's
        (into ``out`` when given)."""
        return torch.index_select(vec[:self.raw], 0, self._from_jax, out=out)
