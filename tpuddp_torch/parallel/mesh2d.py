"""The 2-D ``("data", "model")`` world — the counterpart of
``tpuddp/parallel/mesh2d.py``, the axis layer tensor parallelism runs over.

The JAX package reshapes one process's devices into a ``data x model``
grid. A port process holds one rank, so the same grid is two families of
process groups over the ranks of the default group, with ``model`` the
MINOR axis, as the JAX device order puts it (one tensor-parallel group is
consecutive ranks):

- rank ``r = data_index * M + model_index``;
- the **model** groups ``{d*M, ..., d*M + M - 1}`` for each data index
  ``d``: the activation exchanges of the tensor-parallel forward and
  backward (``parallel/tensor.py``);
- the **data** groups ``{m, M + m, 2M + m, ...}`` for each model index
  ``m``: the gradient exchange, whose group-rank order is the data index.

Every rank creates every group, in one order (``dist.new_group`` is a
collective of the default group): the model groups by data index, then the
data groups by model index. Plain ``new_group`` over the world's backend,
so a world of two ranks on one GPU runs over Gloo as any other.

``mesh2d(data, 1)`` is today's DDP world: :func:`squeeze_model` collapses
it to ``None``, the flat data world, and the DDP wrap takes its unchanged
code path. :data:`AXIS_ROLES` is the closed registry of axis names.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch.distributed as dist

from tpuddp_torch.parallel.mesh import HOST_AXIS, LOCAL_AXIS

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the closed registry of mesh axis names and their roles
# (tpuddp/parallel/mesh2d.py:56-61)
AXIS_ROLES: Mapping[str, str] = {
    DATA_AXIS: "batch sharding + gradient reduction (replicas agree bitwise)",
    MODEL_AXIS: "tensor-parallel parameter sharding (shards legitimately differ)",
    HOST_AXIS: "inter-host hop of the factored data axis (comm_topology=hierarchical)",
    LOCAL_AXIS: "intra-host hop of the factored data axis (comm_topology=hierarchical)",
}


def validate_axis(name: str) -> str:
    if name not in AXIS_ROLES:
        raise ValueError(
            f"unknown mesh axis {name!r}; the registry knows "
            f"{sorted(AXIS_ROLES)} (tpuddp/parallel/mesh2d.AXIS_ROLES)"
        )
    return name


class Mesh2D:
    """This rank's place in a ``data x model`` world: ``data_index``,
    ``model_index`` and the two process groups it belongs to
    (``model_group``, ``data_group``; None in a one-process world)."""

    def __init__(self, data: int, model: int, rank: int, model_group=None, data_group=None):
        self.data, self.model = int(data), int(model)
        self.rank = int(rank)
        self.data_index, self.model_index = divmod(self.rank, self.model)
        self.model_group, self.data_group = model_group, data_group

    @property
    def shape(self):
        return (self.data, self.model)

    def __repr__(self) -> str:
        return (f"Mesh2D(data={self.data}, model={self.model}, rank={self.rank} = "
                f"({self.data_index}, {self.model_index}))")


def mesh2d(data: int, model: int, rank: Optional[int] = None) -> Mesh2D:
    """The ``(data, model)`` world over the default process group, its
    groups created on every rank alike (call it on all ranks, at wrap or
    set-up time). ``data * model`` must be the world; ``model=1`` still
    builds the grid (its groups too): :func:`squeeze_model` collapses it."""
    data, model = int(data), int(model)
    if data < 1 or model < 1:
        raise ValueError(f"mesh2d axis sizes must be >= 1, got data={data}, model={model}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != data * model:
        raise ValueError(
            f"mesh2d(data={data}, model={model}) needs exactly "
            f"{data * model} devices, got {world}"
        )
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    if world == 1:
        return Mesh2D(data, model, rank)
    model_group = data_group = None
    for d in range(data):
        group = dist.new_group(list(range(d * model, (d + 1) * model)))
        if rank // model == d:
            model_group = group
    for m in range(model):
        group = dist.new_group(list(range(m, world, model)))
        if rank % model == m:
            data_group = group
    return Mesh2D(data, model, rank, model_group, data_group)


def axis_sizes(mesh: Optional[Mesh2D]) -> Mapping[str, int]:
    """``{axis name: size}``; a flat world (None) is ``{"data": world}``."""
    if mesh is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        return {DATA_AXIS: world}
    return {DATA_AXIS: mesh.data, MODEL_AXIS: mesh.model}


def model_size(mesh: Optional[Mesh2D]) -> int:
    """The tensor-parallel width: the ``model`` axis, 1 for the flat world."""
    return 1 if mesh is None else mesh.model


def data_size(mesh: Optional[Mesh2D]) -> int:
    """The data-parallel width: the replicas of the gradient exchange."""
    return int(axis_sizes(mesh)[DATA_AXIS])


def is_tensor_parallel(mesh: Optional[Mesh2D]) -> bool:
    return model_size(mesh) > 1


def squeeze_model(mesh: Optional[Mesh2D]) -> Optional[Mesh2D]:
    """The flat data world (None) for a ``model=1`` grid, so the DDP wrap
    takes its unchanged code path; a wider model axis cannot be squeezed."""
    if mesh is None:
        return None
    if mesh.model != 1:
        raise ValueError(
            f"cannot squeeze a model={mesh.model} mesh to 1-D; only "
            "the model=1 special case collapses to the flat DDP mesh"
        )
    return None


def describe(mesh: Optional[Mesh2D], world_size: Optional[int] = None) -> Optional[dict]:
    """The run_meta ``mesh`` block's axis sizes, ``{"data": D, "model":
    M}``; a flat world of ``world_size`` replicas is ``{"data":
    world_size, "model": 1}``, None without either."""
    if mesh is None:
        return None if world_size is None else {DATA_AXIS: int(world_size), MODEL_AXIS: 1}
    return {DATA_AXIS: mesh.data, MODEL_AXIS: mesh.model}
