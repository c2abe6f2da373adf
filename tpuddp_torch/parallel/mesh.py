"""The factored data world of ``comm_topology: hierarchical`` — the
counterpart of ``tpuddp/parallel/mesh.py:23-110``.

The JAX package reshapes its devices into a ``("host", "local")`` mesh, the
host axis outer, so replica ``r = h * L + l`` sits on host ``h`` at local
index ``l``. Here the same split is two families of process groups over the
ranks of the default group:

- the **local** groups, ``{h*L, ..., h*L + L - 1}`` for each host ``h``:
  the intra-host hop (NVLink on one machine);
- the **host** groups, ``{l, L + l, 2L + l, ...}`` for each local index
  ``l``: the inter-host hop, whose group-rank order is the JAX outer axis's.

The host count is the multi-host rendezvous's (``local.rendezvous``,
:func:`tpuddp_torch.parallel.backend.num_hosts`) when one is up, else a
simulated 2, as the JAX package splits one process's devices.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from tpuddp_torch.parallel import backend

HOST_AXIS = "host"
LOCAL_AXIS = "local"


def factor(world: int, hosts: Optional[int] = None):
    """``(hosts, local)`` of a ``world``-replica hierarchical split; a world
    that ``hosts`` does not tile is the JAX package's ``ValueError``."""
    world = int(world)
    if hosts is None:
        hosts = backend.num_hosts() or 2
    hosts = int(hosts)
    if hosts < 2 or world % hosts:
        raise ValueError(
            f"comm_topology='hierarchical' needs a factorable world: {hosts} host group(s) do "
            f"not tile {world} device(s); pick a world size divisible by the host count (or "
            ">= 2 devices on the simulated single-host split)"
        )
    return hosts, world // hosts


def hierarchical_groups(world: int, hosts: Optional[int] = None):
    """``(local_group, host_group, hosts, local)`` for this rank. Every rank
    creates every group, in one order (``dist.new_group`` is a collective
    of the default group), so call it on all ranks alike, at wrap time."""
    hosts, local = factor(world, hosts)
    if not dist.is_initialized() or dist.get_world_size() != world:
        raise ValueError(
            f"comm_topology='hierarchical' over {world} replicas needs a process group of that "
            "size (one process per replica)"
        )
    rank = dist.get_rank()
    local_group = host_group = None
    for h in range(hosts):
        group = dist.new_group(list(range(h * local, (h + 1) * local)))
        if rank // local == h:
            local_group = group
    for l in range(local):
        group = dist.new_group(list(range(l, world, local)))
        if rank % local == l:
            host_group = group
    return local_group, host_group, hosts, local
