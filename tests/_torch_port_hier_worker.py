"""Hierarchical-topology runs of the port on Gloo processes, for
tests/test_torch_port_hier_gloo.py and tests/test_torch_port_hier_gloo4.py.

    python tests/_torch_port_hier_worker.py WORKDIR WORLD

``WORKDIR/jobs.json`` holds a list of jobs, each run in order by every rank
of one launch (the port's ``run_ddp_training``, world WORLD, CPU, Gloo):

- ``{"kind": "exchange", "name", "hook", "sizes", "cap", "density"}``:
  ``GradComm.reduce_hierarchical`` over the ranks' hierarchical groups
  (:func:`tpuddp_torch.parallel.mesh.hierarchical_groups`) on this rank's
  row of ``g`` and ``r`` in ``WORKDIR/{name}_inputs.npz``, twice: the
  residual updated in place (``reduce``, ``residual``), and the new one
  written into a staging vector that held 7.0 everywhere (``staged``; the
  residual then stays as it was: ``kept``). Saved to ``{name}_{rank}.npz``
  with ``hosts`` and ``local``;
- ``{"kind": "run", ...}`` and ``{"kind": "restore", ...}``: as in
  ``tests/_torch_port_zero1_worker.py``;
- ``{"kind": "wrap", "name", "training"}``: the native entry point's
  ``build_training`` of ``training``; rank 0 saves ``{name}.json``: the
  exception's type and text, or the wrap's ``comm_overlap_meta``, its
  ``hierarchy`` and its byte split; and ``capture``, the ``ValueError``
  that a CUDA-graph group would raise on this Gloo world.

Imports only torch, numpy and ``tpuddp_torch``.
"""

from __future__ import annotations

import json
import os
import sys
from functools import partial

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from _torch_port_zero1_worker import build, save  # noqa: E402

from tpuddp_torch import train_native  # noqa: E402
from tpuddp_torch.parallel import comm, mesh  # noqa: E402
from tpuddp_torch.parallel.spawn import run_ddp_training  # noqa: E402
from tpuddp_torch.training import checkpoint as ckpt  # noqa: E402
from tpuddp_torch.training import graphs  # noqa: E402


def exchange(workdir, job, rank, world_size):
    with np.load(os.path.join(workdir, f"{job['name']}_inputs.npz")) as data:
        g, r = data["g"][rank], data["r"][rank]
    local_group, host_group, hosts, local = mesh.hierarchical_groups(world_size)
    plan = comm.make_grad_comm(job["sizes"], world_size, job["hook"], job["cap"], job["density"],
                               force=True)
    out = {"hosts": np.asarray(hosts), "local": np.asarray(local)}
    res = torch.from_numpy(r.copy()) if plan.needs_residual else None
    vec, res = plan.reduce_hierarchical(torch.from_numpy(g.copy()), res, local_group, host_group)
    out["reduce"] = vec.numpy()
    if res is not None:
        out["residual"] = res.numpy()
        kept = torch.from_numpy(r.copy())
        staged = torch.full_like(kept, 7.0)
        again, _ = plan.reduce_hierarchical(torch.from_numpy(g.copy()), kept, local_group,
                                            host_group, lost=staged)
        out.update(staged=staged.numpy(), kept=kept.numpy(), again=again.numpy())
    np.savez(os.path.join(workdir, f"{job['name']}_{rank}.npz"), **out)


def wrap(workdir, job, rank, world_size):
    try:
        ddp = train_native.build_training(rank, world_size, job["training"], "cpu")[0]
        out = {"meta": ddp.comm_overlap_meta, "hierarchy": ddp.hierarchy,
               "bytes": [ddp.grad_comm_bytes_per_step, ddp.grad_comm_bytes_intra_host,
                         ddp.grad_comm_bytes_inter_host]}
    except Exception as e:  # noqa: BLE001 - the test reads the refusal
        out = {"error": type(e).__name__, "message": str(e)}
    try:  # what a CUDA-graph group would meet on this Gloo world
        graphs.check_capturable()
    except ValueError as e:
        out["capture"] = str(e)
    if rank == 0:
        with open(os.path.join(workdir, f"{job['name']}.json"), "w") as f:
            json.dump(out, f)


def worker(rank, world_size, save_dir, optional_args, workdir):
    torch.set_num_threads(2)
    with open(os.path.join(workdir, "jobs.json")) as f:
        jobs = json.load(f)
    for job in jobs:
        if job["kind"] == "exchange":
            exchange(workdir, job, rank, world_size)
            continue
        if job["kind"] == "wrap":
            wrap(workdir, job, rank, world_size)
            continue
        model, optimizer, train = build(rank, world_size, job["path"], job["training"])
        init = os.path.join(workdir, f"{job['name']}_init.npz")
        if os.path.exists(init):
            with np.load(init) as data:
                model.load_state_dict({k: torch.from_numpy(data[k]) for k in data.files})
        if job["kind"] == "restore":
            ckpt.restore_latest(job["dir"], model, optimizer, comm_state=train.residual())
            save(workdir, job["name"], rank, model, optimizer, residual=train.residual())
            continue
        if job.get("save_dir"):
            os.makedirs(job["save_dir"], exist_ok=True)
        history = train(job.get("save_dir"), bool(job.get("resume")))
        save(workdir, job["name"], rank, model, optimizer, history, train.residual())


if __name__ == "__main__":
    workdir, world = sys.argv[1], int(sys.argv[2])
    run_ddp_training(partial(worker, workdir=workdir), world, workdir, {}, backend="cpu")
