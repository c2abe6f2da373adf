"""The numerical guard of the port on two Gloo processes, for
tests/test_torch_port_guard_gloo.py.

    python tests/_torch_port_guard_worker.py WORKDIR checks
    python tests/_torch_port_guard_worker.py WORKDIR desync native|managed

``checks`` (one launch, world 2): from the weights of
``WORKDIR/init.npz`` (a toy_mlp of hidden width 16 on 8x8x3 inputs) each
rank

- audits the synced replicas, then with rank 1's copy of the parameter of
  JAX index ``perturb`` (``WORKDIR/jobs.json``) moved, and writes the names
  it found to ``audit_{rank}.json``;
- trains the batches of ``WORKDIR/batches.npz`` (``x{i}_{rank}``,
  ``y{i}_{rank}``, this rank's rows of step ``i``; one step poisons rank 1's
  rows only) through a guarded wrap for each case of ``jobs.json``'s
  ``cases`` (``[name, comm_hook, weight_update_sharding]``), writing each
  step's counters and the final state dict to ``{name}_{rank}.json`` and
  ``{name}_{rank}.npz``, and whether the poisoned step left the state
  bitwise as it was.

``desync PATH``: the entry point's worker of PATH (``train_native`` or
``train_accelerate``) on ``WORKDIR/training.json`` with rank 1's parameters
moved after the wrap and ``audit_every_n_epochs: 1``: the audit trips and
the launch exits 77.

Imports only torch, numpy and ``tpuddp_torch``.
"""

from __future__ import annotations

import json
import os
import sys
from functools import partial

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpuddp_torch import optim, train_accelerate, train_native  # noqa: E402
from tpuddp_torch.models import ToyMLP  # noqa: E402
from tpuddp_torch.nn import CrossEntropyLoss  # noqa: E402
from tpuddp_torch.parallel.ddp import DistributedDataParallel  # noqa: E402
from tpuddp_torch.parallel.spawn import run_ddp_training  # noqa: E402
from tpuddp_torch.resilience import guard as guard_lib  # noqa: E402
from tpuddp_torch.training import loop  # noqa: E402


def _model(work):
    model = ToyMLP(192, 10, hidden=(16,))
    init = np.load(os.path.join(work, "init.npz"))
    model.load_state_dict({k: torch.from_numpy(init[k]) for k in init.files})
    return model


def _move(model, index, rank):
    """Rank 1's copy of the JAX-order parameter ``index`` moved by 0.25."""
    if rank == 1:
        with torch.no_grad():
            guard_lib.jax_leaf_names(model)[index][1].view(-1)[0] += 0.25


def _state(ddp):
    out = {k: v.clone() for k, v in ddp.model.state_dict().items()}
    for i, st in enumerate(ddp.optimizer.state.values()):
        out.update({f"opt{i}/{k}": v.clone() for k, v in st.items() if torch.is_tensor(v)})
    if ddp.residual is not None:
        out["residual"] = ddp.residual.clone()
    return out


def checks(rank, world_size, work, _optional_args):
    torch.set_num_threads(2)
    with open(os.path.join(work, "jobs.json")) as f:
        jobs = json.load(f)
    model = _model(work)
    found = [guard_lib.audit_params(model)]
    _move(model, jobs["perturb"], rank)
    found.append(guard_lib.audit_params(model))
    with open(os.path.join(work, f"audit_{rank}.json"), "w") as f:
        json.dump(found, f)

    batches = np.load(os.path.join(work, "batches.npz"))
    steps = sum(1 for k in batches.files if k.startswith("x") and k.endswith(f"_{rank}"))
    for name, hook, zero1 in jobs["cases"]:
        model = _model(work)
        ddp = DistributedDataParallel(
            model, optim.Adam(model.parameters(), lr=1e-2), CrossEntropyLoss(), device="cpu",
            comm_hook=hook, weight_update_sharding=zero1, guard=True)
        counters, noop = [], []
        for i in range(steps):
            before = _state(ddp)
            x, y = batches[f"x{i}_{rank}"], batches[f"y{i}_{rank}"]
            ddp.train_step((x, y, np.ones(len(y), np.float32)))
            counters.append(ddp.skip_counters())
            after = _state(ddp)
            noop.append(all(torch.equal(before[k], after[k]) for k in before))
        with open(os.path.join(work, f"{name}_{rank}.json"), "w") as f:
            json.dump({"counters": counters, "noop": noop}, f)
        np.savez(os.path.join(work, f"{name}_{rank}.npz"),
                 **{k: v.numpy() for k, v in ddp.model.state_dict().items()})


def desync(rank, world_size, work, optional_args, path):
    torch.set_num_threads(2)
    with open(os.path.join(work, "training.json")) as f:
        training = json.load(f)
    if path == "native":
        ddp, train_loader, test_loader, seed = train_native.build_training(
            rank, world_size, training, "cpu")
        _move(ddp.model, 0, rank)
        loop.run_training_loop(ddp, train_loader, test_loader, work,
                               num_epochs=training["num_epochs"], log=lambda *_: None)
        return
    acc, model, opt, train_loader, test_loader, criterion, eval_transform = (
        train_accelerate.build_training(training, "cpu"))
    _move(model.module, 0, rank)
    train_accelerate.run_training_loop(
        model, train_loader, test_loader, criterion, opt, work, acc, eval_transform,
        num_epochs=training["num_epochs"])


if __name__ == "__main__":
    work, kind = sys.argv[1], sys.argv[2]
    fn = checks if kind == "checks" else partial(desync, path=sys.argv[3])
    run_ddp_training(fn, 2, work, {}, backend="cpu")
