"""torch-rule Adam with float32 moments — the counterpart of
``tpuddp/optim.py``'s ``Adam`` (lines 133-225).

Each param group's update is one call of
:func:`tpuddp_torch.ops.fused_adam.adam_update`: one CUDA kernel launch for
all of the group's CUDA parameters (up to 48 leaves; more take one launch per
48), the plain PyTorch version for CPU ones. ``weight_decay`` is the
torch L2 convention (added to the gradient), as in the JAX package.

The JAX optimizer is a pure function returning new arrays and one shared step
counter; this one keeps ``step``, ``exp_avg`` (m) and ``exp_avg_sq`` (v) per
parameter, as ``torch.optim.Adam`` does, and updates them and the parameter
in place.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpuddp_torch.ops.fused_adam import adam_update, bias_corrections


class Adam(torch.optim.Optimizer):
    def __init__(
        self,
        params,
        lr: float = 1e-3,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
    ):
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            # the group's leaves that have a gradient, each with the bias
            # corrections of its own step count, in one adam_update call
            ps, gs, ms, vs, bc1s, bc2s = [], [], [], [], [], []
            corrections = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(
                        p, dtype=torch.float32, memory_format=torch.contiguous_format
                    )
                    state["exp_avg_sq"] = torch.zeros_like(state["exp_avg"])
                state["step"] += 1
                step = state["step"]
                if step not in corrections:
                    corrections[step] = bias_corrections(step, group["betas"])
                bc1, bc2 = corrections[step]
                ps.append(p)
                gs.append(p.grad)
                ms.append(state["exp_avg"])
                vs.append(state["exp_avg_sq"])
                bc1s.append(bc1)
                bc2s.append(bc2)
            adam_update(
                ps, gs, ms, vs, lr=group["lr"], betas=group["betas"], eps=group["eps"],
                weight_decay=group["weight_decay"], bc1s=bc1s, bc2s=bc2s,
            )
        return loss
