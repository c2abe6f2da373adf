"""torch-rule Adam with float32 or bfloat16 moments — the counterpart of
``tpuddp/optim.py``'s ``Adam`` (lines 133-225).

Each param group's update is one call of
:func:`tpuddp_torch.ops.fused_adam.adam_update`: one CUDA kernel launch for
all of the group's CUDA parameters (up to 48 leaves; more take one launch per
48), the plain PyTorch version for CPU ones. ``weight_decay`` is the
torch L2 convention (added to the gradient), as in the JAX package.

``state_dtype`` (``training.optimizer_state_dtype``) stores m and v in
bfloat16: the update still runs in float32, ``p`` comes from the unrounded
moments, and the moments are stored with the JAX package's Weyl-sequence
stochastic rounding, keyed by each parameter's step count and its index in
the JAX package's flattened parameter tree (``leaf_index``;
:func:`tpuddp_torch.models.convert.jax_leaf_index` gives it for the port's
models).

The JAX optimizer is a pure function returning new arrays and one shared step
counter; this one keeps ``step``, ``exp_avg`` (m) and ``exp_avg_sq`` (v) per
parameter, as ``torch.optim.Adam`` does, and updates them and the parameter
in place.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from tpuddp_torch.ops.fused_adam import adam_update, bias_corrections

# tpuddp/optim.py:162-181: these two have a correct storage path; any other
# low-precision type would freeze Adam's v (its sub-ulp decrements vanish)
_STATE_DTYPES = {
    None: torch.float32, "float32": torch.float32, "f32": torch.float32,
    "fp32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    torch.float32: torch.float32, torch.bfloat16: torch.bfloat16,
}


def state_dtype_from(name) -> torch.dtype:
    """The moments' dtype for ``optimizer_state_dtype``: None and float32
    (``f32``, ``fp32``) give float32, ``bfloat16`` (``bf16``) bfloat16;
    anything else is a ``ValueError``."""
    try:
        return _STATE_DTYPES[name]
    except (KeyError, TypeError):
        raise ValueError(
            f"unsupported state_dtype {name!r} (training.optimizer_state_dtype); "
            "use bfloat16 or float32"
        ) from None


class Adam(torch.optim.Optimizer):
    def __init__(
        self,
        params,
        lr: float = 1e-3,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        state_dtype=None,
        leaf_index: Optional[Sequence[int]] = None,
    ):
        self.state_dtype = state_dtype_from(state_dtype)
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay)
        super().__init__(params, defaults)
        flat = [p for group in self.param_groups for p in group["params"]]
        # each parameter's index in the JAX package's flattened parameter
        # tree, which salts its bf16 rounding; float32 moments need none
        if leaf_index is None:
            if self.state_dtype == torch.bfloat16:
                raise ValueError(
                    "bf16 moments need leaf_index, each parameter's index in the "
                    "JAX package's flattened parameter tree "
                    "(tpuddp_torch.models.convert.jax_leaf_index)"
                )
            leaf_index = [None] * len(flat)
        leaf_index = list(leaf_index)
        if len(leaf_index) != len(flat):
            raise ValueError(
                f"leaf_index has {len(leaf_index)} entries for {len(flat)} parameters"
            )
        self.leaf_index = dict(zip(flat, leaf_index))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            # the group's leaves that have a gradient, each with the bias
            # corrections of its own step count, in one adam_update call
            ps, gs, ms, vs, bc1s, bc2s, steps, leaves = [], [], [], [], [], [], [], []
            corrections = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(
                        p, dtype=self.state_dtype, memory_format=torch.contiguous_format
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
                steps.append(step)
                leaves.append(self.leaf_index[p])
            adam_update(
                ps, gs, ms, vs, lr=group["lr"], betas=group["betas"], eps=group["eps"],
                weight_decay=group["weight_decay"], bc1s=bc1s, bc2s=bc2s,
                steps=steps, leaves=leaves,
            )
        return loss
