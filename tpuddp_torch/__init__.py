"""tpuddp_torch — the PyTorch / CUDA port of tpuddp's native DDP trainer.

A standalone package beside the JAX package ``tpuddp``: it imports ``torch``
and never ``jax`` or ``tpuddp``. Module names mirror the JAX package so each
counterpart is easy to find (``tpuddp_torch/optim.py`` <-> ``tpuddp/optim.py``).

Entry point: ``python -m tpuddp_torch.train_native --settings_file F``. It
runs on ``cuda`` unless the settings ask for ``local.device: cpu``.
"""

# the run_meta header's tpuddp_version (observability/schema.py)
__version__ = "0.1.0"
