"""Accelerator — the managed path of the port, the counterpart of
``tpuddp/accelerate.py`` (52-181, 521-845 without the fused-scan program,
925-1186 and 1299-1810) and of the HuggingFace ``Accelerator`` surface the
reference's ``multi-GPU-training-accelerate.py`` uses.

The training sequence is the torch one::

    outputs = model(inputs)                    # LazyForward: runs nothing yet
    loss = criterion(outputs, labels, weights) # LazyLoss: binds the weights
    accelerator.backward(loss)                 # forward + backward + sync
    optimizer.step()                           # the optimizer (Adam: its kernel)

The forward waits for the criterion because a train-mode forward must leave
padded rows (``w = 0``) out of the BatchNorm statistics, and ``w`` is only
known when the criterion is applied (``tpuddp/accelerate.py:651-716``). It
runs at ``accelerator.backward(loss)`` (train mode, with the accelerator's
``augment`` first), at ``loss.item()`` or at ``outputs.argmax()`` (forward
only, e.g. in eval loops, which pass already-transformed inputs).

The managed step computes the gradient of the GLOBAL batch's weighted-mean
loss, as the JAX step evaluates the criterion over the whole sharded batch:
each process scales its local weighted-mean loss by its share
``n_r / sum(n)`` of the real rows (one all-reduce of ``n``) before backward,
and one all-reduce SUM of the gradients (with the loss riding along) gives
``sum_r n_r g_r / sum_r n_r`` and the global loss on every process. On a
ragged batch this differs from the native path's mean of per-replica means.
BatchNorm statistics are the global batch's too (``prepare`` makes every
BatchNorm sync). At world 1 the collectives are the identity and the scale
is exactly 1, so a step is the native step.

Gradient accumulation (``gradient_accumulation_steps = A``) is the JAX
managed rule, which differs from the native one on purpose: ``step()`` adds
each micro-batch's global-mean gradient to a sum and every A-th applies ONE
update from the UNWEIGHTED mean ``sum / A``; ``flush_accumulation()`` applies
a partial cycle with ``1 / count`` (``tpuddp/accelerate.py:1092-1140``).

``clip_grad_norm`` clips the update's gradient (after the loss-scaled
all-reduce and, under accumulation, after the cycle's average) to that global
L2 norm, once per update and never per micro-batch
(``tpuddp/accelerate.py:1143-1165``).

Besides its torch generator the accelerator keeps the JAX ``Accelerator``'s
key stream (:class:`~tpuddp_torch.seeding.JaxKeyStream`) and draws from it
wherever the JAX one draws: ``bwd_key`` and the model's init key at
``prepare``, one key per forward-only train-mode read and per
``next_rng_key()``. ``save_state`` writes the stream (``rng_key``) and
``bwd_key`` as the JAX package would at that point; ``load_state`` puts
them back.

Call-order contracts (``tests/test_accelerate.py``): ``step()`` without a
``backward()`` raises; a second ``backward()`` before ``step()`` drops the
first loss (reading it then raises), or raises under accumulation;
``zero_grad()`` drops a staged step and is otherwise a no-op.

Batches may arrive already on the device (the entry point stages them,
``training/pipeline.py``); a host array is copied from pinned memory without
blocking. ``save_model``/``load_model`` and ``save_state``/``load_state``
write and read the JAX package's ``model.npz`` and ``state_{epoch}.npz``
(``training/checkpoint.py``).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from tpuddp_torch import config as cfg_lib
from tpuddp_torch import seeding
from tpuddp_torch.data.loader import DataLoader, ShardedDataLoader
from tpuddp_torch.nn.norm import BatchNorm, batch_weights, convert_sync_batchnorm
from tpuddp_torch.optim import clip_grad_norm_
from tpuddp_torch.parallel import backend, collectives
from tpuddp_torch.training import checkpoint as ckpt
from tpuddp_torch.training.pipeline import to_device


class LazyForward:
    """A deferred ``model(x)``; the forward runs when its value is needed."""

    def __init__(self, model: "PreparedModel", x):
        self._model = model
        self._x = x
        self._logits = None
        self._weights = None  # bound by a criterion

    def _tpuddp_bind_loss(self, criterion, labels, weights=None) -> "LazyLoss":
        self._weights = weights
        return LazyLoss(self, criterion, labels, weights)

    @property
    def value(self) -> torch.Tensor:
        """The logits (this process's rows)."""
        if self._logits is None:
            self._logits = self._model._forward_only(self._x, self._weights)
        return self._logits

    def argmax(self, dim: int = -1) -> torch.Tensor:
        return self.value.argmax(dim=dim)

    def __array__(self, dtype=None):
        arr = self.value.detach().float().cpu().numpy()
        return arr if dtype is None else arr.astype(dtype)


class LazyLoss:
    """A deferred ``criterion(outputs, labels, weights)``. After
    ``accelerator.backward`` it holds the global batch's loss, the same on
    every process; read without a backward it is this process's forward-only
    loss."""

    def __init__(self, fwd: LazyForward, criterion: Callable, labels, weights):
        self._fwd = fwd
        self._criterion = criterion
        self._labels = labels
        self._weights = weights
        self._value: Optional[torch.Tensor] = None
        self._read = False
        self._dropped = None  # why the staged step was dropped, once it is

    def _drop(self, reason: str) -> None:
        """The staged step this loss belongs to was dropped before
        ``step()``; a value never read must not be read later."""
        if not self._read:
            self._dropped = reason

    def device_value(self) -> torch.Tensor:
        """The loss as a device scalar, with no host read."""
        if self._dropped is not None:
            raise RuntimeError(
                f"this loss's backward request was dropped before optimizer.step() "
                f"({self._dropped}); its value must not be read"
            )
        if self._value is None:  # forward only, e.g. in an eval loop
            model = self._fwd._model
            self._value = self._criterion(
                self._fwd.value, model.to_device(self._labels, torch.int64),
                None if self._weights is None else model.to_device(self._weights, torch.float32),
            ).detach()
        self._read = True
        return self._value

    def item(self) -> float:
        return float(self.device_value())


def sum_losses(losses) -> torch.Tensor:
    """The device sum of many losses' values (one stack and one sum, no host
    read); ``float()`` it for the one read of an epoch."""
    values = [l.device_value().reshape(()) for l in losses]
    return torch.stack(values).sum() if values else torch.zeros(())


class PreparedModel:
    """The managed model: ``model(x)`` returns a :class:`LazyForward`;
    ``train()``/``eval()`` switch the module's mode. ``module`` is the
    unwrapped ``nn.Module``, on the accelerator's device, every BatchNorm
    synced, with process 0's parameters and buffers."""

    def __init__(self, accelerator: "Accelerator", module: torch.nn.Module):
        self.accelerator = accelerator
        self.device = accelerator.device
        self.module = convert_sync_batchnorm(module.to(self.device))
        collectives.broadcast_one_to_all(self.module)
        self._staged: Optional[LazyLoss] = None  # backward done, step() not yet
        self._optimizer: Optional["PreparedOptimizer"] = None  # bound by prepare
        self._bwd_counter = 0  # backward passes run, saved as ['bwd_counter']
        # the JAX model's draws: its backward base key here, its init key at
        # its first forward (tpuddp/accelerate.py:544, :605)
        self._bwd_key = accelerator.jax_keys.draw()
        accelerator.jax_keys.draw()

    def train(self, mode: bool = True) -> "PreparedModel":
        self.module.train(mode)
        return self

    def eval(self) -> "PreparedModel":
        return self.train(False)

    def parameters(self):
        return self.module.parameters()

    def __call__(self, x) -> LazyForward:
        return LazyForward(self, x)

    def to_device(self, a, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """A host array or a tensor on the device (``dtype`` if given); a
        tensor already there passes as it is."""
        return to_device(a, self.device, dtype)

    def _params(self):
        return [p for p in self.module.parameters() if p.requires_grad]

    @torch.no_grad()
    def _forward_only(self, x, w) -> torch.Tensor:
        x = self.to_device(x)
        if not self.module.training:
            return self.module(x)
        self.accelerator.jax_keys.draw()  # the JAX forward's dropout key
        # train mode without a backward: the JAX package computes it over
        # the batch it is given and discards the new buffers; so does this,
        # with the BatchNorms unsynced (no collective on one process's read)
        aug = self.accelerator.augment
        norms = [m for m in self.module.modules() if isinstance(m, BatchNorm)]
        syncs = [m.sync for m in norms]
        saved = [b.clone() for b in self.module.buffers()]
        try:
            for m in norms:
                m.sync = False
            with batch_weights(self.module, None if w is None else self.to_device(w, torch.float32)):
                return self.module(aug(x) if aug is not None else x)
        finally:
            for m, s in zip(norms, syncs):
                m.sync = s
            for b, s in zip(self.module.buffers(), saved):
                b.copy_(s)

    def _backward(self, loss: LazyLoss) -> None:
        """Forward and backward of the global batch's loss for ``loss``'s
        batch; the global-mean gradient lands in each parameter's ``.grad``
        and waits there for ``step()``."""
        if self._staged is not None:
            if self.accelerator.gradient_accumulation_steps > 1:
                raise RuntimeError(
                    "gradient accumulation requires optimizer.step() after EACH "
                    "accelerator.backward(): a second backward here would drop the "
                    "previous micro-batch's gradient"
                )
            self._staged._drop("a second accelerator.backward() preceded optimizer.step()")
        fwd = loss._fwd
        x = self.to_device(fwd._x)
        y = self.to_device(loss._labels, torch.int64)
        w = (torch.ones(y.shape[0], device=self.device) if loss._weights is None
             else self.to_device(loss._weights, torch.float32))
        was_training = self.module.training
        self.module.train()
        try:
            if self.accelerator.augment is not None:
                x = self.accelerator.augment(x)
            with batch_weights(self.module, w):
                logits = self.module(x)
        finally:
            self.module.train(was_training)
        n = w.sum()
        total = n.clone()
        collectives.all_reduce_sum_([total])
        share = n / torch.where(total == 0, torch.ones_like(total), total)
        scaled = loss._criterion(logits, y, w) * share
        params = self._params()
        for p in params:
            p.grad = None
        scaled.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        value = scaled.detach().reshape(1)
        collectives.all_reduce_sum_([p.grad for p in params] + [value])
        loss._value = value.reshape(())
        fwd._logits = logits.detach()
        self._staged = loss
        self._bwd_counter += 1


class PreparedOptimizer:
    """Wraps the optimizer: ``step()`` applies the gradient that the last
    ``accelerator.backward`` left (clipped, with ``clip_grad_norm``; one
    Adam-kernel launch per Adam update on a CUDA model), or under
    accumulation adds it to the cycle's sum."""

    def __init__(self, optimizer: torch.optim.Optimizer, model: PreparedModel):
        self.optimizer = optimizer
        self.model = model
        self._accum = None  # the cycle's gradient sum, one tensor per parameter
        self._accum_count = 0
        self.updates = 0

    def zero_grad(self) -> None:
        """Drops a staged step; otherwise nothing (the managed no-op)."""
        staged = self.model._staged
        if staged is not None:
            staged._drop("zero_grad() preceded optimizer.step()")
            for p in self.model._params():
                p.grad = None
        self.model._staged = None

    def step(self) -> None:
        if self.model._staged is None:
            raise RuntimeError(
                "optimizer.step() called without a preceding accelerator.backward(loss)"
            )
        self.model._staged = None
        params = self.model._params()
        if self.model.accelerator.gradient_accumulation_steps == 1:
            self._apply()
            return
        grads = [p.grad for p in params]
        for p in params:
            p.grad = None
        if self._accum is None:
            self._accum = grads
        else:
            self._accum = [a + g for a, g in zip(self._accum, grads)]
        self._accum_count += 1
        if self._accum_count >= self.model.accelerator.gradient_accumulation_steps:
            self.flush_accumulation()

    def flush_accumulation(self) -> None:
        """Apply a partial cycle now, averaged over the micro-batches it
        holds (the dataloader-end rule of HF's ``accumulate()``); nothing
        when no cycle is open. The entry point calls it at every epoch end."""
        if self._accum_count == 0:
            return
        scale = 1.0 / self._accum_count
        for p, a in zip(self.model._params(), self._accum):
            p.grad = a * scale
        self._accum, self._accum_count = None, 0
        self._apply()

    def _apply(self) -> None:
        clip = self.model.accelerator.clip_grad_norm
        if clip is not None:
            clip_grad_norm_(self.model._params(), clip)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.updates += 1


class Accelerator:
    """The managed entry: topology from the process group, a per-process
    random stream, and the verbs of the reference's Accelerator.

    ``device``: ``cuda`` (the default, ``cuda:<process index>``; raises
    without a GPU) or ``cpu``. ``augment``: the train-time transform
    ``x -> x`` (flip, normalize, resize) that runs inside every backward's
    forward; build it with ``generator=accelerator.generator`` so its flip
    masks draw from the process's stream. ``fuse_steps``: 1, or ``auto``
    under accumulation (:func:`tpuddp_torch.config.resolve_fuse_steps`).
    ``clip_grad_norm``: the global L2 norm each update's gradient is clipped
    to (None: no clip)."""

    def __init__(
        self,
        seed: Optional[int] = None,
        fuse_steps=1,
        gradient_accumulation_steps: int = 1,
        augment: Optional[Callable] = None,
        device: str = "cuda",
        clip_grad_norm: Optional[float] = None,
    ):
        self.gradient_accumulation_steps = max(1, int(gradient_accumulation_steps))
        self.clip_grad_norm = None if clip_grad_norm is None else float(clip_grad_norm)
        self.fuse_steps = cfg_lib.resolve_fuse_steps(fuse_steps, self.gradient_accumulation_steps)
        self.process_index = backend.get_rank()
        self.num_processes = backend.get_world_size()
        if device == "cuda":
            if not torch.cuda.is_available():
                raise backend.BackendUnavailableError(
                    "Accelerator on cuda but no GPU is visible; pass device='cpu' "
                    "to run on the CPU"
                )
            self.device = torch.device("cuda", self.process_index)
        else:
            self.device = torch.device(device)
        self.generator, self.seed = seeding.set_seed_based_on_rank(self.process_index, seed)
        self.jax_keys = seeding.JaxKeyStream(self.seed, self.process_index)
        self.augment = augment

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    @property
    def is_local_main_process(self) -> bool:
        return self.process_index == 0

    def next_rng_key(self) -> torch.Generator:
        """A fresh generator split from the process's stream (and a draw
        from the JAX key stream, as the JAX call makes)."""
        self.jax_keys.draw()
        return seeding.split(self.generator)

    def prepare(self, *objects):
        """Wrap modules as :class:`PreparedModel`, optimizers as
        :class:`PreparedOptimizer` bound to the model of the same call, and
        re-create each :class:`DataLoader` as this process's
        :class:`ShardedDataLoader` (batch size per process, HF semantics).
        A loader left out keeps its full stream (the reference's test
        loader)."""
        out, model = [], None
        for obj in objects:
            if isinstance(obj, torch.nn.Module):
                model = PreparedModel(self, obj)
                out.append(model)
            elif isinstance(obj, PreparedModel):
                model = obj
                out.append(obj)
            elif isinstance(obj, torch.optim.Optimizer):
                out.append(obj)
            elif isinstance(obj, DataLoader):
                out.append(ShardedDataLoader(
                    obj.dataset, obj.batch_size, self.process_index, self.num_processes,
                    shuffle=obj.shuffle, seed=obj.seed,
                ))
            elif isinstance(obj, ShardedDataLoader):
                out.append(obj)
            else:
                raise TypeError(f"cannot prepare object of type {type(obj)!r}")
        for i, obj in enumerate(out):
            if isinstance(obj, torch.optim.Optimizer):
                if model is None:
                    raise ValueError("prepare() got an optimizer but no model")
                out[i] = model._optimizer = PreparedOptimizer(obj, model)
        return out[0] if len(out) == 1 else tuple(out)

    def backward(self, loss: LazyLoss) -> None:
        """Forward, backward and gradient sync of ``loss``'s batch (the
        reference's ``accelerator.backward(loss)``)."""
        if not isinstance(loss, LazyLoss):
            raise TypeError(
                "accelerator.backward expects the LazyLoss of a criterion applied to "
                "a prepared model's outputs"
            )
        loss._fwd._model._backward(loss)

    def wait_for_everyone(self) -> None:
        collectives.barrier()

    def gather(self, x) -> torch.Tensor:
        """Every process's ``x`` concatenated along axis 0, on every
        process."""
        t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        return collectives.process_allgather(t)

    def print(self, *args, **kwargs) -> None:
        if self.is_local_main_process:
            print(*args, **kwargs)

    def save_model(self, model: PreparedModel, save_dir: str):
        """Process 0 writes ``save_dir/model.npz`` (the unwrapped module's
        parameters and buffers in the JAX layout); everyone waits at a
        barrier."""
        return ckpt.save_model_on_main(save_dir, model.module, self.process_index)

    @staticmethod
    def _discard_staged_work(model: PreparedModel, reason: str) -> None:
        """Drop what was staged against the weights about to be replaced: a
        backward waiting for ``step()`` and a partial accumulation cycle."""
        if model._staged is not None:
            model._staged._drop(reason)
            model._staged = None
        opt = model._optimizer
        if opt is not None:
            opt._accum, opt._accum_count = None, 0

    def load_model(self, model: PreparedModel, save_dir: str) -> PreparedModel:
        """Restore the weights of ``save_dir/model.npz``; the optimizer's
        state starts again from zero, as ``tpuddp/accelerate.py:1599-1607``
        resets it (moments of other weights must not steer these)."""
        self._discard_staged_work(model, "load_model discarded the staged step")
        ckpt.load(os.path.join(save_dir, "model.npz"), model.module, layout=ckpt.MANAGED)
        if model._optimizer is not None:
            model._optimizer.optimizer.state.clear()
        return model

    def save_state(self, model: PreparedModel, optimizer: PreparedOptimizer,
                   save_dir: str, epoch: int = 0, keep_last: Optional[int] = None):
        """Process 0 writes ``save_dir/state_{epoch}.npz``: parameters,
        buffers, the optimizer's state, the JAX keys and every process's
        random streams; with ``keep_last`` the older state files are pruned.
        A partial accumulation cycle is refused: it would be lost."""
        if optimizer._accum_count:
            raise RuntimeError(
                "save_state mid-gradient-accumulation-cycle would silently lose the "
                "partial cycle; call optimizer.flush_accumulation() first (the entry "
                "point's epoch boundary does)"
            )
        return ckpt.save_on_main(
            save_dir, epoch, model.module, optimizer.optimizer, self.process_index,
            layout=ckpt.MANAGED, seed=self.seed, generator=self.generator,
            world_size=self.num_processes, keep_last=keep_last, counter=model._bwd_counter,
            keys=(self.jax_keys.key, model._bwd_key),
        )

    def load_state(self, model: PreparedModel, optimizer: PreparedOptimizer,
                   save_dir: str) -> int:
        """Restore the newest intact ``state_{epoch}.npz`` in ``save_dir``;
        returns the epoch to train next (0 when there is none)."""
        self._discard_staged_work(model, "load_state discarded the staged step")
        next_epoch, meta = ckpt.restore_latest(
            save_dir, model.module, optimizer.optimizer, layout=ckpt.MANAGED,
            generator=self.generator,
        )
        model._bwd_counter = meta.get("bwd_counter", model._bwd_counter)
        if "rng_key" in meta:
            self.jax_keys.key, model._bwd_key = meta["rng_key"], meta["bwd_key"]
        return next_epoch
