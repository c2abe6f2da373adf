"""Replica pool — the counterpart of ``tpuddp/serving/replica.py``: N
independent model replicas, each a whole copy of the model on one device
with a dispatch loop of its own.

Each replica holds its own copy of the parameters on its device and runs
its forward on a CUDA stream of its own, so replicas on distinct cards (or
on one card, ``devices=[cuda:0, cuda:0]``) serve concurrently with no
coordination between them. The forward is the eval-mode one, under
``torch.inference_mode()``, with TF32 off and cuDNN's deterministic
algorithms (:func:`set_numerics`): rows are independent, so a request's
served logits are bitwise those of a direct forward over the same padded
batch on the same device. Across buckets nothing is claimed.

Weights come from a fresh seeded init or through the integrity path of
:mod:`tpuddp_torch.training.checkpoint` (:func:`_restore_variables`): native
``ckpt_{e}.npz`` and managed ``state_{e}.npz`` files, written by either
package, sha256-verified, corrupt files skipped newest-first. Only the
parameters and buffers are read; the optimizer state stays on disk.
"""

from __future__ import annotations

import contextlib
import copy
import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpuddp_torch import seeding
from tpuddp_torch.models import load_model
from tpuddp_torch.training import checkpoint as ckpt

logger = logging.getLogger("tpuddp")


def serving_devices(kind: str = "cuda", indices: Optional[Sequence[int]] = None) -> List[torch.device]:
    """The devices ``local.device`` gives the engines: every visible card
    for ``cuda`` (``num_replicas: auto`` takes them all), the one host for
    ``cpu``. ``indices`` (``local.gpu.serving_devices``) names the cards in
    order instead, an index repeated to put several replicas on one card
    (``[0, 0]``: two replicas on ``cuda:0``; on the CPU, as many replicas
    on the host). ``cuda`` without a card raises: the engines never serve on
    the CPU in its place."""
    if kind == "cpu":
        return [torch.device("cpu")] * (len(indices) if indices else 1)
    if kind != "cuda":
        raise ValueError(f"unsupported device kind {kind!r} (expected cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "local.device is cuda but torch.cuda.is_available() is False; the serving "
            "engines do not fall back to the CPU (set local.device: cpu to serve there)"
        )
    count = torch.cuda.device_count()
    if indices is None:
        return [torch.device("cuda", i) for i in range(count)]
    bad = [i for i in indices if not 0 <= int(i) < count]
    if bad or not indices:
        raise ValueError(f"local.gpu.serving_devices {list(indices)} must name cards 0..{count - 1}")
    return [torch.device("cuda", int(i)) for i in indices]


def set_numerics() -> None:
    """TF32 off and cuDNN's deterministic algorithms, as the training entry
    points set them: a served forward then repeats bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def seeded_model(name: str, num_classes: int, input_shape: Sequence[int], seed: int):
    """``name``'s fresh init on the host, drawn from a ``torch.Generator``
    seeded with ``seed`` (torch's global stream is left as it was)."""
    with seeding.fork_from(torch.Generator().manual_seed(int(seed))):
        return load_model(name, num_classes, input_shape=tuple(input_shape))


def _restore_variables(save_dir: str, prefix: str, model: torch.nn.Module) -> int:
    """Restore ``model``'s parameters and buffers in place from the newest
    intact checkpoint in ``save_dir`` and return its epoch
    (``tpuddp/serving/replica.py:65-95``). ``prefix="auto"`` takes whichever
    family ("ckpt" native, "state" managed) has the newest intact file.
    Nothing intact is the JAX package's ``FileNotFoundError``: serving
    random weights because a directory was empty would be silent. A file
    written at another tensor-parallel width is the loader's
    ``TopologyMismatch``, as in the JAX package."""
    prefixes = ("ckpt", "state") if prefix == "auto" else (prefix,)
    found = []
    for p in prefixes:
        hit = ckpt.latest(save_dir, prefix=p)
        if hit is not None:
            found.append((hit[1], p, hit[0]))
    if not found:
        raise FileNotFoundError(
            f"no intact checkpoint with prefix(es) {prefixes} in {save_dir!r}"
        )
    epoch, pfx, path = max(found)
    with torch.random.fork_rng(devices=[]):  # a port file's saved streams stay out of the server
        ckpt.load(path, model, layout=ckpt.NATIVE if pfx == "ckpt" else ckpt.MANAGED)
    logger.info("serving: restored %s (epoch %d)", path, epoch)
    return epoch


def pick_devices(devices: Sequence, n) -> list:
    """The first ``n`` of ``devices`` (``"auto"``: all), with the JAX
    package's ``ValueError`` past the count."""
    devices = list(devices)
    if n == "auto":
        return devices
    n = int(n)
    if n < 1:
        raise ValueError(f"num_replicas must be >= 1, got {n}")
    if n > len(devices):
        raise ValueError(f"num_replicas={n} exceeds the {len(devices)} available local devices")
    return devices[:n]


class Replica:
    """One device's copy of the model and the stream its forwards run on.

    Survivability state (:mod:`tpuddp_torch.serving.survive`): ``state`` is
    ``healthy`` (routed to), ``recovering`` (in probation) or ``removed``;
    ``recoveries`` counts lifetime rejoins; ``broken`` is an injected
    ``replica_kill``: every dispatch raises until :meth:`rebuild`."""

    def __init__(self, index: int, device, master: torch.nn.Module):
        self.index = index
        self.device = torch.device(device)
        self._master = master
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.model = self._copy()
        self.dispatches = 0
        self.state = "healthy"
        self.consecutive_errors = 0
        self.recoveries = 0
        self.broken = False
        # True while this replica's dispatch-loop thread runs: the survivor
        # check must not hand work to a peer whose loop already exited
        self.loop_alive = False

    @property
    def healthy(self) -> bool:
        return self.state == "healthy"

    def _copy(self) -> torch.nn.Module:
        with self._on_stream():  # made on the stream that uses it
            model = copy.deepcopy(self._master).to(self.device).eval()
        model.requires_grad_(False)
        return model

    def _on_stream(self):
        return torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()

    def infer(self, x: np.ndarray) -> np.ndarray:
        """One padded batch's logits, fetched to the host (the fetch is the
        fence)."""
        if self.broken:
            raise RuntimeError(f"replica {self.index} is down (injected replica_kill)")
        self.dispatches += 1
        with self._on_stream(), torch.inference_mode():
            out = self.model(torch.from_numpy(x).to(self.device))
            return out.float().cpu().numpy()

    def warmup(self, buckets, sample_shape, dtype=np.float32) -> None:
        """Run every bucket's shape once now (cuDNN's and cuBLAS's first
        call of a shape), so no request pays it."""
        for b in buckets:
            self.infer(np.zeros((b,) + tuple(sample_shape), dtype))
        self.dispatches = 0

    def rebuild(self) -> None:
        """Probation step 1: a fresh copy of the parameters on the device;
        clears an injected ``replica_kill``."""
        self.model = self._copy()
        self.broken = False

    def canary(self, sample_shape, dtype=np.float32) -> None:
        """Probation step 2: one smallest-bucket dispatch with finite logits,
        or the replica does not rejoin routing."""
        out = self.infer(np.zeros((1,) + tuple(sample_shape), dtype))
        if not np.all(np.isfinite(out)):
            raise RuntimeError(f"replica {self.index} canary produced non-finite logits")


class ReplicaPool:
    """The model replicas a :class:`~tpuddp_torch.serving.engine.
    ServingEngine` dispatches onto; ``model`` is the host master copy."""

    def __init__(self, model: torch.nn.Module, devices: List, sample_shape: Tuple[int, ...],
                 restored_epoch: Optional[int] = None):
        set_numerics()
        self.model = model.eval()
        self.sample_shape = tuple(int(d) for d in sample_shape)
        self.restored_epoch = restored_epoch
        self.replicas = [Replica(i, d, self.model) for i, d in enumerate(devices)]

    def __len__(self) -> int:
        return len(self.replicas)

    @property
    def devices(self):
        return [r.device for r in self.replicas]

    def warmup(self, buckets) -> None:
        for r in self.replicas:
            r.warmup(buckets, self.sample_shape)

    @classmethod
    def from_config(cls, cfg: dict, devices=None) -> "ReplicaPool":
        """The pool of a resolved ``serving`` block
        (:func:`tpuddp_torch.config.serving_config`): the zoo model, its
        seeded init, then the checkpoint over it when one is named.
        ``devices`` defaults to every visible card."""
        sample_shape = tuple(int(d) for d in cfg["input_shape"])
        model = seeded_model(cfg["model"], int(cfg["num_classes"]), sample_shape,
                             int(cfg.get("seed") or 0))
        restored_epoch = None
        if cfg.get("checkpoint_dir"):
            restored_epoch = _restore_variables(
                cfg["checkpoint_dir"], str(cfg.get("checkpoint_prefix") or "auto"), model)
        if devices is None:
            devices = serving_devices("cuda")
        devices = pick_devices(devices, cfg.get("num_replicas", "auto"))
        return cls(model, devices, sample_shape, restored_epoch)
